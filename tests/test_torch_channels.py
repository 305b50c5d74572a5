"""The port's conv kernels' plain versions, the fused chain and the mask
network at other channel counts than 64, against the JAX package.

The JAX package sends a layer to its Pallas conv at 64 channels or more, in
and out apart (`conv_pallas.conv_dispatch`), and takes its fused chain at
any C with ``2·C % 128 == 0`` (`MaskNet._use_fused_chain`); the port's
kernels take the same widths.  On the CPU the port's wrappers run their
plain versions and the JAX side runs its Pallas kernels in interpret mode,
called as `tests/test_torch_conv_cuda.py` and `tests/test_torch_conv_fused.py`
call them: the dilated conv at 96 → 96, 128 → 128 and 64 → 128, the chain's
three kernels, `make_chain`, and `MaskNet` and one train step at
``conv_channels`` = 128 with each switch.  Small T and F keep interpret mode
cheap; the card holds each kernel to these plain versions at the path's
shapes (`chip_smoke.py --phases channels`, `tests/test_torch_gpu.py`).

Tolerances, relative to each output's peak: 1e-4 for fp32 values (the same
products summed in another order: the fold splits each sum over parity
slots), 5e-4 for gradients through the chain, as in
`tests/test_torch_conv_fused.py`.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import voicesplit_tpu.ops.conv_fused as jcf
import voicesplit_tpu.ops.conv_pallas as jcp
from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.models.masknet import MaskNet as JaxMaskNet
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.ops.conv_fold import FOLD, fold_input, fold_kernel, unfold_output
from voicesplit_tpu.train import state as jax_state
from voicesplit_tpu.train import steps as jax_steps
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import MaskNet, make_masknet
from voicesplit_tpu_torch.ops import conv_cuda as cc
from voicesplit_tpu_torch.ops import conv_fused as cf
from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
# the chain's frames need F = 37 (the fold and a frequency tile); the dilated
# conv takes any F
B, T, F = 2, 11, 37
F_DILATED = 13
# the (7,1) layer, a (5,5) layer, and a (5,5) layer whose dilation reaches
# past T
SPECS = {"7x1": ((7, 1), 1), "5x5-d1": ((5, 5), 1), "5x5-d8": ((5, 5), 8)}
# (Cin, Cout) of the dilated conv
WIDTHS = {"96": (96, 96), "128": (128, 128), "64-128": (64, 128)}
C_CHAIN = 128  # the chain's width: 2·C a multiple of 128, above the 64 of every config
PEAK_TOL = 1e-4  # fp32 values
GRAD_TOL = 5e-4  # gradients through the chain
EPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _small_tiles(monkeypatch):
    monkeypatch.setenv("VOICESPLIT_CONV_TILES", "16,64")


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_peak_close(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=msg)


def _inputs(seed, kt, kf, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F_DILATED, cin)).astype(np.float32)
    dy = rng.standard_normal((B, T, F_DILATED, cout)).astype(np.float32)
    w = ((kt * kf * cin) ** -0.5 * rng.standard_normal((kt, kf, cin, cout))).astype(np.float32)
    return x, dy, w


# ---------------------------------------------------------------------------
# The dilated conv (`conv_cuda`) against `conv2d_pallas`
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_dilated_forward_plain_version_matches_pallas_kernel(width, spec):
    (kt, kf), dt = SPECS[spec]
    cin, cout = WIDTHS[width]
    x, _, w = _inputs(1, kt, kf, cin, cout)
    want = jcp.conv2d_pallas(jnp.asarray(x), jnp.asarray(w), (dt, 1))
    got = cc.conv_dilated_fwd(torch.from_numpy(x), torch.from_numpy(w), dt)
    assert got.shape == (B, T, F_DILATED, cout) and got.is_contiguous()
    _assert_peak_close(got.numpy(), _np(want), PEAK_TOL)


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_dilated_wgrad_plain_version_matches_pallas_kernel(width, spec):
    (kt, kf), dt = SPECS[spec]
    cin, cout = WIDTHS[width]
    x, dy, _ = _inputs(2, kt, kf, cin, cout)
    want = jcp._conv_wgrad_core(jnp.asarray(x), jnp.asarray(dy), (kt, kf), (dt, 1))
    got = cc.conv_dilated_wgrad(torch.from_numpy(x), torch.from_numpy(dy), kt, kf, dt)
    assert got.shape == (kt, kf, cin, cout) and got.dtype == torch.float32
    _assert_peak_close(got.numpy(), _np(want), PEAK_TOL)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_dilated_data_gradient_matches_jax_grad_of_conv2d_pallas(width):
    """Both gradients of ``Σ conv(x, w)·cot`` ((5,5), dilation 8): the data
    gradient is `conv_dilated_fwd` on the flipped, transposed weights
    ([kt, kf, Cout, Cin]), the weight gradient `conv_dilated_wgrad`."""
    (kt, kf), dt = SPECS["5x5-d8"]
    cin, cout = WIDTHS[width]
    x, cot, w = _inputs(3, kt, kf, cin, cout)
    cot_j = jnp.asarray(cot)

    def loss(xj, wj):
        return jnp.sum(jcp.conv2d_pallas(xj, wj, (dt, 1)) * cot_j)

    gx, gw = jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (cc.conv2d_dilated(xt, wt, (dt, 1)) * torch.from_numpy(cot)).sum().backward()
    assert xt.grad.shape == (B, T, F_DILATED, cin) and wt.grad.shape == (kt, kf, cin, cout)
    _assert_peak_close(xt.grad.numpy(), _np(gx), PEAK_TOL, "dx")
    _assert_peak_close(wt.grad.numpy(), _np(gw), PEAK_TOL, "dw")
    flipped = cc.flip_weight(torch.from_numpy(w))
    assert flipped.shape == (kt, kf, cout, cin)
    dx = cc.conv_dilated_fwd(torch.from_numpy(cot), flipped, dt)
    _assert_peak_close(dx.numpy(), _np(gx), PEAK_TOL, "flipped")


def test_kernels_take_every_width_the_jax_package_sends():
    """`_check_kernel_takes` accepts what `takes_layer` sends (64 channels or
    more, in and out apart) and still refuses what the kernels are not built
    for: fewer than 64 channels, too many time taps for the forward's ring,
    frequency taps the weight gradient has no instantiation for."""
    for cin, cout in ((64, 64), (96, 96), (128, 128), (64, 128), (128, 64), (192, 192), (100, 100)):
        for kt, kf in ((7, 1), (5, 5), (7, 3)):
            cc._check_kernel_takes(cin, cout, kt, kf, wgrad=False)
            cc._check_kernel_takes(cin, cout, kt, kf, wgrad=True)
    for cin, cout in ((32, 64), (64, 8), (1, 64)):
        with pytest.raises(NotImplementedError, match="at least 64 channels"):
            cc._check_kernel_takes(cin, cout, 5, 5, wgrad=False)
    for kt, kf in ((5, 7), (7, 5), (3, 2)):
        with pytest.raises(NotImplementedError, match="taps"):
            cc._check_kernel_takes(128, 128, kt, kf, wgrad=False)
    with pytest.raises(NotImplementedError, match="taps"):
        cc._check_kernel_takes(128, 128, 5, 7, wgrad=True)
    with pytest.raises(NotImplementedError, match="taps"):
        cc._check_kernel_takes(96, 96, 9, 1, wgrad=True)
    # the zero padding to the copies' width: 100 channels → 104
    assert [cc._aligned(n) for n in (64, 96, 100, 130)] == [64, 96, 104, 136]
    x = torch.ones(1, 2, 3, 5)
    assert torch.equal(cc._pad_last(x, 3)[..., 5:], torch.zeros(1, 2, 3, 3))
    w = torch.ones(1, 1, 5, 6)
    assert cc._pad_last(w, 2, 3).shape == (1, 1, 8, 8)


# ---------------------------------------------------------------------------
# The chain's kernels (`conv_fused`) against the Pallas chain's, C = 128
# ---------------------------------------------------------------------------


def _geom(kt, dt, C=C_CHAIN):
    """The JAX kernels' frame of a layer: time margin of its own reach."""
    return jcf.FrameGeom(T, F, FOLD * C, (kt - 1) * dt // 2)


def _frame(x, geom):
    return jcf.to_frame(fold_input(jnp.asarray(x)), geom)


def _unframe(frame, geom):
    return _np(unfold_output(jcf.from_frame(frame, geom), F))


def _unfold_channels(v, C=C_CHAIN):
    """A folded [2C] per-channel sum → [C]."""
    return _np(v).reshape(FOLD, C).sum(0)


def _layer_inputs(seed, kt, kf, C=C_CHAIN):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F, C)).astype(np.float32)
    w = ((kt * kf * C) ** -0.5 * rng.standard_normal((kt, kf, C, C))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    bn = (0.2 * rng.standard_normal(C), rng.uniform(0.5, 2.0, C), rng.uniform(0.5, 1.5, C),
          0.1 * rng.standard_normal(C))
    return x, w, bias, tuple(a.astype(np.float32) for a in bn)


def _scal_pair(bn):
    t = [torch.from_numpy(a) for a in bn]
    return cf._scal_table(*t, eps=EPS), jcf._scal_table(*map(jnp.asarray, bn), eps=EPS)


@pytest.mark.parametrize("prologue", ["plain", "mish"])
@pytest.mark.parametrize("spec", ["7x1", "5x5-d8"])
def test_chain_forward_plain_version_matches_pallas_kernel(spec, prologue):
    (kt, kf), dt = SPECS[spec]
    act, on = ("mish", True) if prologue == "mish" else (None, False)
    x, w, bias, bn = _layer_inputs(4, kt, kf)
    scal_t, scal_j = _scal_pair(bn)
    geom = _geom(kt, dt)
    wf = fold_kernel(jnp.asarray(w))
    frame, stats = jcf._conv_fwd(
        _frame(x, geom), jcf._pack(wf), scal_j, jnp.tile(jnp.asarray(bias), FOLD)[None, :],
        geom, kt, wf.shape[1], dt, act, on,
    )
    raw, st = cf.conv_bn_act_fwd(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), scal_t, dt, act, on
    )
    assert raw.shape == (B, T, F, C_CHAIN) and st.shape == (2, C_CHAIN)
    _assert_peak_close(raw.numpy(), _unframe(frame, geom), PEAK_TOL)
    _assert_peak_close(st[0].numpy(), _unfold_channels(stats[0]), PEAK_TOL, "sum")
    _assert_peak_close(st[1].numpy(), _unfold_channels(stats[1]), PEAK_TOL, "sum of squares")


def test_chain_dgrad_plain_version_matches_pallas_kernel():
    (kt, kf), dt = SPECS["5x5-d1"]
    d_raw, w, _, _ = _layer_inputs(5, kt, kf)
    geom = _geom(kt, dt)
    wf = fold_kernel(jnp.asarray(w))
    frame = _frame(d_raw, geom)
    out, dbias = jcf._conv_dgrad(
        frame, frame, jcf._flip_packed(wf), jnp.zeros((8, FOLD * C_CHAIN), jnp.float32), geom, kt,
        wf.shape[1], dt, None, prologue=False,
    )
    dx, db = cf.conv_dgrad(torch.from_numpy(d_raw),
                           cf.pack_weight_flipped(torch.from_numpy(w), torch.float32), dt)
    assert dx.shape == (B, T, F, C_CHAIN) and db.shape == (C_CHAIN,)
    _assert_peak_close(dx.numpy(), _unframe(out, geom), PEAK_TOL)
    _assert_peak_close(db.numpy(), _unfold_channels(dbias[0]), PEAK_TOL, "dbias")


@pytest.mark.parametrize("spec", ["7x1", "5x5-d8"])
def test_chain_wgrad_with_its_prologue_matches_pallas_kernel(spec):
    (kt, kf), dt = SPECS[spec]
    x, _, _, bn = _layer_inputs(6, kt, kf)
    d_raw = np.random.default_rng(7).standard_normal((B, T, F, C_CHAIN)).astype(np.float32)
    scal_t, scal_j = _scal_pair(bn)
    geom = _geom(kt, dt)
    zero = jnp.zeros((8, FOLD * C_CHAIN), jnp.float32)
    kb = fold_kernel(jnp.zeros((kt, kf, 1, 1))).shape[1]
    d_frame = _frame(d_raw, geom)
    dwf = jcf._conv_wgrad(
        _frame(x, geom), d_frame, d_frame, scal_j, zero, geom, kt, kb, dt, "mish", None,
        lhs_prologue=True, rhs_prologue=False,
    )
    want = jcf._unfold_grad(dwf, kt, kf, C_CHAIN, C_CHAIN)
    got = cf.conv_wgrad(torch.from_numpy(x), torch.from_numpy(d_raw), scal_t, kt, kf, dt, "mish", True)
    assert got.shape == (kt, kf, C_CHAIN, C_CHAIN)
    _assert_peak_close(got.numpy(), _np(want), PEAK_TOL)
    # the prologue pass alone, then the dilated conv's weight gradient: the
    # same function (and on the card the same bits)
    y = cf.conv_wgrad_prologue(torch.from_numpy(x), scal_t, "mish")
    _assert_peak_close(cc.conv_dilated_wgrad(y, torch.from_numpy(d_raw), kt, kf, dt).numpy(),
                       got.numpy(), 1e-6)


def test_chain_matches_jax_make_chain():
    """Value, statistics and every gradient of a (7,1), a (5,5) and a dilated
    (5,5) layer at C = 128 (fp32).  The inner layers' conv-bias gradients
    are analytically zero (a train-mode BatchNorm cancels a constant shift),
    so both sides hold summation noise there and an absolute floor is the
    comparison, as in `tests/test_torch_chain_model.py`."""
    rng = np.random.default_rng(8)
    C = C_CHAIN
    specs = [SPECS[k] for k in ("7x1", "5x5-d1", "5x5-d8")]
    params = (
        [((kt * kf * C) ** -0.5 * rng.standard_normal((kt, kf, C, C))).astype(np.float32)
         for (kt, kf), _ in specs],
        [(0.1 * rng.standard_normal(C)).astype(np.float32) for _ in specs],
        [(1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32) for _ in specs[:-1]],
        [(0.1 * rng.standard_normal(C)).astype(np.float32) for _ in specs[:-1]],
    )
    y1 = rng.standard_normal((B, T, F, C)).astype(np.float32)
    cot = rng.standard_normal((B, T, F, C)).astype(np.float32)
    cot_j = fold_input(jnp.asarray(cot))
    jchain = jcf.make_chain(specs, T, F, "mish", EPS)

    def loss(y1f, ws, cbs, scales, biases):
        raw, means, vars_ = jchain(y1f, ws, cbs, scales, biases)
        return jnp.sum(raw * cot_j), (raw, means, vars_)

    jparams = [tuple(jnp.asarray(a) for a in group) for group in params]
    (_, (raw_j, means_j, vars_j)), grads_j = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True
    )(fold_input(jnp.asarray(y1)), *jparams)

    y1_t = torch.from_numpy(y1).requires_grad_()
    tparams = [tuple(torch.from_numpy(a).requires_grad_() for a in group) for group in params]
    raw, means, vars_ = cf.make_chain(specs, "mish", EPS)(y1_t, *tparams)
    (raw * torch.from_numpy(cot)).sum().backward()

    _assert_peak_close(raw.detach().numpy(), _np(unfold_output(raw_j, F)), PEAK_TOL, "raw")
    for a, b in zip(means + vars_, tuple(means_j) + tuple(vars_j)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-4, atol=1e-4)
    _assert_peak_close(y1_t.grad.numpy(), _np(unfold_output(grads_j[0], F)), GRAD_TOL, "d_y1")
    names = ["d_W", "d_conv_bias", "d_scale", "d_bias"]
    for name, got_group, want_group in zip(names, tparams, grads_j[1:]):
        for idx, (p, want) in enumerate(zip(got_group, want_group)):
            if name == "d_conv_bias":
                np.testing.assert_allclose(p.grad.numpy(), _np(want), rtol=5e-3, atol=2e-3,
                                           err_msg=f"{name}[{idx}]")
            else:
                _assert_peak_close(p.grad.numpy(), _np(want), GRAD_TOL, f"{name}[{idx}]")


# ---------------------------------------------------------------------------
# MaskNet and the train step at conv_channels = 128, each switch
# ---------------------------------------------------------------------------

DIMS = dict(num_freq=F, emb_dim=16, lstm_dim=24, fc1_dim=20, fc2_dim=F, conv_channels=C_CHAIN)
TM = 11
SWITCHES = {"dilated": "VOICESPLIT_PALLAS_CONV", "chain": "VOICESPLIT_FUSED_CHAIN"}


def _switch_on(monkeypatch, switch):
    """The switch in both packages: the port reads its variable, the JAX
    package's switch functions are TPU-only and are patched."""
    monkeypatch.setenv(SWITCHES[switch], "1")
    if switch == "dilated":
        monkeypatch.setattr(jcp, "pallas_conv_available", lambda: True)
    else:
        monkeypatch.setattr(jcf, "fused_chain_enabled", lambda: True)


def _counted(monkeypatch):
    """Calls of the port's conv wrappers while the model runs."""
    counts = {}
    for mod, names in ((cc, ("conv_dilated_fwd", "conv_dilated_wgrad", "conv_bn_act_eval")),
                       (cf, ("conv_bn_act_fwd", "conv_dgrad", "conv_wgrad"))):
        for name in names:
            counts[name] = 0
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name):
                counts[_name] += 1
                return _fn(*a)

            monkeypatch.setattr(mod, name, counted)
    return counts


def _model_inputs(seed):
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0, 1, (2, TM, F)).astype(np.float32)
    emb = rng.standard_normal((2, DIMS["emb_dim"])).astype(np.float32)
    cot = rng.standard_normal((2, TM, F)).astype(np.float32)
    return spec, emb, cot


def _assert_grads_close(got, want, rel):
    """Per parameter, within `rel` of the model's largest gradient; the conv
    biases under a train-mode BatchNorm hold only round-off."""
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=rel * scale, rtol=0, err_msg=k)


def test_masknet_eval_with_the_dilated_switch_matches_jax(monkeypatch):
    """Eval-mode `MaskNet` at 128 channels, the dilated switch on in both
    packages: six kernel-path eval-mode blocks a call, the JAX model's mask
    (fp32)."""
    port = MaskNet(activation="mish", **DIMS).eval()
    params, stats = weights.random_jax_variables(port, seed=1)
    port.load_state_dict(weights.state_dict_from_jax(params, stats))
    spec, emb, _ = _model_inputs(2)
    _switch_on(monkeypatch, "dilated")
    mask_j = JaxMaskNet(activation="mish", **DIMS).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(spec), jnp.asarray(emb))
    counts = _counted(monkeypatch)
    with torch.no_grad():
        mask = port(torch.from_numpy(spec), torch.from_numpy(emb))
    assert {k: v for k, v in counts.items() if v} == {"conv_bn_act_eval": 6}
    np.testing.assert_allclose(mask.numpy(), _np(mask_j), atol=2e-5)


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_masknet_train_matches_jax_on_each_switch(switch, monkeypatch):
    """Train-mode `MaskNet` at 128 channels with the switch on in both
    packages: mask, every running statistic and every gradient (fp32), and
    the port's conv calls (dilated: 12 forward and 6 weight-gradient; the
    chain: 6 of each of its kernels)."""
    port = MaskNet(activation="mish", **DIMS).train()
    params, stats = weights.random_jax_variables(port, seed=1)
    port.load_state_dict(weights.state_dict_from_jax(params, stats))
    spec, emb, cot = _model_inputs(5)
    jm = JaxMaskNet(activation="mish", **DIMS)
    _switch_on(monkeypatch, switch)

    def loss(p):
        mask, upd = jm.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(spec), jnp.asarray(emb),
            train=True, mutable=["batch_stats"],
        )
        return jnp.sum(mask * cot), (mask, upd["batch_stats"])

    (_, (mask_j, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)

    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        mask = port(torch.from_numpy(spec), torch.from_numpy(emb))
        port.load_state_dict(before)
    np.testing.assert_allclose(mask.numpy(), _np(mask_j), atol=2e-5)
    counts = _counted(monkeypatch)
    port.zero_grad()
    (port(torch.from_numpy(spec), torch.from_numpy(emb)) * torch.from_numpy(cot)).sum().backward()
    want_counts = ({"conv_dilated_fwd": 12, "conv_dilated_wgrad": 6} if switch == "dilated" else
                   {"conv_bn_act_fwd": 6, "conv_dgrad": 6, "conv_wgrad": 6})
    assert {k: v for k, v in counts.items() if v} == want_counts
    got = {k: p.grad.numpy().copy() for k, p in port.named_parameters()}
    want = {k: v.numpy() for k, v in weights.params_from_jax(jax.device_get(grads)).items()}
    _assert_grads_close(got, want, 1e-4)
    want_sd = weights.state_dict_from_jax(params, jax.device_get(new_stats))
    for k, v in port.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-5, err_msg=k)
            assert not torch.equal(v, before[k]), k


HOP, FRAMES = 32, 16
L = HOP * FRAMES
LR = 1e-3


def _config_text():
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=32, hop_length=HOP, win_length=32, num_freq=17)
    d["audio"]["audio_len"] = L / 16000
    d["model"].update(conv_channels=C_CHAIN, lstm_dim=16, fc1_dim=24, fc2_dim=17, emb_dim=16)
    d["train_config"].update(compute_dtype="float32", learning_rate=LR)
    return json.dumps(d)


def _batch(batch, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    target = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300, (batch, 1)) * t)
    mixed = target + 0.2 * np.sin(2 * np.pi * rng.uniform(400, 900, (batch, 1)) * t)
    mixed += 0.02 * rng.standard_normal((batch, L))
    return {
        "mixed_wav": mixed.astype(np.float32), "target_wav": target.astype(np.float32),
        "emb": rng.standard_normal((batch, 16)).astype(np.float32),
        "wav_len": np.full((batch,), L, np.int32),
    }


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_train_step_at_128_channels_matches_jax(switch, monkeypatch):
    """One `make_train_step` step of each package at ``conv_channels`` =
    128 with the switch on, from the same weights and batch (fp32, si_snr,
    Adam), as `tests/test_torch_conv_cuda.py` and
    `tests/test_torch_chain_model.py` compare them at 64: loss and grad_norm
    to summation order, running statistics to 1e-5, the gradients (read from
    Adam's first moment, 0.1·g) within 5e-3 of the model's largest, every
    weight within 2·lr."""
    text = _config_text()
    jc, tc = jax_config(text), load_config_from_str(text)
    model = make_masknet(tc, device="cpu")
    assert model.conv_channels == C_CHAIN
    params, stats = weights.random_jax_variables(model, 0)
    model.load_state_dict(weights.state_dict_from_jax(params, stats))
    ap = make_audio_processor(tc, device="cpu")
    optimizer = make_optimizer(tc, model)
    state = create_train_state(model, optimizer)
    tx = jax_state.make_optimizer(jc)
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params)
    )
    batch = _batch(2, seed=1)

    _switch_on(monkeypatch, switch)
    jstep = jax_steps.make_train_step(jc, jax_make_masknet(jc), jax_audio_processor(jc), tx, donate=False)
    jstate, jm = jstep(jstate, batch)

    counts = _counted(monkeypatch)
    m = make_train_step(tc, model, ap, optimizer)(state, batch)
    key = "conv_dilated_wgrad" if switch == "dilated" else "conv_wgrad"
    assert counts[key] == 6  # the step went through the switch's kernels

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want_sd = weights.state_dict_from_jax(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    )
    got_sd = model.state_dict()
    for k, want in want_sd.items():
        tol = 1e-5 if k.endswith((".mean", ".var")) else 2 * LR + 1e-7
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=tol, rtol=0, err_msg=k)
    mu = weights.params_from_jax(weights._adam_state(jax.device_get(jstate.opt_state)).mu)
    exp_avg = {k: optimizer.state[p]["exp_avg"].numpy() for k, p in model.named_parameters()}
    _assert_grads_close(exp_avg, {k: v.numpy() for k, v in mu.items()}, 5e-3)
