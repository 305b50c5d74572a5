"""The port's fused conv chain (`voicesplit_tpu_torch/ops/conv_fused.py`)
against the JAX package's (`voicesplit_tpu/ops/conv_fused.py`).

On the CPU the port's wrappers run their plain versions and the JAX side
runs its Pallas kernels in interpret mode, as `tests/test_conv_fused.py`
does.  The chain against `make_chain`, the model and one train step with
the chain on are in `tests/test_torch_chain_model.py`, the forward's bf16
comparisons in `tests/test_torch_chain_fwd.py`; both import the helpers
below.  The port works on channels-last ``[B, T, F, C]``; the JAX kernels on
frequency-folded, zero-margined frames.  The conversions between the two
(fold, frame, folded weights, the folded scalar table and statistics) live
here.  Geometry of `tests/test_conv_fused.py`: odd F (a real pad column in
the fold), C = 64; the kernel-level tests take each layer kind of conv2 …
conv7 (a (7,1) layer and (5,5) layers of time dilation 1 … 16, the last
three reaching past T), the chain the (7,1), a (5,5) and a dilated (5,5)
layer.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import voicesplit_tpu.ops.conv_fused as jcf
from voicesplit_tpu.ops.conv_fold import FOLD, fold_input, fold_kernel, unfold_output
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli.separate import separate_batch
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import MaskNet, make_masknet
from voicesplit_tpu_torch.ops import conv_cuda as cc
from voicesplit_tpu_torch.ops import conv_fused as cf
from voicesplit_tpu_torch.train import make_eval_step

REPO = pathlib.Path(__file__).resolve().parents[1]
B, T, F, C = 2, 19, 37, 64
SPECS = {"7x1": ((7, 1), 1), "5x5": ((5, 5), 1), "5x5-d2": ((5, 5), 2), "5x5-d4": ((5, 5), 4),
         "5x5-d8": ((5, 5), 8), "5x5-d16": ((5, 5), 16)}
CHAIN_SPECS = [SPECS[k] for k in ("7x1", "5x5", "5x5-d2")]
EPS = 1e-5
# the JAX kernels' frame of each layer: time margin of its own reach
GEOMS = {name: jcf.FrameGeom(T, F, FOLD * C, (k[0] - 1) * d // 2) for name, (k, d) in SPECS.items()}
# fp32, both sides: the same products summed in another order (the fold
# splits each sum over parity slots); relative to each output's peak
PEAK_TOL = 1e-4


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _frame(x: np.ndarray, geom, dtype=jnp.float32):
    """[B, T, F, C] → the JAX kernels' zero-margined folded frame."""
    return jcf.to_frame(fold_input(jnp.asarray(x).astype(dtype)), geom)


def _unframe(frame, geom) -> np.ndarray:
    return _np(unfold_output(jcf.from_frame(frame, geom), F))


def _unfold_channels(v) -> np.ndarray:
    """A folded [2C] per-channel sum → [C]."""
    return _np(v).reshape(FOLD, C).sum(0)


def _assert_peak_close(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=msg)


def _layer_inputs(seed, kt, kf):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F, C)).astype(np.float32)
    w = (0.08 * rng.standard_normal((kt, kf, C, C))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    mean = (0.2 * rng.standard_normal(C)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    beta = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, w, bias, (mean, var, scale, beta)


def _scal_pair(bn):
    """The scalar table in both packages' layouts."""
    t = [torch.from_numpy(a) for a in bn]
    return cf._scal_table(*t, eps=EPS), jcf._scal_table(*map(jnp.asarray, bn), eps=EPS)


PROLOGUES = {"plain": (None, False), "mish": ("mish", True), "relu": ("relu", True)}


@pytest.mark.parametrize("prologue", sorted(PROLOGUES))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_forward_plain_version_matches_pallas_kernel(spec, prologue):
    (kt, kf), dt = SPECS[spec]
    act, on = PROLOGUES[prologue]
    x, w, bias, bn = _layer_inputs(1, kt, kf)
    scal_t, scal_j = _scal_pair(bn)
    wf = fold_kernel(jnp.asarray(w))
    frame, stats = jcf._conv_fwd(
        _frame(x, GEOMS[spec]), jcf._pack(wf), scal_j, jnp.tile(jnp.asarray(bias), FOLD)[None, :],
        GEOMS[spec], kt, wf.shape[1], dt, act, on,
    )
    raw, st = cf.conv_bn_act_fwd(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), scal_t, dt, act, on
    )
    assert raw.shape == (B, T, F, C) and raw.is_contiguous() and st.shape == (2, C)
    _assert_peak_close(raw.numpy(), _unframe(frame, GEOMS[spec]), PEAK_TOL)
    _assert_peak_close(st[0].numpy(), _unfold_channels(stats[0]), PEAK_TOL, "sum")
    _assert_peak_close(st[1].numpy(), _unfold_channels(stats[1]), PEAK_TOL, "sum of squares")
    n = B * T * F
    for got, want in zip(cf._mean_var(st, n), jcf._mean_var(stats, n)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_dgrad_plain_version_matches_pallas_kernel(spec):
    (kt, kf), dt = SPECS[spec]
    d_raw, w, _, _ = _layer_inputs(3, kt, kf)
    wf = fold_kernel(jnp.asarray(w))
    zero = jnp.zeros((8, FOLD * C), jnp.float32)
    frame = _frame(d_raw, GEOMS[spec])
    out, dbias = jcf._conv_dgrad(
        frame, frame, jcf._flip_packed(wf), zero, GEOMS[spec], kt, wf.shape[1], dt, None,
        prologue=False,
    )
    wt = torch.from_numpy(w)
    dx, db = cf.conv_dgrad(torch.from_numpy(d_raw), cf.pack_weight_flipped(wt, torch.float32), dt)
    assert dx.shape == (B, T, F, C) and dx.is_contiguous() and db.shape == (C,)
    _assert_peak_close(dx.numpy(), _unframe(out, GEOMS[spec]), PEAK_TOL)
    _assert_peak_close(db.numpy(), _unfold_channels(dbias[0]), PEAK_TOL, "dbias")


@pytest.mark.parametrize("prologue", sorted(PROLOGUES))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_wgrad_plain_version_matches_pallas_kernel(spec, prologue):
    (kt, kf), dt = SPECS[spec]
    act, on = PROLOGUES[prologue]
    x, _, _, bn = _layer_inputs(4, kt, kf)
    d_raw = np.random.default_rng(5).standard_normal((B, T, F, C)).astype(np.float32)
    scal_t, scal_j = _scal_pair(bn)
    zero = jnp.zeros((8, FOLD * C), jnp.float32)
    kb = fold_kernel(jnp.zeros((kt, kf, 1, 1))).shape[1]
    d_frame = _frame(d_raw, GEOMS[spec])
    dwf = jcf._conv_wgrad(
        _frame(x, GEOMS[spec]), d_frame, d_frame, scal_j, zero, GEOMS[spec], kt, kb, dt, act, None,
        lhs_prologue=on, rhs_prologue=False,
    )
    want = jcf._unfold_grad(dwf, kt, kf, C, C)
    got = cf.conv_wgrad(torch.from_numpy(x), torch.from_numpy(d_raw), scal_t, kt, kf, dt, act, on)
    assert got.shape == (kt, kf, C, C) and got.dtype == torch.float32
    _assert_peak_close(got.numpy(), _np(want), PEAK_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["mish", "relu"])
def test_prologue_pass_then_weight_gradient_is_conv_wgrad(act, dtype):
    """`conv_wgrad` with its prologue is the prologue pass (`wgrad_prologue`)
    followed by the prologue-free weight gradient (`conv_dilated_wgrad`), bit
    for bit, as the CUDA kernels compute it; and both match the Pallas
    kernel with its prologue in interpret mode.  bf16: both sides round the
    activated input to bf16 before exact products, but XLA may compute the
    activation with other roundings, which can move an element by one bf16
    ulp; 1e-3 of dW's peak holds that (fp32: summation order only)."""
    (kt, kf), dt = SPECS["5x5-d2"]
    x, _, _, bn = _layer_inputs(9, kt, kf)
    d_raw = np.random.default_rng(10).standard_normal((B, T, F, C)).astype(np.float32)
    scal_t, scal_j = _scal_pair(bn)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    xt, dtt = torch.from_numpy(x).to(td), torch.from_numpy(d_raw).to(td)
    y = cf.conv_wgrad_prologue(xt, scal_t, act)
    assert y.dtype == td and torch.equal(y, cf._prologue(xt, scal_t, act, True))
    split = cc.conv_dilated_wgrad(y, dtt, kt, kf, dt)
    whole = cf.conv_wgrad(xt, dtt, scal_t, kt, kf, dt, act, True)
    assert torch.equal(split, whole)
    assert torch.equal(whole, cf.conv_wgrad_ref(xt, dtt, scal_t, kt, kf, dt, act, True))
    zero = jnp.zeros((8, FOLD * C), jnp.float32)
    kb = fold_kernel(jnp.zeros((kt, kf, 1, 1))).shape[1]
    g = GEOMS["5x5-d2"]
    d_frame = _frame(d_raw, g, jd)
    dwf = jcf._conv_wgrad(
        _frame(x, g, jd), d_frame, d_frame, scal_j, zero, g, kt, kb, dt, act, None,
        lhs_prologue=True, rhs_prologue=False,
    )
    tol = PEAK_TOL if dtype == "float32" else 1e-3
    _assert_peak_close(whole.numpy(), _np(jcf._unfold_grad(dwf, kt, kf, C, C)), tol)
    with pytest.raises(ValueError, match="prologue needs act"):
        cf.conv_wgrad_prologue(xt, scal_t, None)


def test_flipped_weights_give_the_convs_data_gradient():
    """`conv_dgrad` with `pack_weight_flipped` is autograd's gradient of the
    forward conv with respect to its input (fp32, dilated)."""
    (kt, kf), dt = SPECS["5x5-d2"]
    x, w, bias, _ = _layer_inputs(6, kt, kf)
    cot = np.random.default_rng(7).standard_normal((B, T, F, C)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (cf._conv_core(xt, wt, dt) * torch.from_numpy(cot)).sum().backward()
    dx, _ = cf.conv_dgrad(torch.from_numpy(cot), cf.pack_weight_flipped(wt.detach(), torch.float32), dt)
    zero = torch.zeros(8, C)
    dw = cf.conv_wgrad(torch.from_numpy(x), torch.from_numpy(cot), zero, kt, kf, dt, None, False)
    _assert_peak_close(dx.numpy(), xt.grad.numpy(), 1e-5)
    _assert_peak_close(dw.numpy(), wt.grad.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# The chain against `make_chain`
# ---------------------------------------------------------------------------


def _chain_params(rng):
    specs = CHAIN_SPECS
    ws = [(0.08 * rng.standard_normal((kt, kf, C, C))).astype(np.float32) for (kt, kf), _ in specs]
    cbs = [(0.1 * rng.standard_normal(C)).astype(np.float32) for _ in specs]
    scales = [(1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32) for _ in specs[:-1]]
    biases = [(0.1 * rng.standard_normal(C)).astype(np.float32) for _ in specs[:-1]]
    return ws, cbs, scales, biases


def test_chain_checks_its_arguments():
    chain = cf.make_chain(CHAIN_SPECS, "mish")
    ws, cbs, scales, biases = (tuple(map(torch.from_numpy, g)) for g in _chain_params(np.random.default_rng(0)))
    y1 = torch.zeros(B, T, F, C)
    with pytest.raises(ValueError, match="BatchNorm affines"):
        chain(y1, ws, cbs, scales[:-1], biases)
    with pytest.raises(ValueError, match="unknown activation"):
        cf.make_chain(CHAIN_SPECS, "gelu")
    with pytest.raises(ValueError, match="odd"):
        cf.conv_bn_act_fwd(y1, torch.zeros(4, 5, C, C), cbs[0], torch.zeros(8, C), 1, None, False)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        cf.conv_dgrad(y1.half(), torch.zeros(5, 5, C, C).half(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        cf.conv_dgrad(y1.transpose(1, 2), torch.zeros(5, 5, C, C), 1)
    with pytest.raises(ValueError, match="prologue"):
        cf.conv_wgrad(y1, y1, torch.zeros(8, C), 5, 5, 1, None, True)


# ---------------------------------------------------------------------------
# The model and the train step with the chain on
# ---------------------------------------------------------------------------

DIMS = dict(num_freq=37, emb_dim=16, lstm_dim=24, fc1_dim=20, fc2_dim=37, conv_channels=64)
TM = 11


def _port_on(monkeypatch, on=True):
    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "1" if on else "0")


def _model_inputs(seed):
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0, 1, (2, TM, DIMS["num_freq"])).astype(np.float32)
    emb = rng.standard_normal((2, DIMS["emb_dim"])).astype(np.float32)
    cot = rng.standard_normal((2, TM, DIMS["num_freq"])).astype(np.float32)
    return spec, emb, cot


def _port_grads(port, spec, emb, cot):
    port.zero_grad()
    (port(torch.from_numpy(spec), torch.from_numpy(emb)) * torch.from_numpy(cot)).sum().backward()
    return {k: p.grad.numpy().copy() for k, p in port.named_parameters()}


def _assert_grads_close(got, want, rel):
    """Per parameter, within `rel` of the model's largest gradient; the
    conv biases under a train-mode BatchNorm hold only round-off."""
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=rel * scale, rtol=0, err_msg=k)


def test_eval_mode_and_narrow_models_ignore_the_switch(monkeypatch):
    _port_on(monkeypatch)
    port = MaskNet(activation="mish", **DIMS)
    assert port.train()._use_fused_chain() and not port.eval()._use_fused_chain()
    narrow = MaskNet(activation="mish", **{**DIMS, "conv_channels": 8}).train()
    assert not narrow._use_fused_chain()  # 2·8 is no multiple of 128
    _port_on(monkeypatch, False)
    assert not port.train()._use_fused_chain()
    assert not cf.fused_chain_enabled()


HOP, FRAMES = 32, 24
L = HOP * FRAMES
LR = 1e-3


def _config_text():
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=HOP, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = L / 16000
    d["model"].update(conv_channels=64, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=16)
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


def test_eval_step_and_serving_ignore_the_switch(monkeypatch):
    """`make_eval_step` and `separate_batch` run the model in eval mode:
    the same numbers with the switch on and off, and no call of the chain."""
    tc = load_config_from_str(_config_text())
    model = weights.init_random_(make_masknet(tc, device="cpu"), 1)
    ap = make_audio_processor(tc, device="cpu")
    batch = _batch(2, seed=2)
    monkeypatch.setattr(
        cf._Chain, "apply", lambda *a: pytest.fail("the chain ran in eval mode")
    )
    out = {}
    for on in (False, True):
        _port_on(monkeypatch, on)
        model.train()  # the eval step switches to eval mode itself
        ev = make_eval_step(tc, model, ap)(batch)
        model.eval()  # serving: the mode `make_masknet` returns
        out[on] = (float(ev["loss"]), separate_batch(model, ap, batch["mixed_wav"], batch["emb"]))
    assert out[True][0] == out[False][0]
    assert torch.equal(out[True][1], out[False][1])


def test_a_cuda_device_without_a_card_still_raises(monkeypatch):
    """The switch opens no quiet CPU path: the card is still the default."""
    _port_on(monkeypatch)
    tc = load_config_from_str(_config_text())
    if torch.cuda.is_available():
        assert next(make_masknet(tc).parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_masknet(tc)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_masknet(tc, device="cuda")
