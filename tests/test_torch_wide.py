"""The wide variant (`configs/voicesplit_wide.json`: extra dilated blocks at
time dilation 32·2^i, `lstm_dim` 800) in the port, against the JAX package.

The port's `MaskNet(num_extra_dilated_blocks=n)` and the JAX `MaskNet` with
the same `num_extra_dilated_blocks`, carried weights (`weights.py`) and
numpy inputs: the eval forward, and in train mode the mask, every running
statistic and every gradient on each conv route (the library conv, the
fused chain `VOICESPLIT_FUSED_CHAIN=1`, the dilated-conv switch
`VOICESPLIT_PALLAS_CONV=1`), then one `make_train_step` step of each package
from the wide config cut to test size.  T is 70 frames or more, so that the
outer taps of the dilation-32 block (64 rows to each side) read real rows;
widths are small (37 frequencies, 64 channels; the fused chain's cases are
in `tests/test_torch_wide_chain.py`, a file of its own so that test workers
that take whole files share them out).  On the CPU the port runs
its plain versions and the JAX side its Pallas kernels in interpret mode,
its switches patched on as `tests/test_torch_chain_model.py` and
`tests/test_torch_conv_cuda.py` patch them.

Then the LSTM backward's plain versions at H = 800, the width at which the
card's backward takes its grid route, against `lstm_pallas._bwd` / `_bwd2`
in interpret mode, with `tests/test_torch_lstm_rows.py`'s tolerances.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voicesplit_tpu.ops.conv_fused as jcf
import voicesplit_tpu.ops.conv_pallas as jcp
from test_torch_lstm_rows import _arr, _cast, _close, _shifted, _t32
from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.models.masknet import MaskNet as JaxMaskNet
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.ops import lstm_pallas
from voicesplit_tpu.train import state as jax_state
from voicesplit_tpu.train import steps as jax_steps
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.config import load_config, load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import MaskNet, make_masknet
from voicesplit_tpu_torch.ops import conv_cuda as cc
from voicesplit_tpu_torch.ops import conv_fused as cf
from voicesplit_tpu_torch.ops import lstm_cuda
from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
DIMS = dict(num_freq=37, emb_dim=16, lstm_dim=24, fc1_dim=20, fc2_dim=37, conv_channels=64)
TM = 70  # frames: dilation 32's outer taps (±64 rows) reach real rows
# fp32 on both sides: the mask to 2e-5, gradients within 1e-4 of the
# model's largest, running statistics to 1e-5, as the narrow model's tests
# hold them (tests/test_torch_conv_cuda.py, tests/test_torch_chain_model.py)
MASK_ATOL, GRAD_REL, STAT_ATOL = 2e-5, 1e-4, 1e-5
# conv routes of the train-mode tests here; the fused chain's, the slowest
# in interpret mode, are in tests/test_torch_wide_chain.py
ROUTES = ("library", "pallas_conv")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _model_inputs(seed):
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0, 1, (2, TM, DIMS["num_freq"])).astype(np.float32)
    emb = rng.standard_normal((2, DIMS["emb_dim"])).astype(np.float32)
    cot = rng.standard_normal((2, TM, DIMS["num_freq"])).astype(np.float32)
    return spec, emb, cot


def _route_on(route, monkeypatch):
    """The conv route in both packages: the port's switches by environment,
    the JAX package's (TPU-only) by patching their functions."""
    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "1" if route == "fused_chain" else "0")
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1" if route == "pallas_conv" else "0")
    if route == "fused_chain":
        monkeypatch.setattr(jcf, "fused_chain_enabled", lambda: True)
    elif route == "pallas_conv":
        monkeypatch.setattr(jcp, "pallas_conv_available", lambda: True)
        monkeypatch.setenv("VOICESPLIT_CONV_TILES", "16,64")  # small tiles: cheap interpret mode


def _count_calls(monkeypatch, module, names):
    """Calls of `module`'s wrappers `names` while the model runs."""
    counts = {name: 0 for name in names}
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name):
            counts[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(module, name, counted)
    return counts


def _port_grads(port, spec, emb, cot):
    port.zero_grad()
    (port(torch.from_numpy(spec), torch.from_numpy(emb)) * torch.from_numpy(cot)).sum().backward()
    return {k: p.grad.numpy().copy() for k, p in port.named_parameters()}


def _assert_grads_close(got, want, rel):
    """Per parameter, within `rel` of the model's largest gradient; the conv
    biases under a train-mode BatchNorm hold only round-off."""
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=rel * scale, rtol=0, err_msg=k)


def _models(n, activation="mish"):
    port = MaskNet(activation=activation, num_extra_dilated_blocks=n, **DIMS)
    params, stats = weights.random_jax_variables(port, seed=n)
    port.load_state_dict(weights.state_dict_from_jax(params, stats))
    jm = JaxMaskNet(activation=activation, num_extra_dilated_blocks=n, **DIMS)
    return port, jm, params, stats


@pytest.mark.parametrize("n", [1, 2])
def test_extra_blocks_follow_the_jax_layout(n):
    """Blocks conv8 … conv(7+n) at time dilation 32·2^i, the projection last,
    and the same parameter and statistic names and shapes as the JAX
    model's variables, carried both ways by `weights.py`."""
    port, jm, params, stats = _models(n)
    assert port.block_names == [f"conv{i}" for i in range(1, 9 + n)]
    for i in range(n):
        block = getattr(port, f"conv{8 + i}")
        assert tuple(block.conv.kernel_size) == (5, 5)
        assert tuple(block.conv.dilation) == (32 * 2 ** i, 1)
        assert tuple(block.conv.padding) == (64 * 2 ** i, 2)
    assert getattr(port, f"conv{8 + n}").conv.out_channels == DIMS.get("conv_out_channels", 8)
    spec, emb, _ = _model_inputs(0)
    jvars = jm.init(jax.random.PRNGKey(0), jnp.asarray(spec[:1]), jnp.asarray(emb[:1]))
    want = weights.state_dict_from_jax(jvars["params"], jvars["batch_stats"])
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("n", [1, 2])
def test_wide_masknet_eval_matches_jax(n):
    """Eval mode (running statistics), library convs in both packages: the
    mask (fp32)."""
    port, jm, params, stats = _models(n)
    spec, emb, _ = _model_inputs(10 + n)
    mask_j = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(spec), jnp.asarray(emb))
    with torch.no_grad():
        mask = port.eval()(torch.from_numpy(spec), torch.from_numpy(emb))
    np.testing.assert_allclose(mask.numpy(), _np(mask_j), atol=MASK_ATOL)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("route", ROUTES)
def test_wide_masknet_train_matches_jax_on_each_conv_route(route, n, monkeypatch):
    """Train mode, the library conv and the dilated switch: see
    `check_train_route`."""
    check_train_route(route, n, monkeypatch)


def check_train_route(route, n, monkeypatch):
    """Train mode, the same conv route in both packages: mask, every running
    statistic and every gradient (fp32).  On the fused chain the extra
    blocks are chain layers (seven at n = 1), on the dilated switch kernel
    layers (each forward, data gradient and weight gradient counted)."""
    port, jm, params, stats = _models(n)
    port.train()
    spec, emb, cot = _model_inputs(20 + n)
    _route_on(route, monkeypatch)

    def loss(p):
        mask, upd = jm.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(spec), jnp.asarray(emb),
            train=True, mutable=["batch_stats"],
        )
        return jnp.sum(mask * cot), (mask, upd["batch_stats"])

    (_, (mask_j, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)

    assert port._use_fused_chain() == (route == "fused_chain")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        mask = port(torch.from_numpy(spec), torch.from_numpy(emb))
        port.load_state_dict(before)
    np.testing.assert_allclose(mask.numpy(), _np(mask_j), atol=MASK_ATOL)
    dilated = _count_calls(monkeypatch, cc, ("conv_dilated_fwd", "conv_dilated_wgrad"))
    chain = _count_calls(monkeypatch, cf, ("conv_bn_act_fwd", "conv_dgrad", "conv_wgrad"))
    got = _port_grads(port, spec, emb, cot)
    layers = 6 + n  # conv2 … conv7 and the extra blocks
    want_dilated = {"conv_dilated_fwd": 2 * layers, "conv_dilated_wgrad": layers}
    assert dilated == (want_dilated if route == "pallas_conv" else dict.fromkeys(want_dilated, 0))
    want_chain = dict.fromkeys(chain, layers if route == "fused_chain" else 0)
    assert chain == want_chain
    want = {k: v.numpy() for k, v in weights.params_from_jax(jax.device_get(grads)).items()}
    _assert_grads_close(got, want, GRAD_REL)
    want_sd = weights.state_dict_from_jax(params, jax.device_get(new_stats))
    for k, v in port.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=STAT_ATOL, err_msg=k)
            assert not torch.equal(v, before[k]), k


HOP, FRAMES = 32, 72
L = HOP * FRAMES
LR = 1e-3


def _config_text():
    """`configs/voicesplit_wide.json` cut to test size: its extra dilated
    block, 64 channels, fp32; a short STFT of 65 frequencies and 73 frames
    and a narrow LSTM."""
    d = json.loads((REPO / "configs" / "voicesplit_wide.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=HOP, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = L / 16000
    d["model"].update(lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=16)
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


def test_wide_config_builds_the_wide_model():
    """`make_masknet` takes the wide config (it raised before): lstm_dim 800,
    one extra block at time dilation 32, the projection as conv9."""
    model = make_masknet(load_config(str(REPO / "configs" / "voicesplit_wide.json")), device="cpu")
    assert model.lstm.hidden == 800
    assert model.block_names[-2:] == ["conv8", "conv9"]
    assert tuple(model.conv8.conv.dilation) == (32, 1) and model.conv9.conv.kernel_size == (1, 1)


def test_wide_train_step_matches_jax():
    """One `make_train_step` step of each package on the wide config cut to
    test size, from the same weights and batch (fp32, si_snr, Adam), as
    `tests/test_torch_train.py` compares the narrow one: loss and grad_norm
    to summation order, running statistics to 1e-5, every weight within
    2·lr, the gradients (read from Adam's first moment, 0.1·g) within 5e-3
    of the model's largest."""
    text = _config_text()
    jc, tc = jax_config(text), load_config_from_str(text)
    model = make_masknet(tc, device="cpu")
    assert model.block_names[-2:] == ["conv8", "conv9"]
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
    jstep = jax_steps.make_train_step(jc, jax_make_masknet(jc), jax_audio_processor(jc), tx, donate=False)
    jstate, jm = jstep(jstate, batch)
    m = make_train_step(tc, model, ap, optimizer)(state, batch)

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


# The LSTM backward at H = 800: a short walk, both operand types
H_WIDE, T_WIDE = 800, 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_bwd_ref_matches_pallas_bwd_at_wide_hidden(dtype):
    """One direction at the wide config's training batch (B=2)."""
    B, H = 2, H_WIDE
    rng = np.random.default_rng(800)
    xp_j, _ = _cast(_arr(rng, (T_WIDE, B, 4 * H)), dtype)
    w_j, w_t = _cast(_arr(rng, (H, 4 * H), H ** -0.5), dtype)
    h0, c0, dhf, dcf = (_arr(rng, (B, H)) for _ in range(4))
    dhs = _arr(rng, (T_WIDE, B, H))
    hs, cs, gates = lstm_pallas._fwd(xp_j, w_j, jnp.asarray(h0), jnp.asarray(c0))
    want = lstm_pallas._bwd(
        w_j, gates, _shifted(jnp.asarray(c0), cs), _shifted(jnp.asarray(h0), hs),
        jnp.asarray(dhs), jnp.asarray(dhf), jnp.asarray(dcf), dxp_dtype=jnp.dtype(dtype),
    )
    got = lstm_cuda.lstm_bwd_ref(
        w_t, _t32(gates), _t32(cs), _t32(hs), *map(torch.from_numpy, (h0, c0, dhs, dhf, dcf)),
        getattr(torch, dtype),
    )
    for name, a, b in zip(("dxp", "dwhh", "dh0", "dc0"), got, want):
        _close(a, b, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_bwd_ref_matches_pallas_bwd2_at_wide_hidden(dtype):
    """Both directions at eight rows each (the two-direction kernel's batch)."""
    B, H = 8, H_WIDE
    rng = np.random.default_rng(801)
    xp_j, _ = _cast(_arr(rng, (T_WIDE, 2 * B, 4 * H)), dtype)
    wf_j, wf_t = _cast(_arr(rng, (H, 4 * H), H ** -0.5), dtype)
    wb_j, wb_t = _cast(_arr(rng, (H, 4 * H), H ** -0.5), dtype)
    dhs = _arr(rng, (T_WIDE, 2 * B, H))
    zeros = jnp.zeros((2 * B, H), jnp.float32)
    hs, cs, gates = lstm_pallas._fwd2(xp_j, wf_j, wb_j, zeros, zeros)
    want = lstm_pallas._bwd2(
        wf_j, wb_j, gates, _shifted(zeros, cs), _shifted(zeros, hs), jnp.asarray(dhs),
        dxp_dtype=jnp.dtype(dtype),
    )
    got = lstm_cuda.bilstm_bwd_ref(
        wf_t, wb_t, _t32(gates), _t32(cs), _t32(hs), torch.from_numpy(dhs), getattr(torch, dtype)
    )
    for name, a, b in zip(("dxp", "dwhh_f", "dwhh_b"), got, want):
        _close(a, b, dtype, name)
