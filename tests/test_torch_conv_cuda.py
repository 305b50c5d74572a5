"""The port's dilated conv (`voicesplit_tpu_torch/ops/conv_cuda.py`) against
the JAX package's (`voicesplit_tpu/ops/conv_pallas.py`).

On the CPU the port's wrappers run their plain versions and the JAX side
runs its Pallas kernels in interpret mode, called directly as
`tests/test_pallas_conv.py` calls them (the JAX package never takes this
path by itself off a TPU).  For the whole model the JAX switch function is
patched to True, which both `ConvBlock.setup` and `conv_dispatch` look up
when they are called.  Small tiles (`VOICESPLIT_CONV_TILES`) keep interpret
mode cheap at the small F.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import voicesplit_tpu.ops.conv_pallas as jcp
from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.models.masknet import MaskNet as JaxMaskNet
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.train import state as jax_state
from voicesplit_tpu.train import steps as jax_steps
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli.separate import separate_batch
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import MaskNet, make_masknet
from voicesplit_tpu_torch.ops import conv_cuda as cc
from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
B, T, F, C = 2, 37, 37, 64
# each layer kind of conv2 … conv7
SPECS = {"7x1": ((7, 1), 1), "5x5-d1": ((5, 5), 1), "5x5-d2": ((5, 5), 2), "5x5-d4": ((5, 5), 4),
         "5x5-d8": ((5, 5), 8), "5x5-d16": ((5, 5), 16)}
# fp32, both sides: the same products summed in another order; relative to
# each output's peak
PEAK_TOL = 1e-4
# bf16: both sides round each frequency tap's partial sum to bf16 and add the
# partial sums in bf16; a sum taken in another order can flip one of those
# roundings (one bf16 ulp is at most 2^-7 = 7.8e-3 of the peak)
PEAK_TOL_BF16 = 1e-2


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


def _inputs(seed, kt, kf, cin=C, cout=C):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F, cin)).astype(np.float32)
    dy = rng.standard_normal((B, T, F, cout)).astype(np.float32)
    w = ((kt * kf * cin) ** -0.5 * rng.standard_normal((kt, kf, cin, cout))).astype(np.float32)
    return x, dy, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_forward_plain_version_matches_pallas_kernel(spec, dtype):
    (kt, kf), dt = SPECS[spec]
    x, _, w = _inputs(1, kt, kf)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jcp.conv2d_pallas(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd), (dt, 1))
    got = cc.conv_dilated_fwd(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), dt)
    assert got.shape == (B, T, F, C) and got.dtype == td and got.is_contiguous()
    _assert_peak_close(got.float().numpy(), _np(want), PEAK_TOL if dtype == "float32" else PEAK_TOL_BF16)


def test_forward_plain_version_keeps_the_pallas_rounding():
    """bf16, (5,5): the plain version is closer to the Pallas kernel than the
    same sums rounded once are: it rounds per frequency tap as the kernel
    does."""
    (kt, kf), dt = SPECS["5x5-d1"]
    x, _, w = _inputs(2, kt, kf)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    want = _np(jcp.conv2d_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                                 jnp.asarray(w).astype(jnp.bfloat16), (dt, 1)))
    got = cc.conv_dilated_fwd_ref(xb, wb, dt).float().numpy()
    once = cc.conv_dilated_fwd_round_once_ref(xb, wb, dt).float().numpy()
    assert (got != want).mean() < 0.25 * (once != want).mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", ["5x5-d1", "5x5-d16"])
def test_round_once_plain_version_rounds_the_pallas_sum_once(spec, dtype):
    """The plain version with the CUDA kernel's rounding against the Pallas
    kernel's fp32 conv of the same (type-rounded) operands: fp32 up to
    summation order (PEAK_TOL); bf16 one rounding of each output, at most
    2^-9 of its magnitude, so 2^-8 of the peak leaves room for the order."""
    (kt, kf), dt = SPECS[spec]
    x, _, w = _inputs(3, kt, kf)
    td = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(td), torch.from_numpy(w).to(td)
    want = _np(jcp.conv2d_pallas(jnp.asarray(xt.float().numpy()), jnp.asarray(wt.float().numpy()),
                                 (dt, 1)))
    got = cc.conv_dilated_fwd_round_once_ref(xt, wt, dt)
    assert got.shape == (B, T, F, C) and got.dtype == td and got.is_contiguous()
    _assert_peak_close(got.float().numpy(), want, PEAK_TOL if dtype == "float32" else 2.0 ** -8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_wgrad_plain_version_matches_pallas_kernel(spec, dtype):
    (kt, kf), dt = SPECS[spec]
    x, dy, _ = _inputs(3, kt, kf)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jcp._conv_wgrad_core(jnp.asarray(x).astype(jd), jnp.asarray(dy).astype(jd),
                                (kt, kf), (dt, 1))
    got = cc.conv_dilated_wgrad(torch.from_numpy(x).to(td), torch.from_numpy(dy).to(td), kt, kf, dt)
    assert got.shape == (kt, kf, C, C) and got.dtype == torch.float32
    # exact products of the (rounded) operands, fp32 sums, in both types
    _assert_peak_close(got.numpy(), _np(want), PEAK_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_matches_jax_grad_of_conv2d_pallas(dtype):
    """Both gradients of ``Σ conv(x, w)·cot`` ((5,5), dilation 4).  In bf16
    dW is rounded to bf16 on both sides (`_vjp_bwd` casts it to the weights'
    type)."""
    (kt, kf), dt = SPECS["5x5-d4"]
    x, cot, w = _inputs(4, kt, kf)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    cot_j = jnp.asarray(cot).astype(jd)

    def loss(xj, wj):
        return jnp.sum((jcp.conv2d_pallas(xj, wj, (dt, 1)) * cot_j).astype(jnp.float32))

    gx, gw = jax.grad(loss, (0, 1))(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    wt = torch.from_numpy(w).to(td).requires_grad_()
    (cc.conv2d_dilated(xt, wt, (dt, 1)) * torch.from_numpy(cot).to(td)).float().sum().backward()
    assert xt.grad.dtype == td and wt.grad.dtype == td
    tol = PEAK_TOL if dtype == "float32" else PEAK_TOL_BF16
    _assert_peak_close(xt.grad.float().numpy(), _np(gx), tol, "dx")
    _assert_peak_close(wt.grad.float().numpy(), _np(gw), tol, "dw")


def test_flipped_weights_give_the_data_gradient():
    """`conv_dilated_fwd` with `flip_weight` is autograd's gradient of the
    library conv with respect to its input (fp32, dilated), and
    `conv_dilated_wgrad` its weight gradient."""
    (kt, kf), dt = SPECS["5x5-d4"]
    x, cot, w = _inputs(5, kt, kf)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = torch.nn.functional.conv2d(
        xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), padding=(2 * dt, 2), dilation=(dt, 1)
    ).permute(0, 2, 3, 1)
    (out * torch.from_numpy(cot)).sum().backward()
    dx = cc.conv_dilated_fwd(torch.from_numpy(cot), cc.flip_weight(wt.detach()), dt)
    dw = cc.conv_dilated_wgrad(torch.from_numpy(x), torch.from_numpy(cot), kt, kf, dt)
    _assert_peak_close(dx.numpy(), xt.grad.numpy(), 1e-5)
    _assert_peak_close(dw.numpy(), wt.grad.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

ROUTES = {
    # name: (weight shape, dilation, goes to the kernels when the switch is on)
    "heavy-5x5": ((5, 5, 64, 64), (2, 1), True),
    "heavy-7x1": ((7, 1, 64, 64), (1, 1), True),
    "wide": ((5, 5, 128, 64), (1, 1), True),
    "input-1x7": ((1, 7, 1, 64), (1, 1), False),
    "projection-1x1": ((1, 1, 64, 8), (1, 1), False),
    "pointwise-64": ((1, 1, 64, 64), (1, 1), False),
    "narrow": ((5, 5, 8, 8), (1, 1), False),
    "freq-dilated": ((5, 5, 64, 64), (1, 2), False),
}


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_takes_layer_routes_as_the_jax_package(route, on, monkeypatch):
    """The conditions of `conv_pallas.conv_dispatch`.  A layer that meets
    them goes through `conv2d_dilated` and gives the library's "same" conv
    plus bias (fp32), which is also what the JAX dispatch gives."""
    w_shape, dilation, heavy = ROUTES[route]
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1" if on else "0")
    assert cc.pallas_conv_enabled() == on
    assert cc.takes_layer(w_shape, dilation) == (on and heavy)
    if not heavy:
        return
    calls = []
    apply = cc._Conv2dDilated.apply
    monkeypatch.setattr(cc._Conv2dDilated, "apply", lambda *a: calls.append(1) or apply(*a))
    kt, kf, cin, cout = w_shape
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 9, 11, cin)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal(w_shape)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    got = cc.conv2d_dilated_bias(x, w, b, dilation)
    assert len(calls) == 1
    pad = ((kt - 1) * dilation[0] // 2, (kf - 1) * dilation[1] // 2)
    want = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=pad, dilation=dilation
    ).permute(0, 2, 3, 1)
    _assert_peak_close(got.numpy(), want.numpy(), 1e-5)
    # and the JAX dispatch gives the same numbers (there through XLA off a TPU)
    jgot = jcp.conv_dispatch(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
                             dilation)
    _assert_peak_close(got.numpy(), _np(jgot), 1e-5)


def test_bias_gradient_is_summed_in_fp32(monkeypatch):
    """bf16: the bias gradient is the fp32 sum of the bf16 cotangent, not a
    bf16 sum."""
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 9, 33, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((0.05 * rng.standard_normal((5, 5, 64, 64))).astype(np.float32))
    b = torch.zeros(64, requires_grad=True)
    cot = torch.from_numpy(rng.standard_normal((2, 9, 33, 64)).astype(np.float32)).bfloat16()
    (cc.conv2d_dilated_bias(x, w, b, (1, 1)) * cot).float().sum().backward()
    assert b.grad.dtype == torch.float32
    np.testing.assert_allclose(b.grad.numpy(), cot.float().sum(dim=(0, 1, 2)).numpy(), rtol=1e-6)


def test_wrappers_check_their_arguments():
    x = torch.zeros(B, 5, 7, C)
    w = torch.zeros(5, 5, C, C)
    with pytest.raises(ValueError, match="odd"):
        cc.conv_dilated_fwd(x, torch.zeros(4, 5, C, C), 1)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        cc.conv_dilated_fwd(x.half(), w.half(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        cc.conv_dilated_fwd(x.transpose(1, 2), w, 1)
    with pytest.raises(ValueError, match="weights must be"):
        cc.conv_dilated_fwd(x, w.bfloat16(), 1)
    with pytest.raises(ValueError, match="weights must be"):
        cc.conv_dilated_fwd(x, torch.zeros(5, 5, 32, C), 1)
    with pytest.raises(ValueError, match="cotangent must be"):
        cc.conv_dilated_wgrad(x, torch.zeros(B, 5, 8, C), 5, 5, 1)
    with pytest.raises(ValueError, match="dilation"):
        cc.conv_dilated_wgrad(x, x, 5, 5, 0)
    with pytest.raises(ValueError, match="frequency dilation"):
        cc.conv2d_dilated(x, w, (1, 2))
    # what the CUDA kernels do not take raises on the card, it never goes to
    # the library: the check the launches make first.  Every channel count
    # that `takes_layer` sends (64 or more, in and out apart) is taken
    for cin, cout in ((128, 64), (64, 128), (96, 96), (100, 192)):
        cc._check_kernel_takes(cin, cout, 5, 5, wgrad=False)
        cc._check_kernel_takes(cin, cout, 5, 5, wgrad=True)
    with pytest.raises(NotImplementedError, match="at least 64 channels"):
        cc._check_kernel_takes(32, 64, 5, 5, wgrad=False)
    with pytest.raises(NotImplementedError, match="taps"):
        cc._check_kernel_takes(64, 64, 5, 7, wgrad=True)
    # the forward kernel: kf in (1, 3, 5); five time taps at kf = 5 (its ring
    # of input rows and two weight buffers fill a block's shared memory)
    for kt, kf in ((5, 7), (7, 5), (3, 2)):
        with pytest.raises(NotImplementedError, match="taps"):
            cc._check_kernel_takes(64, 64, kt, kf, wgrad=False)
    for kt, kf in ((7, 1), (7, 3), (5, 5), (1, 5)):
        cc._check_kernel_takes(64, 64, kt, kf, wgrad=False)


# ---------------------------------------------------------------------------
# The model and the train step with the switch on
# ---------------------------------------------------------------------------

DIMS = dict(num_freq=37, emb_dim=16, lstm_dim=24, fc1_dim=20, fc2_dim=37, conv_channels=64)
TM = 11


def _port_on(monkeypatch, on=True):
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1" if on else "0")


def _jax_on(monkeypatch):
    monkeypatch.setattr(jcp, "pallas_conv_available", lambda: True)


def _model_inputs(seed):
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0, 1, (2, TM, DIMS["num_freq"])).astype(np.float32)
    emb = rng.standard_normal((2, DIMS["emb_dim"])).astype(np.float32)
    cot = rng.standard_normal((2, TM, DIMS["num_freq"])).astype(np.float32)
    return spec, emb, cot


def _count_kernel_calls(monkeypatch):
    """Counts of the three wrappers while the model runs."""
    counts = {"conv_dilated_fwd": 0, "conv_dilated_wgrad": 0, "conv_bn_act_eval": 0}
    for name in counts:
        fn = getattr(cc, name)

        def counted(*a, _fn=fn, _name=name):
            counts[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(cc, name, counted)
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


@pytest.mark.parametrize("activation", ["mish", "relu"])
def test_masknet_eval_matches_jax_on_the_same_path(activation, monkeypatch):
    """Eval-mode `MaskNet`, switch on in both packages: six kernel-path
    eval-mode blocks (conv, bias, BatchNorm, activation in one call) per
    call, the JAX model's mask (fp32)."""
    port = MaskNet(activation=activation, **DIMS).eval()
    params, stats = weights.random_jax_variables(port, seed=1)
    port.load_state_dict(weights.state_dict_from_jax(params, stats))
    spec, emb, _ = _model_inputs(2)
    _jax_on(monkeypatch)
    mask_j = JaxMaskNet(activation=activation, **DIMS).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(spec), jnp.asarray(emb))
    _port_on(monkeypatch)
    counts = _count_kernel_calls(monkeypatch)
    with torch.no_grad():
        mask = port(torch.from_numpy(spec), torch.from_numpy(emb))
    assert counts == {"conv_dilated_fwd": 0, "conv_dilated_wgrad": 0, "conv_bn_act_eval": 6}
    np.testing.assert_allclose(mask.numpy(), _np(mask_j), atol=2e-5)


@pytest.mark.parametrize("activation", ["mish", "relu"])
def test_masknet_train_matches_jax_on_the_same_path(activation, monkeypatch):
    """Train-mode `MaskNet`, switch on in both packages: mask, every running
    statistic and every gradient (fp32); 12 forward-kernel and 6
    weight-gradient calls.  The inputs' seed keeps every pre-activation away
    from relu's kink."""
    port = MaskNet(activation=activation, **DIMS).train()
    params, stats = weights.random_jax_variables(port, seed=1)
    port.load_state_dict(weights.state_dict_from_jax(params, stats))
    spec, emb, cot = _model_inputs(5)
    jm = JaxMaskNet(activation=activation, **DIMS)
    _jax_on(monkeypatch)

    def loss(p):
        mask, upd = jm.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(spec), jnp.asarray(emb),
            train=True, mutable=["batch_stats"],
        )
        return jnp.sum(mask * cot), (mask, upd["batch_stats"])

    (_, (mask_j, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)

    _port_on(monkeypatch)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        mask = port(torch.from_numpy(spec), torch.from_numpy(emb))
        port.load_state_dict(before)
    np.testing.assert_allclose(mask.numpy(), _np(mask_j), atol=2e-5)
    counts = _count_kernel_calls(monkeypatch)
    got = _port_grads(port, spec, emb, cot)
    assert counts == {"conv_dilated_fwd": 12, "conv_dilated_wgrad": 6, "conv_bn_act_eval": 0}
    want = {k: v.numpy() for k, v in weights.params_from_jax(jax.device_get(grads)).items()}
    _assert_grads_close(got, want, 1e-4)
    want_sd = weights.state_dict_from_jax(params, jax.device_get(new_stats))
    for k, v in port.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-5, err_msg=k)
            assert not torch.equal(v, before[k]), k


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masknet_switch_on_matches_switch_off(mode, dtype, monkeypatch):
    """The port against itself with the switch off (the library conv): mask,
    and in train mode gradients and running statistics.  fp32: sums in
    another order.  bf16: the plain version rounds each frequency tap's
    partial sum where the library rounds once, through six layers; gradients
    by size and direction."""
    port = MaskNet(activation="mish", compute_dtype=getattr(torch, dtype), **DIMS)
    getattr(port, mode)()
    weights.init_random_(port, seed=3)
    spec, emb, cot = _model_inputs(4)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    out = {}
    for on in (False, True):
        port.load_state_dict(before)
        _port_on(monkeypatch, on)
        grads = _port_grads(port, spec, emb, cot)
        stats = {k: v.numpy().copy() for k, v in port.state_dict().items()}
        with torch.no_grad():
            port.load_state_dict(before)
            mask = port(torch.from_numpy(spec), torch.from_numpy(emb)).numpy()
        out[on] = (mask, grads, stats)
    fp32 = dtype == "float32"
    np.testing.assert_allclose(out[True][0], out[False][0], atol=2e-5 if fp32 else 2e-2)
    for k, v in out[False][2].items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(out[True][2][k], v, atol=1e-5 if fp32 else 2e-2, err_msg=k)
    if fp32:
        _assert_grads_close(out[True][1], out[False][1], 1e-4)
    else:
        skip = "conv.bias" if mode == "train" else "\0"
        signal = {k: v for k, v in out[False][1].items() if not k.endswith(skip)}
        _assert_grads_close(out[True][1], signal, 0.2)
        for k, want in signal.items():
            got = out[True][1][k].ravel()
            cos = got @ want.ravel() / (np.linalg.norm(got) * np.linalg.norm(want))
            assert cos >= (0.6 if k.startswith("conv") else 0.98), (k, cos)


def test_both_switches_raise_in_train_mode(monkeypatch):
    """The JAX model cannot run the fused chain and the Pallas conv at once;
    the port says so.  Eval mode never takes the chain, so it runs."""
    _port_on(monkeypatch)
    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "1")
    port = weights.init_random_(MaskNet(activation="mish", **DIMS), seed=0)
    spec, emb, _ = _model_inputs(0)
    with pytest.raises(ValueError, match="both set"):
        port.train()(torch.from_numpy(spec), torch.from_numpy(emb))
    with torch.no_grad():
        mask = port.eval()(torch.from_numpy(spec), torch.from_numpy(emb))
    assert mask.shape == (2, TM, DIMS["num_freq"])
    # a model too narrow for the chain (and for the kernels) is no conflict
    narrow = MaskNet(activation="mish", **{**DIMS, "conv_channels": 8}).train()
    narrow(torch.from_numpy(spec), torch.from_numpy(emb))


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


def test_train_step_with_the_switch_matches_jax(monkeypatch):
    """One `make_train_step` step of each package with the switch on, from
    the same weights and batch (fp32, si_snr, Adam), as
    `tests/test_torch_train.py` compares them with it off: loss and
    grad_norm to summation order, running statistics to 1e-5, the gradients
    (read from Adam's first moment, 0.1·g) within 5e-3 of the model's
    largest, every weight within 2·lr."""
    text = _config_text()
    jc, tc = jax_config(text), load_config_from_str(text)
    model = make_masknet(tc, device="cpu")
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

    _jax_on(monkeypatch)
    jstep = jax_steps.make_train_step(jc, jax_make_masknet(jc), jax_audio_processor(jc), tx, donate=False)
    jstate, jm = jstep(jstate, batch)

    _port_on(monkeypatch)
    counts = _count_kernel_calls(monkeypatch)
    m = make_train_step(tc, model, ap, optimizer)(state, batch)
    assert counts == {"conv_dilated_fwd": 12, "conv_dilated_wgrad": 6, "conv_bn_act_eval": 0}

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


def test_serving_takes_the_kernel_path_with_the_switch(monkeypatch):
    """`separate_batch` (eval mode, inference mode): six kernel-path
    eval-mode blocks per call with the switch on and no other dilated-conv
    call, none with it off, the same waveform (fp32)."""
    tc = load_config_from_str(_config_text())
    model = weights.init_random_(make_masknet(tc, device="cpu"), 1)
    ap = make_audio_processor(tc, device="cpu")
    batch = _batch(2, seed=2)
    counts = _count_kernel_calls(monkeypatch)
    out = {}
    for on in (False, True):
        _port_on(monkeypatch, on)
        out[on] = separate_batch(model, ap, batch["mixed_wav"], batch["emb"])
        assert counts == {"conv_dilated_fwd": 0, "conv_dilated_wgrad": 0, "conv_bn_act_eval": 6 if on else 0}
    _assert_peak_close(out[True].numpy(), out[False].numpy(), 1e-4)
