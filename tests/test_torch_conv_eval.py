"""The eval-mode conv block `conv_cuda.conv_bn_act_eval`: conv, bias,
BatchNorm with the running statistics and the activation of one kernel
layer in one call (one launch on the card, the forward kernel's eval mode).

On the CPU: its plain version is the composition the model computed before
it (`conv2d_dilated_bias`, then `bn_act.bn_act_eval`) bit for bit; the plain
version with the kernel's rounding agrees with it; its backward gives the
composition's gradients bit for bit; the model takes it for every kernel layer
in eval mode and never in train mode.  On the card (``-m gpu``): the kernel
against `conv_bn_act_eval_round_once_ref` on every route that `takes_layer`
sends a layer to (C = 64 bf16 at the model's shapes, the wide tiles, the
fp32 slab route), the edges of time and frequency on their own, the same
bits twice, and the eval model with the dilated switch against the switch-off
model.  On the card: ``python -m pytest tests/test_torch_conv_eval.py -m gpu``.
"""

import pathlib

import numpy as np
import pytest
import torch

from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.models.masknet import MaskNet
from voicesplit_tpu_torch.ops import bn_act
from voicesplit_tpu_torch.ops import conv_cuda as cc

REPO = pathlib.Path(__file__).resolve().parents[1]
LAYERS = {"7x1": ((7, 1), 1), "5x5-d1": ((5, 5), 1), "5x5-d2": ((5, 5), 2), "5x5-d4": ((5, 5), 4),
          "5x5-d8": ((5, 5), 8), "5x5-d16": ((5, 5), 16), "5x5-d32": ((5, 5), 32)}
EPS = 1e-5


def _inputs(shape, layer, dtype, cout=None, seed=0, device="cpu"):
    """Activations ``[B, T, F, Cin]``, weights, and the layer's fp32 vectors
    (conv bias, BatchNorm scale and shift, running mean and variance)."""
    (kt, kf), dt = LAYERS[layer]
    cin = shape[-1]
    cout = cin if cout is None else cout
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(device, dtype)
    w = (torch.randn(kt, kf, cin, cout, generator=g) * (kt * kf * cin) ** -0.5).to(device, dtype)
    vecs = (0.1 * torch.randn(cout, generator=g), torch.rand(cout, generator=g) + 0.5,
            0.1 * torch.randn(cout, generator=g), 0.2 * torch.randn(cout, generator=g),
            torch.rand(cout, generator=g) + 0.5)
    return x, w, tuple(v.to(device) for v in vecs), dt


def _composition(x, w, vecs, act, dt):
    """What an eval-mode kernel layer computed before the eval block."""
    b, scale, beta, mean, var = vecs
    y = cc.conv2d_dilated_bias(x, w, b, (dt, 1))
    return bn_act.bn_act_eval(y.permute(0, 3, 1, 2), scale, beta, mean, var, act, EPS).permute(0, 2, 3, 1)


def _peak_rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["mish", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", ["7x1", "5x5-d2", "5x5-d16"])
def test_plain_version_is_the_composition_bit_for_bit(layer, dtype, act):
    """The operator's plain version (the CPU path) gives the bits of the
    composition it replaces: the model's CPU results do not move."""
    x, w, vecs, dt = _inputs((2, 13, 37, 64), layer, getattr(torch, dtype))
    got = cc.conv_bn_act_eval(x, w, *vecs, act, EPS, dt)
    assert got.shape == (2, 13, 37, 64) and got.is_contiguous()
    assert torch.equal(got, _composition(x, w, vecs, act, dt))


@pytest.mark.parametrize("act", ["mish", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_once_version_agrees_with_the_plain_version(dtype, act):
    """The kernel's arithmetic (everything in fp32, one rounding) against
    the composition (bf16: the conv's per-tap roundings and a rounding after
    each eager op, several bf16 ulps of an output; fp32: summation order,
    1 / sqrt against rsqrt and mish's one-exponential form)."""
    x, w, vecs, dt = _inputs((2, 13, 37, 96), "5x5-d4", getattr(torch, dtype), cout=64, seed=1)
    once = cc.conv_bn_act_eval_round_once_ref(x, w, *vecs, EPS, act, dt)
    plain = cc.conv_bn_act_eval_ref(x, w, *vecs, EPS, act, dt)
    assert once.dtype == plain.dtype and once.shape == plain.shape == (2, 13, 37, 64)
    assert _peak_rel(once, plain) <= (1e-5 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("act", ["mish", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_gives_the_compositions_gradients(dtype, act):
    """An eval-mode forward that is differentiated: the operator's backward
    against autograd through the composition, for the input, the weights,
    the conv bias and the BatchNorm parameters, bit for bit (the backward
    is autograd through the composition recomputed)."""
    x, w, vecs, dt = _inputs((2, 13, 37, 64), "5x5-d2", getattr(torch, dtype), seed=2)
    cot = torch.randn(2, 13, 37, 64, generator=torch.Generator().manual_seed(3)).to(x.dtype)
    grads = []
    for fn in (lambda *a: cc.conv_bn_act_eval(*a[:5], *vecs[3:], act, EPS, dt),
               lambda *a: _composition(a[0], a[1], (*a[2:5], *vecs[3:]), act, dt)):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, *vecs[:3])]
        (fn(*leaves).float() * cot.float()).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, got, want in zip(("x", "w", "bias", "scale", "beta"), *grads):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got, want), name


DIMS = dict(num_freq=37, emb_dim=16, lstm_dim=24, fc1_dim=20, fc2_dim=37)


@pytest.mark.parametrize("channels", [64, 96])
def test_the_model_takes_the_eval_block_in_eval_mode_only(channels, monkeypatch):
    """With the dilated switch an eval-mode forward calls `conv_bn_act_eval`
    once for each of conv2 … conv7 and the train-mode conv path never; a
    train-mode forward and backward the reverse (6 forward, 6 data-gradient
    and 6 weight-gradient calls)."""
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1")
    calls = {"conv_bn_act_eval": 0, "conv_dilated_fwd": 0, "conv_dilated_wgrad": 0}
    for name in calls:
        fn = getattr(cc, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(cc, name, counted)
    model = weights.init_random_(MaskNet(activation="mish", conv_channels=channels, **DIMS), seed=0)
    spec, emb = torch.rand(2, 11, 37), torch.randn(2, 16)
    with torch.no_grad():
        model.eval()(spec, emb)
    assert calls == {"conv_bn_act_eval": 6, "conv_dilated_fwd": 0, "conv_dilated_wgrad": 0}
    calls.update(dict.fromkeys(calls, 0))
    model.train()(spec, emb).sum().backward()
    assert calls == {"conv_bn_act_eval": 0, "conv_dilated_fwd": 12, "conv_dilated_wgrad": 6}


def test_weights_are_cast_and_laid_out_in_one_copy(monkeypatch):
    """The block hands the kernel ``[kt, kf, Cin, Cout]`` weights in the
    operand type, contiguous, made by one copy of the OIHW parameter's
    permuted view (bf16: the cast; fp32: the layout)."""
    seen = []
    real = cc.conv_bn_act_eval
    monkeypatch.setattr(cc, "conv_bn_act_eval", lambda x, w, *a: seen.append(w) or real(x, w, *a))
    for dtype in (torch.bfloat16, torch.float32):
        conv = torch.nn.Conv2d(64, 64, (5, 5))
        bn = torch.nn.Module()
        bn.scale, bn.bias, bn.mean, bn.var, bn.epsilon = (torch.ones(64), torch.zeros(64), torch.zeros(64),
                                                         torch.ones(64), EPS)
        x = torch.randn(1, 9, 11, 64).to(dtype)
        cc.conv2d_bn_act_eval(x, conv.weight.permute(2, 3, 1, 0), conv.bias, bn, "relu", (2, 1))
        w = seen.pop()
        assert w.dtype == dtype and w.is_contiguous() and w.shape == (5, 5, 64, 64)
        assert w.data_ptr() != conv.weight.data_ptr()
        assert torch.equal(w, conv.weight.permute(2, 3, 1, 0).to(dtype))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


# relative to the output's peak: the kernel sums the conv in fp32 in
# another order and applies the epilogue in fp32 as the plain version does,
# so an output rounds to bf16 the other way at most once (2^-7 of the peak
# at most); fp32: summation order and the library's exp
TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def _check_kernel(x, w, vecs, act, dt):
    """Two launches (the same bits, counted), the plain version with the
    kernel's rounding, the first and last time rows and frequency columns
    on their own."""
    before = cc.LAUNCHES["conv_bn_act_eval"]
    with torch.inference_mode():
        got, again = (cc.conv_bn_act_eval(x, w, *vecs, act, EPS, dt) for _ in range(2))
        want = cc.conv_bn_act_eval_round_once_ref(x, w, *vecs, EPS, act, dt)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["conv_bn_act_eval"] == before + 2
    assert torch.equal(got, again)
    assert got.shape == want.shape and got.dtype == x.dtype and bool(torch.isfinite(got).all())
    tol = TOL[str(x.dtype).split(".")[-1]]
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * peak
    edge = max(1, (w.shape[0] - 1) * dt // 2)
    for cut in ((slice(None), slice(0, edge)), (slice(None), slice(-edge, None)),
                (slice(None), slice(None), slice(0, 2)), (slice(None), slice(None), slice(-2, None))):
        assert (got[cut].float() - want[cut].float()).abs().max().item() <= tol * peak


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["mish", "relu"])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_eval_block_at_the_model_shapes_on_card(layer, batch, act):
    """C = 64 bf16 (the serving cells' route) at ``[B, 301, 601, 64]``,
    every layer kind of conv2 … conv7 and the wide config's dilation 32."""
    _need_card()
    x, w, vecs, dt = _inputs((batch, 301, 601, 64), layer, torch.bfloat16, seed=batch, device="cuda")
    _check_kernel(x, w, vecs, act, dt)


# (Cin, Cout) on the wide tiles, and shapes with the halo in play (T under
# the dilated reach, F off the tiles, B = 1)
WIDE = {"96": (96, 96), "128": (128, 128), "64-128": (64, 128), "128-96": (128, 96)}
SMALL = {"5x5-d16": (2, 19, 150), "7x1": (1, 29, 37), "5x5-d1": (2, 41, 300)}


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["mish", "relu"])
@pytest.mark.parametrize("layer", sorted(SMALL))
@pytest.mark.parametrize("width", sorted(WIDE))
def test_eval_block_on_the_wide_tiles_on_card(width, layer, act):
    """bf16 at other widths than 64: the wide forward body's eval mode, its
    tile the C planner's (`wide_tile_of_library`) as the Python table
    has it, and its grid within the resident blocks."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_fused as cf

    cin, cout = WIDE[width]
    (kt, kf), dil = LAYERS[layer]
    x, w, vecs, dt = _inputs((*SMALL[layer], cin), layer, torch.bfloat16, cout=cout, seed=7, device="cuda")
    table = cc.fwd_tile(cin, cout, kt, kf, torch.bfloat16, "eval")
    planner = cc.wide_tile_of_library("fwd", cin, cout, kt, kf, "eval")
    assert table["route"] == "tiles" and all(table[k] == v for k, v in planner.items()), (table, planner)
    grid = cf._fwd_config(x.shape, kt, kf, dt, torch.bfloat16, cc.FWD_MODES["eval"], cout)
    assert grid["blocks"] <= grid["resident_blocks"] and grid["smem_bytes"] == table["smem_bytes"]
    _check_kernel(x, w, vecs, act, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["mish", "relu"])
@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("layer", ["7x1", "5x5-d2"])
def test_eval_block_in_fp32_on_card(layer, width, act):
    """fp32 (CUDA-core products): the C = 64 instantiation and the slab
    route at 128 channels, T and F off the items."""
    _need_card()
    x, w, vecs, dt = _inputs((2, 13, 150, width), layer, torch.float32, seed=9, device="cuda")
    _check_kernel(x, w, vecs, act, dt)


@pytest.mark.gpu
def test_eval_block_pads_a_channel_count_off_the_copies_width_on_card():
    """100 channels: zero-padded to 104 around the launch (counted in
    `CHANNEL_PADS`), the plain version's result."""
    _need_card()
    x, w, vecs, dt = _inputs((2, 13, 150, 100), "5x5-d2", torch.bfloat16, seed=11, device="cuda")
    before = cc.CHANNEL_PADS["conv_bn_act_eval"]
    _check_kernel(x, w, vecs, "mish", dt)
    assert cc.CHANNEL_PADS["conv_bn_act_eval"] == before + 2


@pytest.mark.gpu
def test_eval_block_backward_on_card():
    """A differentiated eval-mode forward on the card: the backward's kernels
    (the conv recomputed, its data and weight gradients) against the same
    backward through the plain versions."""
    _need_card()
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x, w, vecs, dt = _inputs((2, 13, 150, 64), "5x5-d2", torch.float32, seed=13, device="cuda")
    cot = torch.randn(2, 13, 150, 64, device="cuda")
    grads = []
    for plain in (False, True):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, *vecs[:3])]
        if plain:
            with smoke._PlainVersions(cc):
                (cc.conv_bn_act_eval(*leaves, *vecs[3:], "mish", EPS, dt) * cot).sum().backward()
        else:
            (cc.conv_bn_act_eval(*leaves, *vecs[3:], "mish", EPS, dt) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _peak_rel(got, want) <= 1e-4  # fp32: summation order


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["voicesplit", "voicefilter"])
def test_eval_model_with_the_switch_matches_the_switch_off_model_on_card(config, monkeypatch):
    """Full-width eval model (bf16) on a B=2 call, `separate_batch` with
    the dilated switch (six eval blocks, each one launch) against the
    switch-off call (cuDNN, eager BatchNorm + activation): mask (absolute,
    in [0, 1]) and waveform (relative to its peak) within the dilated
    route's serving tolerance, `chip_smoke.SEPARATE_DILATED_TOL` (5e-3)."""
    _need_card()
    import importlib.util

    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = load_config(str(REPO / "configs" / f"{config}.json"))
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed=3)
    n = int(cfg.audio.audio_len * ap.sample_rate)
    mixed, emb = (torch.as_tensor(a, device="cuda")
                  for a in smoke.synthetic_batch(5, 2, n, ap.sample_rate, cfg.model.emb_dim))
    out, masks = {}, {}
    for on in ("0", "1"):
        monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", on)
        cc.reset_launch_counts()
        with torch.inference_mode():
            spec_, _ = ap.wav2spec_batch(mixed)
            masks[on] = model(spec_, emb)
        out[on] = separate_batch(model, ap, mixed, emb)
        torch.cuda.synchronize()
        want = {"conv_dilated_fwd": 0, "conv_dilated_wgrad": 0, "conv_bn_act_eval": 12 if on == "1" else 0}
        assert cc.LAUNCHES == want, cc.LAUNCHES
    assert (masks["1"] - masks["0"]).abs().max().item() <= smoke.SEPARATE_DILATED_TOL
    assert _peak_rel(out["1"], out["0"]) <= smoke.SEPARATE_DILATED_TOL
    assert smoke.DILATED_SERVE_LAUNCHES == {"conv_dilated_fwd": 0, "conv_dilated_wgrad": 0, "conv_bn_act_eval": 6}
    assert np.isfinite(out["1"].cpu().numpy()).all()
