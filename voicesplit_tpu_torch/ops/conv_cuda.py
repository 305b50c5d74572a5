"""Time-dilated "same" 2-D convolution as two CUDA kernels
(`csrc/conv_fwd.cu`, `csrc/conv_wgrad.cu`), their plain PyTorch versions,
the differentiable conv built on them and the routing condition that the
mask network asks (counterpart of `voicesplit_tpu/ops/conv_pallas.py`).

Opt-in with ``VOICESPLIT_PALLAS_CONV=1`` (the JAX package's variable): the
heavy conv layers of the mask network, a (7,1) layer and five (5,5) layers
with time dilation 1..16 over ``[B, T, F=601, C]`` (C is ``conv_channels``,
64 in every file of `configs/`) and the wide variant's extra (5,5) blocks at
time dilation 32·2^i (`configs/voicesplit_wide.json`: 32, whose outer taps
reach 64 rows to each side), then compute their
convolution, its data gradient and its weight gradient with the kernels of
this module instead of the library's conv.

Kernels (each beside its plain version ``*_ref``):

- ``conv_dilated_fwd`` replaces `_fwd_kernel` (`conv_pallas.py:95`): the
  "same" conv without bias; with tap-flipped, channel-transposed weights
  (`flip_weight`) the same kernel is the data gradient, as in
  `_vjp_bwd` (`:371-378`); its kernel body also serves the fused chain's
  `conv_fused.conv_dgrad`;
- ``conv_dilated_wgrad`` replaces `_wgrad_kernel` (`:234`): the fp32 weight
  gradient ``[kt, kf, Cin, Cout]``, by the kernel of `csrc/conv_wgrad.cu`
  that the fused chain's `conv_wgrad` also launches after its prologue pass;
- ``conv_bn_act_eval`` is an eval-mode layer whole: the forward kernel's
  body in its eval mode, which adds the conv bias, applies BatchNorm with
  the running statistics and the activation to the fp32 sums in its
  epilogue and rounds once (`_fwd_kernel`, then the bias of `conv_dispatch`
  and `folded_bn_act_eval`, which the JAX package runs apart).  Its plain
  version composes the plain conv, the bias add and `bn_act.bn_act_eval`
  exactly as a train-capable path computes them, so the CPU results keep
  their bits; ``conv_bn_act_eval_round_once_ref`` has the kernel's rounding.

Layout: activations channels-last ``[B, T, F, C]`` (the JAX package's NHWC),
weights ``[kt, kf, Cin, Cout]`` (HWIO).  Odd ``kt`` and ``kf``, frequency
dilation 1.  The TPU's K-fold / N-fold, lane padding and halo frames are not
carried over: a tap outside ``[0, T) × [0, F)`` reads zero.

Rounding.  The Pallas forward rounds each frequency tap's partial sum to the
output type and adds the ``kf`` partial sums in that type
(`conv_pallas.py:144-158`).  The plain version keeps that rounding, so that
it meets the Pallas kernel in interpret mode tightly.  The CUDA kernel sums
all taps in fp32 and rounds once, which is more exact; in bf16 the two
differ by a few roundings of the output (`chip_smoke.py` states the
tolerance and reports the difference), in fp32 by summation order only.
``conv_dilated_fwd_round_once_ref`` is the plain version with the CUDA
kernel's rounding.

Dispatch: a CUDA tensor goes to the kernel, or the call raises; the plain
versions run only for tensors on the CPU.  Each kernel launch adds one to
``LAUNCHES[name]``.  The forward is the `torch.library` operator
``voicesplit::conv_dilated_fwd`` (checks, dispatch and count inside it; a
fake implementation for `torch.export`), which the differentiable conv calls
for its forward and its data gradient; the eval-mode layer is the operator
``voicesplit::conv_bn_act_eval`` (the same, and for an eval-mode forward
that is differentiated a backward by autograd through the composition it
replaces, recomputed).  The kernels take every channel count
that `takes_layer` sends them, at least 64 in and out, Cin and Cout apart
(64 in and out is a compile-time instantiation of its own; other counts in
bf16 take the wide tiles of `csrc/conv_fwd_wide.cu` and
`csrc/conv_wgrad_wide.cu`, all output channels of a group in one wgmma
product, the tile from the shape before the launch (`fwd_tile`,
`wgrad_tile`); in fp32 64-wide slabs of input and groups of output
channels), bf16 or fp32
operands (fp32 products on CUDA cores, not TF32) and kf in (1, 3, 5), the
forward at most `conv_fused.FWD_KERNEL_MAX_KT` time taps.  A channel count
that is not a multiple of `CHANNEL_ALIGN` (the 16-byte copies' width) is
zero-padded up to one around the launch and the result sliced back: a copy
of the operands, counted in ``CHANNEL_PADS[name]``, not another route.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from voicesplit_tpu_torch.ops import _build
from voicesplit_tpu_torch.ops.bn_act import bn_act_eval
from voicesplit_tpu_torch.ops.conv_fused import (
    _ACT_CODE, CHANNEL_SLAB, _conv_core, _padded, check_fwd_kernel_takes, launch_wgrad_kernel,
)

# kernel launches per wrapper, for showing that a run went through them
LAUNCHES = {"conv_dilated_fwd": 0, "conv_dilated_wgrad": 0, "conv_bn_act_eval": 0}
# launches whose operands were zero-padded to a multiple of CHANNEL_ALIGN
CHANNEL_PADS = {"conv_dilated_fwd": 0, "conv_dilated_wgrad": 0, "conv_bn_act_eval": 0}
CHANNEL_ALIGN = 8  # channels of one 16-byte bf16 copy: the kernels take multiples of it

_WGRAD_KF = (1, 3, 5)  # frequency tap counts the weight-gradient kernel is built for
_MAX_TAPS = 7

# The kernels' tiles by shape, chosen before any launch (`fwd_tile`,
# `wgrad_tile`): the mirror of the C planners, `csrc/conv_wide.cuh` for bf16
# at other widths than 64 (the wide-tile routes; C = 64 and fp32 keep the
# fixed tiles of `csrc/conv_fwd.cu` and `csrc/conv_wgrad.cu`, named by their
# route alone).  `chip_smoke.py` holds the C table (`wide_tile_of_library`)
# to this one at every shape it launches.
SMEM_LIMIT = 232448  # dynamic shared memory bytes a block may take on an H100 (227 KB)
ACCUMULATOR_LIMIT = 192  # fp32 accumulators a thread that a tile may take
FWD_WIDTHS = (64, 96, 128, 192, 256)  # wgmma widths of the wide forward (conv_fwd_wide.cu)
WGRAD_WIDTHS = (64, 96, 128)  # and of the wide weight gradient (conv_wgrad_wide.cu)
FWD_MODES = {"plain": 0, "dgrad": 1, "chain": 2, "eval": 3}
_ALIGN, _WARPS, _STAGES = 1024, 8, 3
_STATIC = 1024  # kept for the wide kernels' static shared memory (their mbarriers)

_declared = False


def pallas_conv_enabled() -> bool:
    """Opt-in, with the JAX package's variable: ``VOICESPLIT_PALLAS_CONV=1``."""
    return os.environ.get("VOICESPLIT_PALLAS_CONV", "0") == "1"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        CHANNEL_PADS[k] = 0


def _library() -> ctypes.CDLL:
    global _declared
    if not _declared:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip, lp = ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong)
        _build.declare({
            "conv_dilated_fwd": [p] * 3 + [i] * 9 + [p],
            "conv_bn_act_eval": [p] * 8 + [i] * 8 + [ctypes.c_float] + [i] * 2 + [p],
            "conv_fwd_wide_tile": [i] * 4 + [ip] * 7 + [lp],
            "conv_wgrad_wide_tile": [i] * 3 + [ip] * 7 + [lp],
            "conv_fwd_wide_attributes": [i] * 3 + [ip] * 2,
            "conv_wgrad_wide_attributes": [i] * 2 + [ip] * 2,
        })
        _declared = True
    return _build.library()


def flip_weight(w: torch.Tensor) -> torch.Tensor:
    """The data gradient's weights: taps flipped, channels transposed
    (``[kt, kf, Cin, Cout]`` → ``[kt, kf, Cout, Cin]``)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _route(cin: int, cout: int, dtype: torch.dtype) -> str:
    if cin == CHANNEL_SLAB and cout == CHANNEL_SLAB:
        return "64"
    return "tiles" if dtype == torch.bfloat16 else "slab"


def _fwd_width(channels: int) -> int:
    return next(n for n in FWD_WIDTHS if channels <= n) if channels <= FWD_WIDTHS[-1] else FWD_WIDTHS[-1]


def fwd_tile(cin: int, cout: int, kt: int, kf: int, dtype: torch.dtype, mode: str = "plain") -> dict:
    """The forward / data-gradient kernel's tile for ``[kt, kf, cin, cout]``
    weights in `dtype` and `mode` ("plain": `conv_dilated_fwd`, "dgrad":
    `conv_fused.conv_dgrad`, "chain": `conv_fused.conv_bn_act_fwd`, "eval":
    `conv_bn_act_eval`), as the C
    planner picks it before the launch: the ``route`` ("64": the C = 64
    instantiation, "slab": fp32 at other widths in 64-wide slabs and groups,
    "tiles": bf16 at other widths, `conv_fwd_wide.cu`) and, on "tiles", the
    wide tile of `csrc/conv_wide.cuh`: output ``groups`` and their wgmma
    width ``n``, ``mt`` m64 tiles a warpgroup, ``rows`` x ``tf`` positions an
    item, ``ring`` input row tiles, ``wbufs`` weight slices in flight,
    ``smem_bytes`` and ``accumulators`` (fp32 a thread)."""
    route = _route(cin, cout, dtype)
    if route != "tiles":
        return {"route": route}
    groups = -(-cout // 256)
    n = _fwd_width(-(-cout // groups))
    mt = 2 if n <= 128 else 1
    tf, ring = 64 * mt, kt + 3
    ring_bytes = ring * _round_up((tf + kf - 1) * CHANNEL_SLAB * 2, _ALIGN)  # 1024-byte slots
    slice_bytes = CHANNEL_SLAB * _round_up(n, 64) * 2
    extra = {"chain": _WARPS * (2 * n + 128) * 4, "dgrad": _WARPS * CHANNEL_SLAB * 4, "eval": 3 * cout * 4}.get(mode, 0)
    for wbufs in (4, 3, 2):
        smem = ring_bytes + wbufs * slice_bytes + extra + _ALIGN
        if smem + _STATIC <= SMEM_LIMIT:
            break
    return {"route": route, "n": n, "groups": groups, "mt": mt, "rows": 2, "tf": tf, "ring": ring,
            "wbufs": wbufs, "smem_bytes": smem, "accumulators": mt * n // 2}


def wgrad_tile(cin: int, cout: int, kf: int, dtype: torch.dtype) -> dict:
    """The weight-gradient kernel's tile for inputs of `cin` and a
    cotangent of `cout` channels, kf frequency taps, in `dtype`, as the C
    planner picks it: the ``route`` (as `fwd_tile`) and, on "tiles", output
    ``groups`` of wgmma width ``n``, ``tw`` m64 x n tiles a warpgroup, each
    time tap's (input slab, frequency tap) tiles cut into ``segs`` segments
    of at most ``seg_tiles`` tiles touching ``slabs`` input slabs, ``tf``
    positions an item, ``smem_bytes`` and ``accumulators`` (fp32 a
    thread)."""
    route = _route(cin, cout, dtype)
    if route != "tiles":
        return {"route": route}
    groups = -(-cout // 128)
    per = -(-cout // groups)
    n = next(w for w in WGRAD_WIDTHS if per <= w)
    tw, tf = (4 if n <= 64 else 3 if n <= 96 else 2), 128
    d_bytes = _round_up(n, 64) * tf * 2
    y_bytes = _round_up((tf + kf - 1) * CHANNEL_SLAB * 2, _ALIGN)  # a slab of y, 1024-byte aligned
    n_tiles, cap = -(-cin // CHANNEL_SLAB) * kf, 2 * tw
    for segs in range(-(-n_tiles // cap), n_tiles + 1):
        bounds = [(s * n_tiles // segs, (s + 1) * n_tiles // segs) for s in range(segs)]
        slabs = max((hi - 1) // kf - lo // kf + 1 for lo, hi in bounds)
        stage = _round_up(d_bytes + slabs * y_bytes, _ALIGN)
        if slabs <= 4 and _STAGES * stage + _ALIGN + _STATIC <= SMEM_LIMIT:
            return {"route": route, "n": n, "groups": groups, "tw": tw, "segs": segs,
                    "seg_tiles": max(hi - lo for lo, hi in bounds), "slabs": slabs, "tf": tf,
                    "smem_bytes": _STAGES * stage + _ALIGN, "accumulators": tw * n // 2}
    raise ValueError(f"no weight-gradient tile fits {cin} -> {cout}, kf {kf}")


def wide_tile_of_library(kind: str, cin: int, cout: int, kt: int, kf: int, mode: str = "plain") -> dict:
    """The C table's tile of the wide-tile routes (bf16 at other widths), read
    from the built library without a launch (`conv_fwd_wide_tile`,
    `conv_wgrad_wide_tile`): the keys of `fwd_tile` (kind "fwd") or
    `wgrad_tile` (kind "wgrad") but ``route`` and ``accumulators``."""
    lib = _library()
    vals = [ctypes.c_int() for _ in range(7)]
    smem = ctypes.c_longlong()
    if kind == "fwd":
        keys = ("n", "groups", "mt", "rows", "tf", "ring", "wbufs")
        err = lib.conv_fwd_wide_tile(cout, kt, kf, FWD_MODES[mode], *map(ctypes.byref, vals), ctypes.byref(smem))
    else:
        keys = ("n", "groups", "tw", "segs", "seg_tiles", "slabs", "tf")
        err = lib.conv_wgrad_wide_tile(cin, cout, kf, *map(ctypes.byref, vals), ctypes.byref(smem))
    _build.raise_on(err, f"conv_{kind}_wide_tile")
    return {**{k: v.value for k, v in zip(keys, vals)}, "smem_bytes": smem.value}


def wide_kernel_attributes() -> dict:
    """Registers and local (spilled) bytes a thread of every instantiation
    of the wide-tile kernels in the built library, read without a launch
    (`conv_fwd_wide_attributes`, `conv_wgrad_wide_attributes`): keys
    ``"fwd/<mode>/kf<kf>/n<n>"`` (the chain's modes are built for n >= 128)
    and ``"wgrad/kf<kf>/n<n>"``."""
    lib = _library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    out = {}
    for kf in _WGRAD_KF:
        for mode, code in FWD_MODES.items():
            for n in FWD_WIDTHS:
                if mode in ("dgrad", "chain") and n < 128:
                    continue
                err = lib.conv_fwd_wide_attributes(kf, code, n, ctypes.byref(regs), ctypes.byref(local))
                _build.raise_on(err, f"conv_fwd_wide_attributes({kf}, {mode}, {n})")
                out[f"fwd/{mode}/kf{kf}/n{n}"] = {"registers": regs.value, "local_bytes": local.value}
        for n in WGRAD_WIDTHS:
            err = lib.conv_wgrad_wide_attributes(kf, n, ctypes.byref(regs), ctypes.byref(local))
            _build.raise_on(err, f"conv_wgrad_wide_attributes({kf}, {n})")
            out[f"wgrad/kf{kf}/n{n}"] = {"registers": regs.value, "local_bytes": local.value}
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def conv_dilated_fwd_ref(x: torch.Tensor, w: torch.Tensor, dt: int) -> torch.Tensor:
    """``x [B, T, F, Cin]`` ⊛ ``w [kt, kf, Cin, Cout]`` (one type, bf16 or
    fp32) → ``[B, T, F, Cout]`` in that type, with the Pallas kernel's
    rounding: per frequency tap the sum over the time taps and input
    channels in fp32, rounded to the output type; the ``kf`` partial sums
    added in the output type."""
    kt, kf = w.shape[:2]
    T, F_ = x.shape[1:3]
    xp, wf = _padded(x, kt, kf, dt), w.float()
    acc = None
    for j in range(kf):
        z = None
        for i in range(kt):
            term = xp[:, i * dt:i * dt + T, j:j + F_] @ wf[i, j]
            z = term if z is None else z.add_(term)
        z = z.to(x.dtype)
        acc = z if acc is None else acc + z
    return acc.contiguous()


def conv_dilated_fwd_round_once_ref(x: torch.Tensor, w: torch.Tensor, dt: int) -> torch.Tensor:
    """The same conv with the CUDA kernel's rounding: every tap summed in
    fp32, rounded once to the output type.  In fp32 it equals
    `conv_dilated_fwd_ref` up to summation order; in bf16 it is what the
    kernel is held to without the Pallas kernel's per-tap roundings."""
    return _conv_core(x, w, dt).to(x.dtype).contiguous()


def conv_bn_act_eval_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                         beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
                         act: str, dt: int) -> torch.Tensor:
    """An eval-mode layer on ``x [B, T, F, Cin]`` with ``w [kt, kf, Cin,
    Cout]`` (one type) and fp32 ``[Cout]`` vectors (conv bias `b`, BatchNorm
    `scale`, `beta`, running `mean`, `var`) → ``[B, T, F, Cout]``, the
    composition it replaces op for op: `conv_dilated_fwd_ref`, the bias
    added in the operand type, `bn_act.bn_act_eval` (its constants rounded to
    the operand type, each op rounded)."""
    y = conv_dilated_fwd_ref(x, w, dt) + b.to(x.dtype)
    z = bn_act_eval(y.permute(0, 3, 1, 2), scale, beta, mean, var, act, eps)
    return z.permute(0, 2, 3, 1).contiguous()


def conv_bn_act_eval_round_once_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                    scale: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
                                    var: torch.Tensor, eps: float, act: str, dt: int) -> torch.Tensor:
    """The same layer with the CUDA kernel's arithmetic: the conv summed in
    fp32, then ``act((sum + b)·inv + shift)`` in fp32 with ``inv = scale ·
    (1 / sqrt(var + eps))`` and ``shift = beta − mean·inv``, mish as ``z·n /
    (n + 2)`` with ``n = u·(u + 2)``, ``u = e^min(z, 20)`` (the kernel takes
    the card's fast exponential and division, a few fp32 ulps from these),
    rounded once to the operand type.  What the kernel is held to on the
    card."""
    inv = scale * (1.0 / torch.sqrt(var + eps))
    shift = beta - mean * inv
    z = (_conv_core(x, w, dt) + b) * inv + shift
    if act == "mish":
        u = torch.exp(torch.clamp(z, max=20.0))
        n = u * (u + 2.0)
        z = z * (n / (n + 2.0))
    elif act == "relu":
        z = torch.clamp(z, min=0.0)
    else:
        raise ValueError(f"unknown activation {act!r}")
    return z.to(x.dtype).contiguous()


def conv_dilated_wgrad_ref(x: torch.Tensor, dy: torch.Tensor, kt: int, kf: int,
                           dt: int) -> torch.Tensor:
    """``dW[i, j, c, co] = Σ x[b, t + i·dt − pad_t, f + j − pad_f, c] ·
    dy[b, t, f, co]`` in fp32, ``[kt, kf, Cin, Cout]``: exact products of
    the operands, fp32 sums."""
    T, F_, cin = x.shape[1:]
    cout = dy.shape[-1]
    xp = _padded(x, kt, kf, dt)
    d2 = dy.float().reshape(-1, cout)
    dw = torch.empty(kt, kf, cin, cout, dtype=torch.float32, device=x.device)
    for i in range(kt):
        for j in range(kf):
            dw[i, j] = xp[:, i * dt:i * dt + T, j:j + F_].reshape(-1, cin).t() @ d2
    return dw


# ---------------------------------------------------------------------------
# Checks and kernel launches
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, other: torch.Tensor, other_shape: Tuple[int, ...], what: str,
           kt: int, kf: int, dt: int) -> None:
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"activations must be [B, T, F, C], got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"operands must be bf16 or fp32, got {x.dtype}")
    if kt < 1 or kf < 1 or kt % 2 == 0 or kf % 2 == 0:
        raise ValueError(f"kernel sizes must be odd, got ({kt}, {kf})")
    if dt < 1:
        raise ValueError(f"time dilation must be >= 1, got {dt}")
    if tuple(other.shape) != other_shape or other.dtype != x.dtype or other.device != x.device:
        raise ValueError(
            f"{what} must be {list(other_shape)} {x.dtype} on {x.device}, "
            f"got {tuple(other.shape)} {other.dtype} on {other.device}"
        )
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError("operands must be contiguous")


def _check_kernel_takes(cin: int, cout: int, kt: int, kf: int, wgrad: bool) -> None:
    """What the CUDA kernels are built for: the channels `takes_layer`
    sends them (at least 64 in and out) and their taps; anything else
    raises on the card (it never goes to the library conv)."""
    if cin < CHANNEL_SLAB or cout < CHANNEL_SLAB:
        raise NotImplementedError(
            f"the CUDA kernels take at least {CHANNEL_SLAB} channels in and out, got {cin} and {cout}"
        )
    if not wgrad:
        check_fwd_kernel_takes(kt, kf)
    elif kt > _MAX_TAPS or kf not in _WGRAD_KF:
        raise NotImplementedError(
            f"the weight-gradient kernel takes at most {_MAX_TAPS} time taps and kf in "
            f"{_WGRAD_KF}, got ({kt}, {kf})"
        )


def _aligned(n: int) -> int:
    return -(-n // CHANNEL_ALIGN) * CHANNEL_ALIGN


def _pad_last(t: torch.Tensor, *pads: int) -> torch.Tensor:
    """`t` with zeros after its last dimensions (the last first), contiguous."""
    return F.pad(t, [p for n in pads for p in (0, n)]).contiguous()


def _launch_conv_dilated_fwd(x, w, dt):
    B, T, F_, cin = x.shape
    kt, kf, _, cout = w.shape
    _check_kernel_takes(cin, cout, kt, kf, wgrad=False)
    cin_a, cout_a = _aligned(cin), _aligned(cout)
    if (cin_a, cout_a) != (cin, cout):
        CHANNEL_PADS["conv_dilated_fwd"] += 1
        x, w = _pad_last(x, cin_a - cin), _pad_last(w, cout_a - cout, cin_a - cin)
    out = x.new_empty((B, T, F_, cout_a))
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.conv_dilated_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), B, T, F_, cin_a, cout_a, kt, kf, dt,
            int(x.dtype == torch.bfloat16), _build.stream(x),
        )
    _build.raise_on(err, "conv_dilated_fwd")
    LAUNCHES["conv_dilated_fwd"] += 1
    return out if cout_a == cout else out[..., :cout].contiguous()


def _launch_conv_dilated_wgrad(x, dy, kt, kf, dt):
    cin, cout = x.shape[-1], dy.shape[-1]
    _check_kernel_takes(cin, cout, kt, kf, wgrad=True)
    cin_a, cout_a = _aligned(cin), _aligned(cout)
    if (cin_a, cout_a) != (cin, cout):
        CHANNEL_PADS["conv_dilated_wgrad"] += 1
        x, dy = _pad_last(x, cin_a - cin), _pad_last(dy, cout_a - cout)
    dw = launch_wgrad_kernel(x, dy, kt, kf, dt)
    LAUNCHES["conv_dilated_wgrad"] += 1
    return dw if (cin_a, cout_a) == (cin, cout) else dw[:, :, :cin, :cout].contiguous()


def _launch_conv_bn_act_eval(x, w, b, scale, beta, mean, var, eps, act, dt):
    B, T, F_, cin = x.shape
    kt, kf, _, cout = w.shape
    _check_kernel_takes(cin, cout, kt, kf, wgrad=False)
    cin_a, cout_a = _aligned(cin), _aligned(cout)
    vecs = (b, scale, beta, mean, var)
    if (cin_a, cout_a) != (cin, cout):
        CHANNEL_PADS["conv_bn_act_eval"] += 1
        x, w = _pad_last(x, cin_a - cin), _pad_last(w, cout_a - cout, cin_a - cin)
        vecs = tuple(_pad_last(v, cout_a - cout) for v in vecs)  # var 0 + eps: inv 0 there
    out = x.new_empty((B, T, F_, cout_a))
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.conv_bn_act_eval(
            x.data_ptr(), w.data_ptr(), *(v.data_ptr() for v in vecs), out.data_ptr(),
            B, T, F_, cin_a, cout_a, kt, kf, dt, eps, _ACT_CODE[act],
            int(x.dtype == torch.bfloat16), _build.stream(x),
        )
    _build.raise_on(err, "conv_bn_act_eval")
    LAUNCHES["conv_bn_act_eval"] += 1
    return out if cout_a == cout else out[..., :cout].contiguous()


@torch.library.custom_op(
    "voicesplit::conv_dilated_fwd", mutates_args=(), schema="(Tensor x, Tensor w, int dt) -> Tensor"
)
def _conv_dilated_fwd_op(x, w, dt):
    if w.dim() != 4:
        raise ValueError(f"weights must be [kt, kf, Cin, Cout], got {tuple(w.shape)}")
    kt, kf, _, cout = w.shape
    cin = x.shape[-1] if x.dim() == 4 else 0
    _check(x, w, (kt, kf, cin, cout), "weights", kt, kf, dt)
    return _build.dispatch(x.device, _launch_conv_dilated_fwd, conv_dilated_fwd_ref)(x, w, dt)


@_conv_dilated_fwd_op.register_fake
def _(x, w, dt):
    return x.new_empty((*x.shape[:3], w.shape[3]))


def conv_dilated_fwd(x: torch.Tensor, w: torch.Tensor, dt: int) -> torch.Tensor:
    """The "same" time-dilated conv without bias (kernel on CUDA, plain
    version on the CPU); see `conv_dilated_fwd_ref` for shapes and types."""
    return torch.ops.voicesplit.conv_dilated_fwd(x, w, int(dt))


@torch.library.custom_op(
    "voicesplit::conv_bn_act_eval", mutates_args=(),
    schema="(Tensor x, Tensor w, Tensor b, Tensor scale, Tensor beta, Tensor mean, Tensor var, "
           "float eps, str act, int dt) -> Tensor",
)
def _conv_bn_act_eval_op(x, w, b, scale, beta, mean, var, eps, act, dt):
    if w.dim() != 4:
        raise ValueError(f"weights must be [kt, kf, Cin, Cout], got {tuple(w.shape)}")
    kt, kf, _, cout = w.shape
    cin = x.shape[-1] if x.dim() == 4 else 0
    _check(x, w, (kt, kf, cin, cout), "weights", kt, kf, dt)
    if act not in _ACT_CODE:
        raise ValueError(f"unknown activation {act!r}")
    for name, v in (("bias", b), ("scale", scale), ("beta", beta), ("mean", mean), ("var", var)):
        if tuple(v.shape) != (cout,) or v.dtype != torch.float32 or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous [{cout}] fp32 on {x.device}, "
                             f"got {tuple(v.shape)} {v.dtype} on {v.device}")
    fn = _build.dispatch(x.device, _launch_conv_bn_act_eval, conv_bn_act_eval_ref)
    return fn(x, w, b, scale, beta, mean, var, eps, act, dt)


@_conv_bn_act_eval_op.register_fake
def _(x, w, b, scale, beta, mean, var, eps, act, dt):
    return x.new_empty((*x.shape[:3], w.shape[3]))


def _conv_bn_act_eval_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:7])
    ctx.eps, ctx.act, ctx.dt = inputs[7:]


def _conv_bn_act_eval_backward(ctx, dy):
    """The gradients of the composition the operator replaces, by autograd
    through it recomputed: `conv2d_dilated_bias` (the conv kernels on CUDA),
    then `bn_act.bn_act_eval`."""
    need = ctx.needs_input_grad[:7]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        x, w, b, scale, beta, mean, var = leaves
        y = conv2d_dilated_bias(x, w, b, (ctx.dt, 1))
        z = bn_act_eval(y.permute(0, 3, 1, 2), scale, beta, mean, var, ctx.act, ctx.eps)
        grads = iter(torch.autograd.grad(z.permute(0, 2, 3, 1), [t for t, n in zip(leaves, need) if n], dy))
    return (*(next(grads) if n else None for n in need), None, None, None)


_conv_bn_act_eval_op.register_autograd(_conv_bn_act_eval_backward, setup_context=_conv_bn_act_eval_setup)


def conv_bn_act_eval(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                     beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, act: str,
                     eps: float, dt: int) -> torch.Tensor:
    """An eval-mode conv block in one launch (kernel on CUDA, the plain
    composition on the CPU); see `conv_bn_act_eval_ref` for shapes and types."""
    return torch.ops.voicesplit.conv_bn_act_eval(x, w, b, scale, beta, mean, var, float(eps), act, int(dt))


def conv_dilated_wgrad(x: torch.Tensor, dy: torch.Tensor, kt: int, kf: int,
                       dt: int) -> torch.Tensor:
    """fp32 weight gradient of the conv (kernel on CUDA, plain version on
    the CPU); see `conv_dilated_wgrad_ref`."""
    if dy.dim() != 4:
        raise ValueError(f"the cotangent must be [B, T, F, Cout], got {tuple(dy.shape)}")
    shape = (*x.shape[:3], dy.shape[-1]) if x.dim() == 4 else ()
    _check(x, dy, shape, "the cotangent", kt, kf, dt)
    fn = _build.dispatch(x.device, _launch_conv_dilated_wgrad, conv_dilated_wgrad_ref)
    return fn(x, dy, kt, kf, dt)


# ---------------------------------------------------------------------------
# The differentiable conv and the model's dispatch
# ---------------------------------------------------------------------------


class _Conv2dDilated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dt):
        x = x.contiguous()
        w = w.contiguous()
        ctx.dt = dt
        ctx.save_for_backward(x, w)
        return conv_dilated_fwd(x, w, dt)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        kt, kf = w.shape[:2]
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv_dilated_fwd(dy, flip_weight(w), ctx.dt)
        if ctx.needs_input_grad[1]:
            # rounded to the weights' (compute) type, as `_vjp_bwd` does
            dw = conv_dilated_wgrad(x, dy, kt, kf, ctx.dt).to(w.dtype)
        return dx, dw, None


def conv2d_dilated(x: torch.Tensor, w: torch.Tensor, dilation: Tuple[int, int]) -> torch.Tensor:
    """Differentiable "same" time-dilated conv ``[B, T, F, Cin] ⊛
    [kt, kf, Cin, Cout]`` without bias (counterpart of `conv2d_pallas`).
    Its backward is `conv_dilated_fwd` on the flipped, transposed weights
    and `conv_dilated_wgrad`, whose fp32 result is rounded to `w`'s type."""
    dt, df = dilation
    if df != 1:
        raise ValueError(f"frequency dilation must be 1, got {df}")
    return _Conv2dDilated.apply(x, w, int(dt))


class _AddBias(torch.autograd.Function):
    """``out + b`` in out's type; the bias gradient is the sum of the (bf16)
    cotangent taken in fp32."""

    @staticmethod
    def forward(ctx, out, b):
        return out + b.to(out.dtype)

    @staticmethod
    def backward(ctx, dy):
        db = dy.float().sum(dim=tuple(range(dy.dim() - 1))) if ctx.needs_input_grad[1] else None
        return dy, db


def takes_layer(w_shape: Sequence[int], dilation: Tuple[int, int]) -> bool:
    """The conditions of the JAX package's `conv_dispatch`
    (`conv_pallas.py:396-404`) for a layer with ``[kt, kf, Cin, Cout]``
    weights: the switch, frequency dilation 1, at least 64 channels in and
    out, more than one tap, odd sizes.  The model sends a layer that meets
    them to `conv2d_dilated_bias` and every other one (the (1,7) layer on
    one channel and the 1×1 projection) to the library conv, as the JAX
    package sends those to XLA."""
    kt, kf, cin, cout = w_shape
    return (
        pallas_conv_enabled()
        and dilation[1] == 1
        and cin >= 64
        and cout >= 64
        and (kt > 1 or kf > 1)
        and kt % 2 == 1
        and kf % 2 == 1
    )


def conv2d_dilated_bias(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                        dilation: Tuple[int, int]) -> torch.Tensor:
    """A heavy layer's conv as the model calls it: ``x [B, T, F, Cin]``,
    ``w [kt, kf, Cin, Cout]`` (cast to x's type), ``b [Cout]`` or None,
    added outside the kernel (`conv_pallas.py:406-420`)."""
    out = conv2d_dilated(x, w.to(x.dtype), dilation)
    if b is not None:
        out = _AddBias.apply(out, b)
    return out


def conv2d_bn_act_eval(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, bn, act: str,
                       dilation: Tuple[int, int]) -> torch.Tensor:
    """A heavy layer in eval mode as the model calls it: `conv2d_dilated_bias`
    followed by BatchNorm with `bn`'s running statistics (``scale``,
    ``bias``, ``mean``, ``var``, ``epsilon``) and `act`, as one
    `conv_bn_act_eval`; `w` (any layout) is cast and laid out in one copy."""
    dt, df = dilation
    if df != 1:
        raise ValueError(f"frequency dilation must be 1, got {df}")
    w = w.to(x.dtype, memory_format=torch.contiguous_format).contiguous()  # no second copy
    return conv_bn_act_eval(x, w, b, bn.scale, bn.bias, bn.mean, bn.var, act, bn.epsilon, dt)
