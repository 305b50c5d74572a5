"""Fused train-mode conv chain: three CUDA kernels (`csrc/conv_fwd.cu`,
`csrc/conv_wgrad.cu`), their plain PyTorch versions, and the chain with its
hand-written backward (counterpart of `voicesplit_tpu/ops/conv_fused.py`).

The chain runs the heavy conv stack of the mask network (a (7,1) layer and
five (5,5) layers with time dilation 1..16, and the wide variant's extra
(5,5) blocks at 32·2^i) so that the BatchNorm affine and
the activation *between* two convs never become a tensor of their own: each
conv applies the previous layer's ``act(x·inv + shift)`` to its input on the
fly (the prologue) and sums its own output's per-channel statistics while it
writes it.

Kernels (each beside its plain version ``*_ref``):

- ``conv_bn_act_fwd`` replaces `_fwd_kernel` (`conv_fused.py:303`):
  ``raw = round(conv(prologue(x)) + bias)`` and the fp32 per-channel sum and
  sum of squares of the rounded ``raw``.  With a prologue, the prologue pass
  of `conv_wgrad` (``LAUNCHES["conv_wgrad_prologue"]``) writes the activated
  input once into a scratch tensor; then the kernel body of `csrc/conv_fwd.cu`
  that `conv_cuda.conv_dilated_fwd` also launches adds the bias and takes the
  statistics in its epilogue;
- ``conv_dgrad`` replaces `_dgrad_kernel` (`:411`): the "same" conv of
  ``d_raw`` with tap-flipped, channel-transposed weights, and
  ``dbias = Σ d_raw`` per channel, by the kernel body of `csrc/conv_fwd.cu`
  that `conv_cuda.conv_dilated_fwd` also launches;
- ``conv_wgrad`` replaces `_wgrad_kernel` (`:524`): the fp32 weight gradient,
  its input recomputed from the raw tensor by the same prologue: a
  prologue pass writes the activated input once into a scratch tensor
  (``LAUNCHES["conv_wgrad_prologue"]``), then the weight-gradient kernel of
  `csrc/conv_wgrad.cu` that `conv_cuda.conv_dilated_wgrad` also launches;
- ``conv_draw_prologue`` replaces the BatchNorm-backward prologue of those
  two kernels (`_prologue_draw_inplace`, `:221`): the d_raw pass of
  `csrc/conv_wgrad.cu` (``LAUNCHES["conv_draw_prologue"]``) writes
  ``d_raw = round(inv·(dy·act'(z) − mean(dz) − x̂·mean(dz·x̂)))`` once from
  the cotangent dy and the raw conv output x.  The ``prologue=True``
  branch of `_dgrad_kernel` (`:423-444`) is that pass and then
  `conv_dgrad` on its output, so ``dbias`` sums the rounded d_raw as
  `:470-473` does; `_wgrad_kernel`'s ``rhs_prologue`` branch (`:539-540`,
  `:561-563`) is the pass and then `conv_wgrad`.

`make_chain` takes neither branch (`:795`, `:800`): it materializes ``d_raw``
with two plain passes (`_stage1`, `_materialize_draw`) in the compute dtype,
and the chain here does the same in eager PyTorch.

Layout: activations are channels-last ``[B, T, F, C]`` (the JAX package's
unfolded NHWC), weights ``[kt, kf, Cin, Cout]`` in the compute dtype.  The
TPU's frequency fold and zero-margined frames are not carried over: a tap
outside ``[0, T) × [0, F)`` reads zero (zero *after* the activation).

Under a process group (`parallel/mesh.py`) each layer's ``stats [2, C]``
and the backward's Σdz, Σdz·x̂ are summed over the ranks before they are
used, one packed buffer a layer, so the chain normalizes with the global
batch's statistics; the BatchNorm parameters' gradients stay this rank's
sums for the train step's gradient all-reduce.

Dispatch: a CUDA tensor goes to the kernel, or the call raises; the plain
versions run only for tensors on the CPU.  Each kernel launch adds one to
``LAUNCHES[name]``.  The kernels take any C that is a multiple of
`CHANNEL_SLAB` (64: a compile-time instantiation of their own; above it
bf16 takes the wide tiles, `conv_cuda.fwd_tile` / `wgrad_tile`, and fp32
walks 64-wide slabs and groups of channels), odd kernel sizes,
frequency dilation 1, and bf16 or fp32 operands (fp32 products on CUDA
cores, not TF32); `conv_bn_act_fwd` and `conv_dgrad` the taps of
`FWD_KERNEL_MAX_KT`.  The JAX model takes the chain at any C with
``2·C % 128 == 0`` (`MaskNet._use_fused_chain`), so every C it sends is
taken.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from voicesplit_tpu_torch.ops import _build
from voicesplit_tpu_torch.parallel.mesh import sum_over_ranks_

# kernel launches per wrapper, for showing that a run went through them;
# "conv_wgrad_prologue" counts every prologue pass, `conv_bn_act_fwd`'s and
# `conv_wgrad`'s, "conv_draw_prologue" every d_raw pass
LAUNCHES = {"conv_bn_act_fwd": 0, "conv_dgrad": 0, "conv_wgrad": 0, "conv_wgrad_prologue": 0,
            "conv_draw_prologue": 0}

# the conv kernels' input slab in channels: C = 64 in and out is an
# instantiation of its own, other counts walk their input channels in slabs
# of it (bf16: with all output channels of a group at once; fp32: and output
# groups of it); the chain's kernels take multiples of it
CHANNEL_SLAB = 64
# time taps the forward / data-gradient kernels (`csrc/conv_fwd.cu`) take, by
# frequency taps: an item's input rows in flight and the weights must fit one
# block's shared memory
FWD_KERNEL_MAX_KT = {1: 7, 3: 7, 5: 5}
_ACT_CODE = {"mish": 1, "relu": 2}  # the prologue and d_raw passes' activation

# rows of the per-channel scalar table (fp32 [8, C])
_S_INV, _S_SHIFT, _S_MEAN, _S_R, _S_MDZ, _S_MDZX = 0, 1, 2, 3, 4, 5

_declared = False


def fused_chain_enabled() -> bool:
    """Opt-in, as in the JAX package: ``VOICESPLIT_FUSED_CHAIN=1``."""
    return os.environ.get("VOICESPLIT_FUSED_CHAIN", "0") == "1"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library() -> ctypes.CDLL:
    global _declared
    if not _declared:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip, lp = ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong)
        _build.declare({
            "conv_bn_act_fwd": [p] * 6 + [i] * 8 + [p],
            "conv_dgrad": [p] * 5 + [i] * 8 + [p],
            "conv_wgrad": [p] * 4 + [i] * 9 + [p],
            "conv_wgrad_prologue": [p] * 3 + [i] * 6 + [p],
            "conv_draw_prologue": [p] * 4 + [i] * 6 + [p],
            "conv_fwd_launch_config": [i] * 10 + [ip, ip, lp, lp, ip, ip, ip],
            "conv_wgrad_launch_config": [i] * 9 + [ip, ip, lp, lp, ip, ip, ip],
        })
        _declared = True
    return _build.library()


def launch_config(shape: Sequence[int], kt: int, kf: int, dt: int, dtype: torch.dtype) -> dict:
    """Grid of `conv_bn_act_fwd` for activations of `shape` ``[B, T, F, C]``
    on the current card; the keys of `wgrad_launch_config`, the scratch being
    its per-block partial sums and sums of squares."""
    return _fwd_config(shape, kt, kf, dt, dtype, 2)


def fwd_launch_config(shape: Sequence[int], kt: int, kf: int, dt: int, dtype: torch.dtype,
                      dgrad: bool, cout: Optional[int] = None) -> dict:
    """Grid of the forward / data-gradient kernel (`conv_dgrad` with
    ``dgrad``, else `conv_cuda.conv_dilated_fwd`, whose output has `cout`
    channels, by default the input's) on the current card; the keys of
    `wgrad_launch_config`, the scratch being `conv_dgrad`'s per-block partial
    sums."""
    return _fwd_config(shape, kt, kf, dt, dtype, int(dgrad), cout)


def _fwd_config(shape, kt, kf, dt, dtype, mode: int, cout: Optional[int] = None) -> dict:
    # mode: 0 conv_dilated_fwd, 1 conv_dgrad, 2 conv_bn_act_fwd (one kernel body)
    B, T, F_, cin = shape
    args = (B, T, F_, cin, cin if cout is None else cout, kt, kf, dt,
            int(dtype == torch.bfloat16), mode)
    return dict(_one_wave_config("conv_fwd_launch_config", args, torch.cuda.current_device()))


def check_fwd_kernel_takes(kt: int, kf: int) -> None:
    """What the forward / data-gradient kernel is built for; anything else
    raises on the card (it never goes to the library conv)."""
    if kt > FWD_KERNEL_MAX_KT.get(kf, 0):
        raise NotImplementedError(
            f"the forward / data-gradient kernel takes at most {FWD_KERNEL_MAX_KT} time taps "
            f"by frequency taps, got ({kt}, {kf})"
        )


def wgrad_launch_config(shape: Sequence[int], kt: int, kf: int, dt: int, dtype: torch.dtype,
                        cout: Optional[int] = None) -> dict:
    """Grid of the weight-gradient kernel (`conv_wgrad`,
    `conv_cuda.conv_dilated_wgrad`) for inputs of `shape` and a cotangent of
    `cout` channels (by default the input's) on the current card: blocks
    (one wave: never more than ``resident_blocks``, what the card holds at
    once), threads, dynamic shared memory bytes, the fp32 scratch elements of
    its per-block partials, and its registers and local (spilled) bytes a
    thread."""
    B, T, F_, cin = shape
    args = (B, T, F_, cin, cin if cout is None else cout, kt, kf, dt, int(dtype == torch.bfloat16))
    return dict(_one_wave_config("conv_wgrad_launch_config", args, torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _one_wave_config(entry: str, args: tuple, device_index: int) -> dict:
    del device_index  # part of the key: the grid follows the card's SM count
    blocks, threads, resident, regs, local = (ctypes.c_int() for _ in range(5))
    smem, scratch = ctypes.c_longlong(), ctypes.c_longlong()
    err = getattr(_library(), entry)(
        *args, ctypes.byref(blocks), ctypes.byref(threads), ctypes.byref(smem),
        ctypes.byref(scratch), ctypes.byref(resident), ctypes.byref(regs), ctypes.byref(local),
    )
    _build.raise_on(err, entry)
    return {"blocks": blocks.value, "threads": threads.value, "smem_bytes": smem.value,
            "scratch_floats": scratch.value, "resident_blocks": resident.value,
            "registers": regs.value, "local_bytes": local.value}


# ---------------------------------------------------------------------------
# Activation, its derivative and the per-channel scalars
# ---------------------------------------------------------------------------


def _mish_t_sig(z: torch.Tensor):
    """tanh(softplus(z)) and sigmoid(z) from one exponential, as the Pallas
    kernels compute them: u = e^min(z, 20), t = ((1+u)² − 1) / ((1+u)² + 1)."""
    u = torch.exp(torch.clamp(z, max=20.0))
    w = (1.0 + u) * (1.0 + u)
    return (w - 1.0) / (w + 1.0), u / (1.0 + u)


def _act(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "mish":
        return z * _mish_t_sig(z)[0]
    if act == "relu":
        return torch.clamp(z, min=0.0)
    raise ValueError(f"unknown activation {act!r}")


def _act_deriv(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "mish":
        t, sig = _mish_t_sig(z)
        return t + z * (1.0 - t * t) * sig
    if act == "relu":
        return (z > 0).to(z.dtype)
    raise ValueError(f"unknown activation {act!r}")


def _scal_table(mean, var, scale, bias, mean_dz=None, mean_dzx=None, eps: float = 1e-5):
    """fp32 ``[8, C]`` per-channel constants: inv, shift, mean, r, mean(dz),
    mean(dz·x̂), two rows of zeros."""
    r = torch.rsqrt(var + eps)
    inv = scale * r
    zero = torch.zeros_like(mean)
    rows = [inv, bias - mean * inv, mean, r,
            zero if mean_dz is None else mean_dz, zero if mean_dzx is None else mean_dzx,
            zero, zero]
    return torch.stack(rows).float().contiguous()


def _mean_var(stats: torch.Tensor, n: int):
    """``[2, C]`` (sum, sum of squares) → biased (mean, var), var clamped at 0."""
    mean = stats[0] / n
    return mean, torch.clamp(stats[1] / n - mean * mean, min=0.0)


def pack_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[kt, kf, Cin, Cout]`` in the kernels' operand type and layout."""
    return weight.to(dtype).contiguous()


def pack_weight_flipped(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The data gradient's weights: taps flipped, channels transposed."""
    return weight.to(dtype).flip(0, 1).transpose(2, 3).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def _padding(kt: int, kf: int, dt: int) -> Tuple[int, int]:
    return (kt - 1) * dt // 2, (kf - 1) // 2


def _prologue(x: torch.Tensor, scal: torch.Tensor, act: Optional[str], on: bool) -> torch.Tensor:
    """act(x·inv + shift) in fp32, rounded to x's type."""
    if not on:
        return x
    return _act(x.float() * scal[_S_INV] + scal[_S_SHIFT], act).to(x.dtype)


def _padded(y: torch.Tensor, kt: int, kf: int, dt: int) -> torch.Tensor:
    """`y` ``[B, T, F, C]`` in fp32 with the "same" conv's zero halo."""
    pad_t, pad_f = _padding(kt, kf, dt)
    return F.pad(y.float(), (0, 0, pad_f, pad_f, pad_t, pad_t))


def _conv_core(y: torch.Tensor, w: torch.Tensor, dt: int) -> torch.Tensor:
    """fp32 "same" conv of channels-last `y` with ``[kt, kf, Cin, Cout]``
    weights, both upcast to fp32 first: exact products, fp32 sums.  Written
    as one matrix product per tap, so that on the card no library conv
    algorithm (Winograd, FFT) trades exactness away."""
    kt, kf = w.shape[:2]
    T, F_ = y.shape[1:3]
    yp, wf = _padded(y, kt, kf, dt), w.float()
    out = None
    for i in range(kt):
        for j in range(kf):
            term = yp[:, i * dt:i * dt + T, j:j + F_] @ wf[i, j]
            out = term if out is None else out.add_(term)
    return out


def conv_bn_act_fwd_ref(x, w, bias, scal, dt: int, act: Optional[str], prologue: bool):
    """``x [B, T, F, C]``, ``w [kt, kf, C, C]`` (bf16 or fp32), ``bias [C]``
    and ``scal [8, C]`` fp32 → ``raw [B, T, F, C]`` in x's type and
    ``stats [2, C]`` fp32 (sum and sum of squares of the rounded raw)."""
    y = _prologue(x, scal, act, prologue)
    raw = (_conv_core(y, w, dt) + bias.float()).to(x.dtype).contiguous()
    rf = raw.float()
    return raw, torch.stack([rf.sum(dim=(0, 1, 2)), (rf * rf).sum(dim=(0, 1, 2))])


def conv_draw_prologue_ref(dy, x, scal, act: str):
    """The BatchNorm + activation backward of the raw conv output ``x [B, T,
    F, C]`` under the cotangent ``dy`` (same shape and type), the Pallas
    kernels' `_prologue_draw_inplace`: ``d_raw = inv·(dy·act'(z) − mean(dz)
    − x̂·mean(dz·x̂))`` with ``z = x·inv + shift`` and ``x̂ = (x − mean)·r``
    (rows 0–5 of `scal`), in fp32 from the operand-type inputs, rounded once
    to dy's type."""
    x32 = x.float()
    dz = dy.float() * _act_deriv(x32 * scal[_S_INV] + scal[_S_SHIFT], act)
    xhat = (x32 - scal[_S_MEAN]) * scal[_S_R]
    return (scal[_S_INV] * (dz - scal[_S_MDZ] - xhat * scal[_S_MDZX])).to(dy.dtype).contiguous()


def conv_dgrad_ref(d_raw, w_flipped, dt: int):
    """``d_raw [B, T, F, C]``, ``w_flipped`` from `pack_weight_flipped` →
    ``dx`` in d_raw's type and ``dbias [C]`` fp32 (the conv bias gradient)."""
    dx = _conv_core(d_raw, w_flipped, dt).to(d_raw.dtype).contiguous()
    return dx, d_raw.float().sum(dim=(0, 1, 2))


def conv_wgrad_prologue_ref(x, scal, act: str):
    """`conv_wgrad_ref`'s input: the prologue alone."""
    return _prologue(x, scal, act, True)


def conv_wgrad_ref(x_in, d_raw, scal, kt: int, kf: int, dt: int, act: Optional[str],
                   lhs_prologue: bool):
    """``dW[i, j, c, co] = Σ y[b, t + i·dt − pad_t, f + j − pad_f, c] ·
    d_raw[b, t, f, co]`` in fp32, ``[kt, kf, C, C]``; y is `x_in` through the
    forward's prologue (or `x_in` itself)."""
    y = _prologue(x_in, scal, act, lhs_prologue)
    T, F_, C = x_in.shape[1:]
    yp = _padded(y, kt, kf, dt)
    d2 = d_raw.float().reshape(-1, C)
    dw = torch.empty(kt, kf, C, C, dtype=torch.float32, device=x_in.device)
    for i in range(kt):
        for j in range(kf):
            dw[i, j] = yp[:, i * dt:i * dt + T, j:j + F_].reshape(-1, C).t() @ d2
    return dw


# ---------------------------------------------------------------------------
# Checks and kernel launches
# ---------------------------------------------------------------------------


def _check(acts: Sequence[torch.Tensor], w_shape, fp32s, dt: int, act, prologue: bool) -> None:
    x = acts[0]
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"activations must be [B, T, F, C], got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"operands must be bf16 or fp32, got {x.dtype}")
    C = x.shape[-1]
    kt, kf = w_shape[:2]
    if tuple(w_shape) != (kt, kf, C, C) or kt % 2 == 0 or kf % 2 == 0:
        raise ValueError(f"weights must be [kt, kf, {C}, {C}] with odd kt, kf, got {tuple(w_shape)}")
    if dt < 1:
        raise ValueError(f"time dilation must be >= 1, got {dt}")
    if prologue and act not in ("mish", "relu"):
        raise ValueError(f"a prologue needs act 'mish' or 'relu', got {act!r}")
    for a in acts:
        if a.dtype != x.dtype or a.shape != x.shape:
            raise ValueError("activations must share one shape and type")
    for name, t, shape in fp32s:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} fp32, got {tuple(t.shape)} {t.dtype}")
    for t in (*acts, *(t for _, t, _ in fp32s)):
        if t.device != x.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if x.device.type == "cuda" and C % CHANNEL_SLAB:
        raise NotImplementedError(
            f"the chain's CUDA kernels take a multiple of {CHANNEL_SLAB} channels, got {C}")


def _check_weight(w: torch.Tensor, x: torch.Tensor) -> None:
    if w.dim() != 4 or w.dtype != x.dtype or w.device != x.device or not w.is_contiguous():
        raise ValueError(
            f"weights must be contiguous [kt, kf, C, C] {x.dtype} on {x.device}, "
            f"got {tuple(w.shape)} {w.dtype} on {w.device}"
        )


def _launch_conv_bn_act_fwd(x, w, bias, scal, dt, act, prologue):
    B, T, F_, C = x.shape
    kt, kf = w.shape[:2]
    check_fwd_kernel_takes(kt, kf)
    # the activated input: written once by the prologue pass, dropped after
    y = _launch_conv_wgrad_prologue(x, scal, act) if prologue else x
    raw = torch.empty_like(x)
    stats = torch.empty(2, C, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        n = launch_config(x.shape, kt, kf, dt, x.dtype)["scratch_floats"]
        scratch = torch.empty(n, dtype=torch.float32, device=x.device)  # per-block partials
        err = lib.conv_bn_act_fwd(
            y.data_ptr(), w.data_ptr(), bias.data_ptr(), raw.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), B, T, F_, C, kt, kf, dt, int(x.dtype == torch.bfloat16),
            _build.stream(x),
        )
    _build.raise_on(err, "conv_bn_act_fwd")
    LAUNCHES["conv_bn_act_fwd"] += 1
    return raw, stats


def _launch_conv_dgrad(d_raw, w_flipped, dt):
    B, T, F_, C = d_raw.shape
    kt, kf = w_flipped.shape[:2]
    check_fwd_kernel_takes(kt, kf)
    dx = torch.empty_like(d_raw)
    dbias = torch.empty(C, dtype=torch.float32, device=d_raw.device)
    lib = _library()
    with torch.cuda.device(d_raw.device):
        n = fwd_launch_config(d_raw.shape, kt, kf, dt, d_raw.dtype, dgrad=True)["scratch_floats"]
        scratch = torch.empty(n, dtype=torch.float32, device=d_raw.device)  # per-block partials
        err = lib.conv_dgrad(
            d_raw.data_ptr(), w_flipped.data_ptr(), dx.data_ptr(), dbias.data_ptr(),
            scratch.data_ptr(), B, T, F_, C, kt, kf, dt,
            int(d_raw.dtype == torch.bfloat16), _build.stream(d_raw),
        )
    _build.raise_on(err, "conv_dgrad")
    LAUNCHES["conv_dgrad"] += 1
    return dx, dbias


def _launch_conv_wgrad_prologue(x, scal, act):
    B, T, F_, C = x.shape
    y = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.conv_wgrad_prologue(
            x.data_ptr(), scal.data_ptr(), y.data_ptr(), B, T, F_, C, _ACT_CODE[act],
            int(x.dtype == torch.bfloat16), _build.stream(x),
        )
    _build.raise_on(err, "conv_wgrad_prologue")
    LAUNCHES["conv_wgrad_prologue"] += 1
    return y


def _launch_conv_draw_prologue(dy, x, scal, act):
    B, T, F_, C = dy.shape
    d_raw = torch.empty_like(dy)
    lib = _library()
    with torch.cuda.device(dy.device):
        err = lib.conv_draw_prologue(
            dy.data_ptr(), x.data_ptr(), scal.data_ptr(), d_raw.data_ptr(), B, T, F_, C,
            _ACT_CODE[act], int(dy.dtype == torch.bfloat16), _build.stream(dy),
        )
    _build.raise_on(err, "conv_draw_prologue")
    LAUNCHES["conv_draw_prologue"] += 1
    return d_raw


def launch_wgrad_kernel(y, d, kt, kf, dt):
    """The weight-gradient kernel on CUDA tensors: ``dW`` fp32 ``[kt, kf,
    Cin, Cout]`` of the conv whose (already activated) input is `y` ``[B, T,
    F, Cin]`` and whose output cotangent is `d` ``[B, T, F, Cout]``.  Counted
    by its callers, `conv_wgrad` and `conv_cuda.conv_dilated_wgrad`."""
    B, T, F_, cin = y.shape
    cout = d.shape[-1]
    dw = torch.empty(kt, kf, cin, cout, dtype=torch.float32, device=y.device)
    lib = _library()
    with torch.cuda.device(y.device):
        n = wgrad_launch_config(y.shape, kt, kf, dt, y.dtype, cout)["scratch_floats"]
        scratch = torch.empty(n, dtype=torch.float32, device=y.device)  # per-block partials
        err = lib.conv_wgrad(
            y.data_ptr(), d.data_ptr(), dw.data_ptr(), scratch.data_ptr(), B, T, F_, cin, cout,
            kt, kf, dt, int(y.dtype == torch.bfloat16), _build.stream(y),
        )
    _build.raise_on(err, "conv_wgrad")
    return dw


def _launch_conv_wgrad(x_in, d_raw, scal, kt, kf, dt, act, lhs_prologue):
    # the activated input: written once by the prologue pass, dropped after
    y = _launch_conv_wgrad_prologue(x_in, scal, act) if lhs_prologue else x_in
    dw = launch_wgrad_kernel(y, d_raw, kt, kf, dt)
    LAUNCHES["conv_wgrad"] += 1
    return dw


def conv_bn_act_fwd(x, w, bias, scal, dt: int, act: Optional[str], prologue: bool):
    """Conv with the previous layer's BN affine + activation on its input,
    bias, and the output's statistics (kernel on CUDA, plain version on the
    CPU); see `conv_bn_act_fwd_ref` for shapes and dtypes."""
    C = x.shape[-1] if x.dim() == 4 else 0
    _check_weight(w, x)
    _check((x,), w.shape, (("bias", bias, (C,)), ("scal", scal, (8, C))), dt, act, prologue)
    fn = _build.dispatch(x.device, _launch_conv_bn_act_fwd, conv_bn_act_fwd_ref)
    return fn(x, w, bias, scal, dt, act, prologue)


def conv_dgrad(d_raw, w_flipped, dt: int):
    """Data gradient of the conv and the conv bias gradient (kernel on CUDA,
    plain version on the CPU); see `conv_dgrad_ref`."""
    _check_weight(w_flipped, d_raw)
    _check((d_raw,), w_flipped.shape, (), dt, None, False)
    return _build.dispatch(d_raw.device, _launch_conv_dgrad, conv_dgrad_ref)(d_raw, w_flipped, dt)


def conv_draw_prologue(dy, x, scal, act: str):
    """``round(inv·(dy·act'(z) − mean(dz) − x̂·mean(dz·x̂)))`` in dy's type
    (kernel on CUDA, plain version on the CPU); see `conv_draw_prologue_ref`.
    Followed by `conv_dgrad` it is `_dgrad_kernel`'s ``prologue=True``
    branch, by `conv_wgrad` its ``rhs_prologue`` branch."""
    if x is None or scal is None or act not in ("mish", "relu"):
        raise ValueError("a d_raw prologue needs x, a [8, C] scal table and act 'mish' or 'relu'")
    C = dy.shape[-1] if dy.dim() == 4 else 0
    _check((dy, x), (1, 1, C, C), (("scal", scal, (8, C)),), 1, act, True)
    fn = _build.dispatch(dy.device, _launch_conv_draw_prologue, conv_draw_prologue_ref)
    return fn(dy, x, scal, act)


def conv_wgrad_prologue(x, scal, act: str):
    """``round(act(x·inv + shift))`` in x's type, the input `conv_wgrad`
    multiplies (kernel on CUDA, plain version on the CPU)."""
    C = x.shape[-1] if x.dim() == 4 else 0
    _check((x,), (1, 1, C, C), (("scal", scal, (8, C)),), 1, act, True)
    fn = _build.dispatch(x.device, _launch_conv_wgrad_prologue, conv_wgrad_prologue_ref)
    return fn(x, scal, act)


def conv_wgrad(x_in, d_raw, scal, kt: int, kf: int, dt: int, act: Optional[str],
               lhs_prologue: bool):
    """fp32 weight gradient of the conv (kernel on CUDA, plain version on
    the CPU); see `conv_wgrad_ref`."""
    C = x_in.shape[-1] if x_in.dim() == 4 else 0
    _check((x_in, d_raw), (kt, kf, C, C), (("scal", scal, (8, C)),), dt, act, lhs_prologue)
    fn = _build.dispatch(x_in.device, _launch_conv_wgrad, conv_wgrad_ref)
    return fn(x_in, d_raw, scal, kt, kf, dt, act, lhs_prologue)


# ---------------------------------------------------------------------------
# The BN + activation backward between two convs (plain passes)
# ---------------------------------------------------------------------------


def _dz_xhat(dy: torch.Tensor, raw: torch.Tensor, scal: torch.Tensor, act: str):
    """dz = dy·act'(z) and x̂ = (raw − mean)·r in the compute dtype."""
    cd = dy.dtype
    z = raw * scal[_S_INV].to(cd) + scal[_S_SHIFT].to(cd)
    dz = dy * _act_deriv(z, act)
    xhat = (raw - scal[_S_MEAN].to(cd)) * scal[_S_R].to(cd)
    return dz, xhat


def _stage1(dy, raw, scal, act: str):
    """Per-channel Σ dz and Σ dz·x̂ (fp32 sums of compute-dtype terms): the
    reduce stage of the BN + activation backward.  Also returns dz and x̂:
    the JAX pass recomputes them inside `_materialize_draw`'s one fused XLA
    pass; eager PyTorch would spend some twenty elementwise passes on that,
    so the chain keeps the two tensors for the one layer's turn instead."""
    dz, xhat = _dz_xhat(dy, raw, scal, act)
    return dz.float().sum(dim=(0, 1, 2)), (dz * xhat).float().sum(dim=(0, 1, 2)), dz, xhat


def _materialize_draw(dz, xhat, scal):
    """``d_raw = inv·(dz − mean(dz) − x̂·mean(dz·x̂))`` in the compute dtype,
    from `_stage1`'s dz and x̂, with the two means in rows 4 and 5 of `scal`."""
    cd = dz.dtype
    return scal[_S_INV].to(cd) * (dz - scal[_S_MDZ].to(cd) - xhat * scal[_S_MDZX].to(cd))


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------


class _Chain(torch.autograd.Function):
    """``cfg = (layer_specs, act, eps)``; tensors flattened as ``y1, *weights,
    *conv_biases, *bn_scales, *bn_biases``; returns ``raw, *means, *vars``."""

    @staticmethod
    def forward(ctx, cfg, y1, *flat):
        specs, act, eps = cfg
        nL = len(specs)
        weights, cbiases = flat[:nL], flat[nL:2 * nL]
        scales, bbiases = flat[2 * nL:3 * nL - 1], flat[3 * nL - 1:]
        cd = y1.dtype
        n = y1.shape[0] * y1.shape[1] * y1.shape[2]
        zero_scal = torch.zeros(8, y1.shape[-1], dtype=torch.float32, device=y1.device)
        x = y1.contiguous()
        inputs, means, vars_ = [], [], []
        scal = zero_scal
        for idx, (_, dt) in enumerate(specs):
            inputs.append(x)
            x, stats = conv_bn_act_fwd(
                x, pack_weight(weights[idx], cd), cbiases[idx].float().contiguous(), scal,
                dt, act if idx else None, idx > 0,
            )
            world = sum_over_ranks_(stats)  # the global batch's, under a process group
            mean, var = _mean_var(stats, n * world)
            means.append(mean)
            vars_.append(var)
            if idx + 1 < nL:
                scal = _scal_table(mean, var, scales[idx], bbiases[idx], eps=eps)
        ctx.cfg = cfg
        ctx.save_for_backward(*inputs, *means, *vars_, *weights, *scales, *bbiases)
        ctx.mark_non_differentiable(*means, *vars_)
        return (x, *means, *vars_)

    @staticmethod
    def backward(ctx, d_raw_out, *_stat_cotangents):
        # the statistics feed only the running averages, never a loss
        specs, act, eps = ctx.cfg
        nL = len(specs)
        saved = ctx.saved_tensors
        inputs, means, vars_ = saved[:nL], saved[nL:2 * nL], saved[2 * nL:3 * nL]
        weights = saved[3 * nL:4 * nL]
        scales, bbiases = saved[4 * nL:5 * nL - 1], saved[5 * nL - 1:]
        cd = inputs[0].dtype
        n = inputs[0].shape[0] * inputs[0].shape[1] * inputs[0].shape[2]
        zero_scal = torch.zeros(8, inputs[0].shape[-1], dtype=torch.float32,
                                device=inputs[0].device)
        d_weights, d_cbias = [None] * nL, [None] * nL
        d_scales, d_bbiases = [None] * (nL - 1), [None] * (nL - 1)
        d_y1 = None
        d_raw = d_raw_out.to(cd).contiguous()  # cotangent of layer idx's raw output
        for idx in range(nL - 1, -1, -1):
            (kt, kf), dt = specs[idx]
            if idx > 0:
                prev = (means[idx - 1], vars_[idx - 1], scales[idx - 1], bbiases[idx - 1])
                scal_prev = _scal_table(*prev, eps=eps)
            else:
                scal_prev = zero_scal
            d_weights[idx] = conv_wgrad(
                inputs[idx], d_raw, scal_prev, kt, kf, dt, act if idx else None, idx > 0
            ).to(weights[idx].dtype)
            dy, dbias = conv_dgrad(d_raw, pack_weight_flipped(weights[idx], cd), dt)
            d_cbias[idx] = dbias
            if idx == 0:
                d_y1 = dy  # cotangent of the chain's (already activated) input
                break
            # dy is the cotangent of act(BN(raw_{idx-1})): through the
            # statistics-aware BN + activation backward to raw_{idx-1}'s
            s_dz, s_dzx, dz, xhat = _stage1(dy, inputs[idx], scal_prev, act)
            d_bbiases[idx - 1] = s_dz  # this rank's: the gradient all-reduce adds them
            d_scales[idx - 1] = s_dzx
            sums = torch.stack([s_dz, s_dzx])  # every rank's, for d_raw
            n_all = n * sum_over_ranks_(sums)
            scal_full = _scal_table(*prev, mean_dz=sums[0] / n_all, mean_dzx=sums[1] / n_all,
                                    eps=eps)
            d_raw = _materialize_draw(dz, xhat, scal_full).contiguous()
            del dy, dz, xhat
        return (None, d_y1, *d_weights, *d_cbias, *d_scales, *d_bbiases)


def make_chain(layer_specs, act: str, eps: float = 1e-5):
    """The fused train-mode conv chain for ``layer_specs = [((kt, kf), dt),
    ...]``.  Returns ``chain(y1, weights, conv_biases, bn_scales, bn_biases)
    -> (raw, means, vars)`` where

    - ``y1 [B, T, F, C]`` is the activated output of the layer before the
      chain, in the compute dtype;
    - ``weights`` ``[kt, kf, C, C]`` and ``conv_biases`` ``[C]``, one per
      layer (cast to the compute dtype per call);
    - ``bn_scales`` / ``bn_biases``: the BatchNorm affines of layers
      0..n-2, applied inside the chain; the last layer's BN + activation is
      the caller's, on the returned ``raw``;
    - ``means`` / ``vars``: each layer's fp32 biased batch statistics of its
      raw output, for the running averages (not differentiable).
    """
    cfg = (tuple(((int(k[0]), int(k[1])), int(d)) for k, d in layer_specs), act, float(eps))
    nL = len(cfg[0])
    if act not in ("mish", "relu"):
        raise ValueError(f"unknown activation {act!r}")

    def chain(y1, weights, conv_biases, bn_scales, bn_biases):
        if not (len(weights) == len(conv_biases) == nL
                and len(bn_scales) == len(bn_biases) == nL - 1):
            raise ValueError(f"expected {nL} weights and biases and {nL - 1} BatchNorm affines")
        out = _Chain.apply(cfg, y1, *weights, *conv_biases, *bn_scales, *bn_biases)
        return out[0], tuple(out[1:1 + nL]), tuple(out[1 + nL:])

    return chain
