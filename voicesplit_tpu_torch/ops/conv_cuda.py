"""Time-dilated "same" 2-D convolution as two CUDA kernels
(`csrc/conv_fwd.cu`, `csrc/conv_wgrad.cu`), their plain PyTorch versions,
the differentiable conv built on them and the routing condition that the
mask network asks (counterpart of `voicesplit_tpu/ops/conv_pallas.py`).

Opt-in with ``VOICESPLIT_PALLAS_CONV=1`` (the JAX package's variable): the
heavy conv layers of the mask network, a (7,1) layer and five (5,5) layers
with time dilation 1..16 over ``[B, T, F=601, C=64]`` (and the wide variant's
extra (5,5) blocks at time dilation 32·2^i, `configs/voicesplit_wide.json`:
32, whose outer taps reach 64 rows to each side), then compute their
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
  that the fused chain's `conv_wgrad` also launches after its prologue pass.

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
for its forward and its data gradient.  The kernels take 64 channels in and
out, bf16 or fp32 operands (fp32 products on CUDA cores, not TF32) and kf in
(1, 3, 5), the forward at most `conv_fused.FWD_KERNEL_MAX_KT` time taps.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import torch

from voicesplit_tpu_torch.ops import _build
from voicesplit_tpu_torch.ops.conv_fused import (
    KERNEL_CHANNELS, _conv_core, _padded, check_fwd_kernel_takes, launch_wgrad_kernel,
)

# kernel launches per wrapper, for showing that a run went through them
LAUNCHES = {"conv_dilated_fwd": 0, "conv_dilated_wgrad": 0}

_WGRAD_KF = (1, 3, 5)  # frequency tap counts the weight-gradient kernel is built for
_MAX_TAPS = 7

_declared = False


def pallas_conv_enabled() -> bool:
    """Opt-in, with the JAX package's variable: ``VOICESPLIT_PALLAS_CONV=1``."""
    return os.environ.get("VOICESPLIT_PALLAS_CONV", "0") == "1"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library() -> ctypes.CDLL:
    global _declared
    if not _declared:
        p, i = ctypes.c_void_p, ctypes.c_int
        _build.declare({
            "conv_dilated_fwd": [p] * 3 + [i] * 7 + [p],
        })
        _declared = True
    return _build.library()


def flip_weight(w: torch.Tensor) -> torch.Tensor:
    """The data gradient's weights: taps flipped, channels transposed
    (``[kt, kf, Cin, Cout]`` → ``[kt, kf, Cout, Cin]``)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


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
    """What the CUDA kernels are built for; anything else raises on the card
    (it never goes to the library conv)."""
    if cin != KERNEL_CHANNELS or cout != KERNEL_CHANNELS:
        raise NotImplementedError(
            f"the CUDA kernels take {KERNEL_CHANNELS} channels in and out, got {cin} and {cout}"
        )
    if not wgrad:
        check_fwd_kernel_takes(kt, kf)
    elif kt > _MAX_TAPS or kf not in _WGRAD_KF:
        raise NotImplementedError(
            f"the weight-gradient kernel takes at most {_MAX_TAPS} time taps and kf in "
            f"{_WGRAD_KF}, got ({kt}, {kf})"
        )


def _launch_conv_dilated_fwd(x, w, dt):
    B, T, F_, cin = x.shape
    kt, kf, _, cout = w.shape
    _check_kernel_takes(cin, cout, kt, kf, wgrad=False)
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.conv_dilated_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), B, T, F_, kt, kf, dt,
            int(x.dtype == torch.bfloat16), _build.stream(x),
        )
    _build.raise_on(err, "conv_dilated_fwd")
    LAUNCHES["conv_dilated_fwd"] += 1
    return out


def _launch_conv_dilated_wgrad(x, dy, kt, kf, dt):
    _check_kernel_takes(x.shape[-1], dy.shape[-1], kt, kf, wgrad=True)
    dw = launch_wgrad_kernel(x, dy, kt, kf, dt)
    LAUNCHES["conv_dilated_wgrad"] += 1
    return dw


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
