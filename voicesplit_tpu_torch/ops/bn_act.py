"""BatchNorm + activation in eval and train mode (counterparts of
`voicesplit_tpu/ops/bn_act.py::folded_bn_act_eval` and
``folded_bn_act_train``).

The JAX op works in the TPU's folded frequency layout
(`ops/conv_fold.py`), which exists only to fill a 128-wide matrix unit;
the port keeps the plain NCHW layout of its "same" convolutions, so there
is no pad column to zero.  The order of operations is the JAX op's: the
per-channel scale and shift in float32, cast to the compute dtype, then
``z = x * inv + shift`` and the activation in that dtype.

The training-mode op `bn_act_train` normalizes with the batch statistics
and has the JAX op's hand-written backward: it saves only ``x`` and the
``[C]`` statistics, and its backward recomputes ``z`` and ``act'(z)`` in
two stages (a per-channel reduce, then the ``dx`` pass) instead of keeping
every intermediate of the activation alive:

    dz  = dy * act'(z)
    dβ  = Σ dz            dγ = Σ dz·x̂          (per channel, over B, T, F)
    dx  = γ·r·(dz − mean(dz) − x̂·mean(dz·x̂))

with x̂ = (x − μ)·r and r = rsqrt(var + ε).

Under a process group (`parallel/mesh.py`) the statistics are the global
batch's: Σx and Σx² are summed over the ranks before the mean and variance
are taken, and so are Σdz and Σdz·x̂ before dx, in one packed ``[2, C]``
buffer a call.  dγ and dβ stay this rank's own sums: the gradient all-reduce
of the train step adds them up.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from voicesplit_tpu_torch.parallel.mesh import sum_over_ranks_


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) (reference `utils/generic_utils.py:376-399`)."""
    return x * torch.tanh(F.softplus(x))


def activation(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "mish":
        return mish(z)
    if act == "relu":
        return torch.relu(z)
    raise ValueError(f"unknown activation {act!r}")


def activation_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    """act'(z): mish' = t + z·(1 − t²)·σ(z) with t = tanh(softplus(z))."""
    if act == "mish":
        t = torch.tanh(F.softplus(z))
        return t + z * (1.0 - t * t) * torch.sigmoid(z)
    if act == "relu":
        return (z > 0).to(z.dtype)
    raise ValueError(f"unknown activation {act!r}")


def _channel(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[C]`` → ``[C, 1, 1]`` in `dtype`, to broadcast over NCHW."""
    return v.to(dtype)[:, None, None]


def batch_stats(x: torch.Tensor):
    """fp32 biased mean and var per channel over (B, T, F) and every rank,
    as E[x²] − E[x]² clamped at 0 (the JAX op's ``_stats``)."""
    xs = x.float()
    sums = torch.stack([xs.sum(dim=(0, 2, 3)), (xs * xs).sum(dim=(0, 2, 3))])
    n = x.numel() // x.shape[1] * sum_over_ranks_(sums)
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    return mean, var


class _BNActTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, act, epsilon):
        mean, var = batch_stats(x)
        r = torch.rsqrt(var + epsilon)
        z = x * _channel(scale * r, x.dtype) + _channel(bias - mean * scale * r, x.dtype)
        ctx.save_for_backward(x, scale, bias, mean, r)
        ctx.act = act
        ctx.mark_non_differentiable(mean, var)
        return activation(z, act), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        # the statistics feed only the running averages, never a loss
        x, scale, bias, mean, r = ctx.saved_tensors
        cd = x.dtype
        n = x.numel() // x.shape[1]
        dy = dy.to(cd)
        inv = _channel(scale * r, cd)
        shift = _channel(bias - mean * scale * r, cd)
        xmean, xscale = _channel(mean, cd), _channel(r, cd)

        def recompute():
            dz = dy * activation_grad(x * inv + shift, ctx.act)
            return dz, (x - xmean) * xscale

        # stage 1: per-channel sums of dz and dz·x̂, this rank's, then every rank's
        dz, xhat = recompute()
        dbias = dz.float().sum(dim=(0, 2, 3))
        dscale = (dz * xhat).float().sum(dim=(0, 2, 3))
        del dz, xhat
        sums = torch.stack([dbias, dscale])
        n *= sum_over_ranks_(sums)
        # stage 2: dx, recomputing z rather than keeping stage 1's tensors
        dz, xhat = recompute()
        dx = inv * (dz - _channel(sums[0] / n, cd) - xhat * _channel(sums[1] / n, cd))
        return dx.to(cd), dscale, dbias, None, None


def bn_act_train(
    x: torch.Tensor,  # [B, C, T, F] conv output in the compute dtype
    scale: torch.Tensor,  # [C] fp32
    bias: torch.Tensor,  # [C] fp32
    act: str,
    epsilon: float = 1e-5,
):
    """BN with the batch's statistics, then the activation, channels on
    dim 1; returns ``(y, mean, var)`` with the fp32 biased batch
    statistics for the caller's running averages (not differentiable)."""
    return _BNActTrain.apply(x, scale, bias, act, epsilon)


def bn_act_eval(
    x: torch.Tensor,  # [B, C, T, F] conv output in the compute dtype
    scale: torch.Tensor,  # [C] fp32
    bias: torch.Tensor,  # [C] fp32
    running_mean: torch.Tensor,  # [C] fp32
    running_var: torch.Tensor,  # [C] fp32
    act: str,
    epsilon: float = 1e-5,
) -> torch.Tensor:
    """BN with running statistics, then the activation, channels on dim 1."""
    r = torch.rsqrt(running_var + epsilon)
    inv = (scale * r).to(x.dtype)
    shift = (bias - running_mean * scale * r).to(x.dtype)
    z = x * inv[:, None, None] + shift[:, None, None]
    return activation(z, act)
