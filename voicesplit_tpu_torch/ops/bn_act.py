"""Eval-mode BatchNorm + activation (counterpart of
`voicesplit_tpu/ops/bn_act.py::folded_bn_act_eval`).

The JAX op works in the TPU's folded frequency layout
(`ops/conv_fold.py`), which exists only to fill a 128-wide matrix unit;
the port keeps the plain NCHW layout of its "same" convolutions, so there
is no pad column to zero.  The order of operations is the JAX op's: the
per-channel scale and shift in float32, cast to the compute dtype, then
``z = x * inv + shift`` and the activation in that dtype.

The training-mode op and its two-pass backward come with the training
slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) (reference `utils/generic_utils.py:376-399`)."""
    return x * torch.tanh(F.softplus(x))


def activation(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "mish":
        return mish(z)
    if act == "relu":
        return torch.relu(z)
    raise ValueError(f"unknown activation {act!r}")


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
