"""Power-law compressed spectral loss (counterpart of
`voicesplit_tpu/losses/power_law.py`; reference
`utils/generic_utils.py:353-373`, λ from arXiv:1811.07030)."""

from __future__ import annotations

import torch

# ε of the signed compression (the JAX function's `epsilon` default)
_EPS = 1e-16


def power_law_compressed_loss(
    prediction: torch.Tensor,
    target: torch.Tensor,
    power: float,
    complex_loss_ratio: float,
) -> torch.Tensor:
    """MSE(|t|^p, |p|^p) + λ·MSE(t^p, p^p) over spectrograms of any shape.

    The compression is signed, ``sign(x)·(|x| + ε)^p``: the reference's
    ``x^p`` on its non-negative specs, finite where a spec goes negative;
    ε keeps the gradient of ``x^p`` finite at zero.
    """

    def compress(x):
        return torch.sign(x) * torch.pow(torch.abs(x) + _EPS, power)

    pred_c = compress(prediction)
    tgt_c = compress(target)
    spec_loss = torch.mean(torch.square(torch.abs(tgt_c) - torch.abs(pred_c)))
    complex_loss = torch.mean(torch.square(tgt_c - pred_c))
    return spec_loss + complex_loss * complex_loss_ratio
