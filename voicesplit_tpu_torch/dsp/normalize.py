"""Spectrogram amplitude/dB (de)normalization and preemphasis.

Counterpart of `voicesplit_tpu/dsp/normalize.py`: ``amp_to_db`` floors at
1e-5, ``normalize_db`` maps ``[min_level_db, 0] dB`` to ``[0, 1]`` with
clipping (reference `utils/audio_processor.py:537-547`).
"""

from __future__ import annotations

import torch


def amp_to_db(x: torch.Tensor) -> torch.Tensor:
    """20*log10(max(1e-5, x))."""
    return 20.0 * torch.log10(torch.clamp(x, min=1e-5))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    """10^(x/20)."""
    return torch.pow(10.0, x * 0.05)


def normalize_db(S: torch.Tensor, min_level_db: float = -100.0) -> torch.Tensor:
    """clip(S / -min_level_db, -1, 0) + 1."""
    return torch.clamp(S / -min_level_db, -1.0, 0.0) + 1.0


def denormalize_db(S: torch.Tensor, min_level_db: float = -100.0) -> torch.Tensor:
    """(clip(S, 0, 1) - 1) * -min_level_db."""
    return (torch.clamp(S, 0.0, 1.0) - 1.0) * -min_level_db


def preemphasis(y: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[n] - coef*y[n-1] (FIR; reference `utils/audio_processor.py:191-194`)."""
    if coef == 0.0:
        return y
    return torch.cat([y[..., :1], y[..., 1:] - coef * y[..., :-1]], dim=-1)


def inv_preemphasis(y: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """Inverse (IIR) filter of `preemphasis`: x[n] = y[n] + coef*x[n-1].

    ``x[n] = Σ_k coef^k y[n-k]`` by recursive doubling: after the pass with
    shift s every sample holds its sum over the last 2s inputs, so
    ``ceil(log2 L)`` vectorized passes replace the length-L loop (the JAX
    package uses an associative scan for the same reason; the sums are
    grouped differently)."""
    if coef == 0.0:
        return y
    x = y
    s, m = 1, coef
    L = y.shape[-1]
    while s < L:
        x = torch.cat([x[..., :s], x[..., s:] + m * x[..., :-s]], dim=-1)
        s, m = 2 * s, m * m
    return x
