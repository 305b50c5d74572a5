"""Spectrogram amplitude/dB (de)normalization (voicefilter backend).

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
