"""Griffin-Lim phase reconstruction (PyTorch counterpart of
`voicesplit_tpu/dsp/griffin_lim.py`).

Reference behavior: `utils/audio_processor.py:516-523` — random initial
phase, then `griffin_lim_iters` rounds of iSTFT → STFT → phase replacement.
Each round is two float32 basis matmuls of `dsp/stft.py` on the
magnitude's device.

The initial phase is drawn apart from the loop (`griffin_lim_angles`), from
an explicit ``torch.Generator`` on the CPU, so that the card and the CPU
start from the same angles and a caller may pass its own.  The default
draw (seed 0) is not the JAX package's: ``jax.random`` bits cannot be
reproduced in torch, so holding the two packages to each other means
passing JAX's angles in.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from voicesplit_tpu_torch.dsp.stft import istft, stft


def griffin_lim_angles(shape: Sequence[int], generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Initial phases ``2π·U[0, 1)`` of `shape`, float32 on the CPU, from
    `generator` (a CPU generator; default: one seeded with 0)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return 2.0 * math.pi * torch.rand(tuple(shape), generator=generator)


def griffin_lim(
    magnitude: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    n_iters: int = 60,
    window: str = "hann",
    angles: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Waveform ``[..., (T-1)·hop]`` from a magnitude spectrogram
    ``[..., T, F]``, starting from `angles` (``[..., T, F]``; default
    `griffin_lim_angles` from `generator`)."""
    mag = magnitude.float().abs()
    if angles is None:
        angles = griffin_lim_angles(mag.shape, generator)
    ang = angles.to(mag.device, torch.float32)
    y = istft(mag * torch.cos(ang), mag * torch.sin(ang), n_fft, hop_length, win_length, window)
    for _ in range(n_iters):
        re, im = stft(y, n_fft, hop_length, win_length, window)
        norm = torch.sqrt(re * re + im * im + 1e-16)
        # keep the estimated phase, replace the magnitude
        y = istft(mag * re / norm, mag * im / norm, n_fft, hop_length, win_length, window)
    return y
