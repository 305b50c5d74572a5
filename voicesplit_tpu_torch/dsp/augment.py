"""Augmentation (counterpart of `voicesplit_tpu/dsp/augment.py`).

Host-side voice-identity augmentation for corpus preparation (numpy, a copy
of the JAX package's):

- `time_stretch`: phase-vocoder time stretch at constant pitch;
- `pitch_shift`: pitch up or down at constant tempo (time stretch, then
  playback resampling);
- `vtlp`: vocal-tract-length perturbation (Jaitly & Hinton, ICML WDLASL
  2013), a piecewise-linear warp of the spectrogram's frequency axis at the
  original phase.

Train-time SpecAugment (Park et al. 2019, arXiv:1904.08779) of the mask
net's input, in torch on the spec's device: `spec_time_freq_mask` draws
the bands with an explicit ``torch.Generator`` (`draw_spec_bands`) and
applies them (`apply_spec_bands`).  The semantics are the JAX package's:
per item, ``n_masks`` bands per active axis, widths uniform in
``[0, max_w]``, starts uniform in ``[0, max(len − w, 1))``, the spec
multiplied by the keep mask in its own dtype, static shapes.  The random
bits differ from JAX's streams.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# STFT geometry of the analysis/synthesis pair: 75% overlap keeps the phase
# vocoder's phase-locking artifacts low; 1024 at 16 kHz is a 64 ms window.
_NFFT = 1024
_HOP = 256

# axis name -> dimension of a [B, T, F] spec
_AXES = {"time": 1, "freq": 2}

Bands = Dict[str, Optional[Tuple[torch.Tensor, torch.Tensor]]]


def _stft(wav: np.ndarray):
    from scipy.signal import stft

    return stft(wav, nperseg=_NFFT, noverlap=_NFFT - _HOP, window="hann", padded=True)[2]


def _istft(spec: np.ndarray, length: int) -> np.ndarray:
    from scipy.signal import istft

    out = istft(spec, nperseg=_NFFT, noverlap=_NFFT - _HOP, window="hann")[1]
    out = np.asarray(out, np.float32)
    if out.shape[0] < length:
        out = np.pad(out, (0, length - out.shape[0]))
    return out[:length]


def time_stretch(wav: np.ndarray, rate: float) -> np.ndarray:
    """Phase-vocoder time stretch: ``len(wav) / rate`` samples at the same
    pitch (`rate` > 1 = faster, shorter).

    Resamples the STFT's time axis at `rate`, interpolates magnitudes and
    accumulates phase from the per-bin phase advance between consecutive
    analysis frames, so each partial keeps its instantaneous frequency.
    """
    wav = np.asarray(wav, np.float32)
    spec = _stft(wav)  # [F, T]
    F, T = spec.shape
    steps = np.arange(0, T - 1, rate)
    mag = np.abs(spec)
    phase = np.angle(spec)
    # expected phase advance per hop at each bin's centre frequency
    omega = 2 * np.pi * np.arange(F) * _HOP / _NFFT

    lo = np.floor(steps).astype(int)
    frac = steps - lo
    m = (1.0 - frac) * mag[:, lo] + frac * mag[:, lo + 1]
    # heterodyned phase increment, wrapped to [-pi, pi)
    dphi = phase[:, lo + 1] - phase[:, lo] - omega[:, None]
    dphi -= 2 * np.pi * np.round(dphi / (2 * np.pi))
    inc = dphi + omega[:, None]
    acc = np.concatenate(
        [phase[:, lo[:1]], np.cumsum(inc[:, :-1], axis=1) + phase[:, lo[:1]]], axis=1
    )
    out_len = int(round(wav.shape[0] / rate))
    return _istft(m * np.exp(1j * acc), out_len)


def pitch_shift(wav: np.ndarray, sample_rate: int, semitones: float) -> np.ndarray:
    """Shift pitch by `semitones` at constant tempo and duration."""
    from voicesplit_tpu_torch.dsp.audio_io import resample

    factor = 2.0 ** (semitones / 12.0)  # > 1 = up
    # stretch to factor × length at the same pitch, then play back faster by
    # `factor`: pitch × factor, duration back to the original
    stretched = time_stretch(wav, rate=1.0 / factor)
    out = resample(stretched, int(round(sample_rate * factor)), sample_rate)
    n = np.asarray(wav).shape[0]
    out = np.asarray(out, np.float32)
    if out.shape[0] < n:
        out = np.pad(out, (0, n - out.shape[0]))
    return out[:n]


def vtlp(wav: np.ndarray, sample_rate: int, alpha: float, f_hi: float = 4800.0) -> np.ndarray:
    """Vocal-tract-length perturbation: a formant-axis warp at constant
    pitch contour and tempo.

    Below the breakpoint frequencies scale by `alpha`; above it a linear
    segment maps the rest onto [.., nyquist], so the warp is a bijection.
    Magnitudes are resampled along the warped axis; the original phase is
    kept.
    """
    wav = np.asarray(wav, np.float32)
    spec = _stft(wav)
    F = spec.shape[0]
    nyq = sample_rate / 2.0
    freqs = np.linspace(0.0, nyq, F)
    bp = f_hi * min(alpha, 1.0) / alpha  # breakpoint in source frequency
    # where each output frequency samples the source spectrum
    warped = np.where(
        freqs < bp * alpha,
        freqs / alpha,
        nyq - (nyq - bp) * (nyq - freqs) / max(nyq - bp * alpha, 1e-6),
    )
    warped = np.clip(warped, 0.0, nyq)
    idx = warped / nyq * (F - 1)
    lo = np.floor(idx).astype(int)
    hi = np.minimum(lo + 1, F - 1)
    frac = (idx - lo)[:, None]
    mag = np.abs(spec)
    phase = np.angle(spec)
    m = (1.0 - frac) * mag[lo] + frac * mag[hi]
    return _istft(m * np.exp(1j * phase), wav.shape[0])


# ---------------------------------------------------------------------------
# Train-time SpecAugment, in torch on the spec's device


def _draw_axis(generator: torch.Generator, batch: int, length: int, max_w: int, n_masks: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    width = torch.randint(0, max_w + 1, (batch, n_masks), generator=generator, device=device)
    # start uniform in [0, max(length - width, 1)), a bound per band
    hi = (length - width).clamp(min=1)
    u = torch.rand((batch, n_masks), generator=generator, device=device, dtype=torch.float64)
    start = torch.minimum((u * hi).long(), hi - 1)
    return start, width


def draw_spec_bands(generator: torch.Generator, shape, max_time: int = 0, max_freq: int = 0,
                    n_masks: int = 2) -> Bands:
    """The bands of one SpecAugment draw for a ``[B, T, F]`` spec:
    ``{"time": (start, width), "freq": (start, width)}``, each ``[B, n_masks]``
    int64 on the generator's device, or None for an inactive axis.  Time is
    drawn before frequency, widths before starts."""
    B, T, F = shape
    device = generator.device
    return {
        "time": _draw_axis(generator, B, T, int(max_time), n_masks, device) if max_time else None,
        "freq": _draw_axis(generator, B, F, int(max_freq), n_masks, device) if max_freq else None,
    }


def band_keep(start: torch.Tensor, width: torch.Tensor, length: int) -> torch.Tensor:
    """``[B, length]`` bool: True where no band of the item covers the index."""
    idx = torch.arange(length, device=start.device)[None, None, :]
    hit = (idx >= start[..., None]) & (idx < (start + width)[..., None])
    return ~hit.any(dim=1)


def apply_spec_bands(spec: torch.Tensor, bands: Bands) -> torch.Tensor:
    """`spec` ``[B, T, F]`` times the keep mask of `bands` in its own dtype
    (zero is the dB floor of the [0, 1]-normalized spec)."""
    B = spec.shape[0]
    for axis, dim in _AXES.items():
        if bands.get(axis) is None:
            continue
        start, width = (t.to(spec.device) for t in bands[axis])
        length = spec.shape[dim]
        shape = [B, 1, 1]
        shape[dim] = length
        spec = spec * band_keep(start, width, length).reshape(shape).to(spec.dtype)
    return spec


def spec_time_freq_mask(spec: torch.Tensor, generator: torch.Generator, max_time: int = 0,
                        max_freq: int = 0, n_masks: int = 2) -> torch.Tensor:
    """SpecAugment-style time/frequency masking of a normalized magnitude
    spectrogram batch ``[B, T, F]``: per item, `n_masks` bands per active
    axis with widths uniform in ``[0, max_*]`` are zeroed.  The train step
    feeds the masked spec to the mask net and multiplies the mask with the
    clean mixture spec."""
    return apply_spec_bands(spec, draw_spec_bands(generator, spec.shape, max_time, max_freq,
                                                  n_masks))
