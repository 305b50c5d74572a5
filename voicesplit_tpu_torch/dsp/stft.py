"""STFT / iSTFT as Fourier-basis matmuls (PyTorch counterpart of
`voicesplit_tpu/dsp/stft.py`).

- Framing: reflect pad by ``n_fft // 2`` (librosa's ``center=True``) and
  ``Tensor.unfold`` into ``[..., T, n_fft]`` frames.
- DFT: one ``[.., n_fft] @ [n_fft, F]`` float32 matmul per part against a
  windowed real/imag basis, as in the JAX package (which also runs it
  outside any Pallas kernel).  ``n_fft = 1200`` is not a power of two, and
  the basis matmul does not care.
- Inverse DFT: the transposed basis with Hermitian coefficient doubling.
- Overlap-add: ``torch.nn.functional.fold`` (a col2im sum) in place of the
  JAX package's 0/1 subframe scatter matrix, which exists there only to
  keep the iSTFT on the TPU's matrix unit.
- The window-sumsquare envelope is precomputed in numpy and divided out.

Conventions match librosa: reflect padding, windows padded centered to
``n_fft``, and an iSTFT that trims ``n_fft // 2`` from both ends.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from voicesplit_tpu_torch.dsp.windows import get_window, pad_center

_TINY = 1.1754944e-38  # smallest positive normal float32 (librosa util.tiny)


def num_frames(n_samples: int, n_fft: int, hop_length: int, center: bool = True) -> int:
    """Number of STFT frames for a signal of `n_samples`."""
    if center:
        n_samples = n_samples + 2 * (n_fft // 2)
    return 1 + (n_samples - n_fft) // hop_length


def _constant(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A cached constant tensor.  Made outside inference mode even when the
    first call comes from it, so that autograd (a train step) may use it
    later."""
    with torch.inference_mode(False):
        return torch.from_numpy(a).to(device)


@lru_cache(maxsize=16)
def _stft_basis(
    n_fft: int, win_length: int, window: str, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed forward-DFT bases ``(cos, sin)``, each ``[n_fft, F]`` float32."""
    F_ = n_fft // 2 + 1
    w = pad_center(get_window(window, win_length), n_fft)
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(F_, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * f * n / n_fft
    cos_b = (np.cos(ang) * w[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * w[:, None]).astype(np.float32)
    return _constant(cos_b, device), _constant(sin_b, device)


@lru_cache(maxsize=16)
def _istft_basis(
    n_fft: int, win_length: int, window: str, periodic: Optional[bool], device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed inverse-DFT bases ``(cos, sin)``, each ``[F, n_fft]`` float32:
    ``frames = real @ cos + imag @ sin`` is ``w * irfft(S)``."""
    F_ = n_fft // 2 + 1
    w = pad_center(get_window(window, win_length, periodic), n_fft)
    f = np.arange(F_, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * f * n / n_fft
    coef = np.full((F_, 1), 2.0)
    coef[0, 0] = 1.0
    if n_fft % 2 == 0:
        coef[-1, 0] = 1.0
    cos_i = (coef * np.cos(ang) / n_fft * w[None, :]).astype(np.float32)
    sin_i = (-coef * np.sin(ang) / n_fft * w[None, :]).astype(np.float32)
    return _constant(cos_i, device), _constant(sin_i, device)


@lru_cache(maxsize=None)
def window_sumsquare(
    n_frames: int,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: str = "hann",
    periodic: Optional[bool] = None,
) -> np.ndarray:
    """Overlap-added squared-window envelope, ``[(n_frames-1)*hop + n_fft]``."""
    w2 = pad_center(get_window(window, win_length, periodic), n_fft) ** 2
    n_out = (n_frames - 1) * hop_length + n_fft
    env = np.zeros(n_out, dtype=np.float64)
    for t in range(n_frames):
        env[t * hop_length : t * hop_length + n_fft] += w2
    return env.astype(np.float32)


@lru_cache(maxsize=16)
def _inverse_envelope(
    n_frames: int, n_fft: int, hop_length: int, win_length: int,
    window: str, periodic: Optional[bool], device: torch.device,
) -> torch.Tensor:
    env = window_sumsquare(n_frames, n_fft, hop_length, win_length, window, periodic)
    return _constant(np.where(env > _TINY, env, 1.0).astype(np.float32), device)


def frame_signal(
    y: torch.Tensor, n_fft: int, hop_length: int, center: bool = True
) -> torch.Tensor:
    """Slice ``y [..., L]`` into overlapping frames ``[..., T, n_fft]``.

    ``center=True`` reflect-pads by ``n_fft // 2`` first (librosa).
    """
    lead = y.shape[:-1]
    if center:
        pad = n_fft // 2
        # reflect padding wants a [N, C, L] input
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    y = y.reshape(*lead, y.shape[-1])
    return y.unfold(-1, n_fft, hop_length)


def stft(
    y: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: str = "hann",
    center: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT of ``y [..., L]`` → ``(real, imag)``, each ``[..., T, F]`` float32
    (``librosa.stft`` transposed to time-major)."""
    cos_b, sin_b = _stft_basis(n_fft, win_length, window, y.device)
    frames = frame_signal(y.float(), n_fft, hop_length, center)
    return torch.matmul(frames, cos_b), torch.matmul(frames, sin_b)


def stft_magphase(
    y: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: str = "hann",
    center: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(magnitude, phase)`` of the STFT, each ``[..., T, F]``."""
    real, imag = stft(y, n_fft, hop_length, win_length, window, center)
    mag = torch.sqrt(real * real + imag * imag + 1e-30)
    phase = torch.atan2(imag, real)
    return mag, phase


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add ``[..., T, n_fft]`` → ``[..., (T-1)*hop + n_fft]``."""
    *lead, T, n_fft = frames.shape
    n_out = (T - 1) * hop_length + n_fft
    cols = frames.reshape(-1, T, n_fft).transpose(1, 2)  # [N, n_fft, T]
    out = F.fold(cols, output_size=(1, n_out), kernel_size=(1, n_fft), stride=(1, hop_length))
    return out.reshape(*lead, n_out)


def istft(
    real: torch.Tensor,
    imag: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: str = "hann",
    center: bool = True,
    periodic: Optional[bool] = None,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT of ``(real, imag) [..., T, F]`` → waveform ``[..., L]``:
    weighted overlap-add with the window-sumsquare correction."""
    T = real.shape[-2]
    cos_i, sin_i = _istft_basis(n_fft, win_length, window, periodic, real.device)
    frames = torch.matmul(real, cos_i) + torch.matmul(imag, sin_i)
    y = overlap_add(frames, hop_length)
    y = y / _inverse_envelope(T, n_fft, hop_length, win_length, window, periodic, y.device)
    if center:
        pad = n_fft // 2
        y = y[..., pad:-pad] if pad else y
    if length is not None:
        # exactly `length` samples: zero-pad when the frame grid is short
        if y.shape[-1] < length:
            y = F.pad(y, (0, length - y.shape[-1]))
        else:
            y = y[..., :length]
    return y


def istft_magphase(
    mag: torch.Tensor,
    phase: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: str = "hann",
    center: bool = True,
    periodic: Optional[bool] = None,
    length: Optional[int] = None,
) -> torch.Tensor:
    """iSTFT from ``(magnitude, phase)`` — the mixed-phase inversion path."""
    return istft(
        mag * torch.cos(phase),
        mag * torch.sin(phase),
        n_fft,
        hop_length,
        win_length,
        window,
        center,
        periodic,
        length,
    )
