"""Analysis/synthesis windows.

Reimplements the window conventions the reference mixes:

- ``hann`` *periodic* — librosa's default analysis window
  (reference `utils/audio_processor.py:511-514` via `librosa.stft`).
- ``hamming`` *symmetric* — the synthesis window of the differentiable
  training-path iSTFT (reference `utils/audio_processor.py:509`,
  ``torch.hamming_window(win_length, periodic=False)``).

Computed in numpy (a copy of `voicesplit_tpu/dsp/windows.py`), turned
into device tensors once per shape by `voicesplit_tpu_torch.dsp.stft`.
"""

from __future__ import annotations

import numpy as np


def get_window(name: str, length: int, periodic: bool | None = None) -> np.ndarray:
    """Return a float64 window of `length` samples.

    `name` may be "hann", "hamming", or "rect".  `periodic` defaults to
    True for hann (librosa/fftbins convention) and False for hamming
    (torch.hamming_window(periodic=False) convention), matching how the
    reference uses each.
    """
    if name == "rect":
        return np.ones(length, dtype=np.float64)
    if name == "hann":
        periodic = True if periodic is None else periodic
        a0, a1 = 0.5, 0.5
    elif name == "hamming":
        periodic = False if periodic is None else periodic
        a0, a1 = 0.54, 0.46
    else:
        raise ValueError(f"unknown window {name!r}")
    if length == 1:
        return np.ones(1, dtype=np.float64)
    denom = length if periodic else length - 1
    n = np.arange(length, dtype=np.float64)
    return a0 - a1 * np.cos(2.0 * np.pi * n / denom)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window to `size` samples, centered.

    Matches librosa.util.pad_center: left pad = (size - len) // 2.
    """
    n = len(window)
    if size < n:
        raise ValueError(f"target size {size} < window length {n}")
    lpad = (size - n) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad : lpad + n] = window
    return out
