"""Slaney-style mel filterbank (librosa-compatible), computed in numpy (a
copy of the JAX package's `voicesplit_tpu/dsp/mel.py`).

The reference builds its mel basis with ``librosa.filters.mel`` (default
htk=False, norm='slaney'; reference `utils/audio_processor.py:456-458`) and
uses it for GE2E speaker-encoder mels: ``log10(mel @ |STFT|^2 + 1e-6)``
(reference `utils/audio_processor.py:460-467`).  Reimplemented here from
the published Slaney formula (linear below 1 kHz, log above).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def _hz_to_mel(f: np.ndarray, htk: bool = False) -> np.ndarray:
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    log_region = f >= min_log_hz
    mel = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz(m: np.ndarray, htk: bool = False) -> np.ndarray:
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank ``[n_mels, n_fft // 2 + 1]`` (float32)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    F = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, F)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin), htk), _hz_to_mel(np.array(fmax), htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]  # [n_mels+2, F]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)
