"""Host-side wav read/write (scipy), a copy of the JAX package's
`voicesplit_tpu/dsp/audio_io.py` `load_wav` / `save_wav`."""

from __future__ import annotations

from math import gcd

import numpy as np
import scipy.io.wavfile
import scipy.signal

MAX_WAV_VALUE = 32768.0


def load_wav(path: str, sample_rate: int | None = None) -> np.ndarray:
    """Read a wav file as float32 in [-1, 1], resampling to `sample_rate`."""
    sr, data = scipy.io.wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / MAX_WAV_VALUE
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64
        wav = data.astype(np.float32)
    if wav.ndim > 1:  # downmix to mono
        wav = wav.mean(axis=1)
    if sample_rate is not None and sr != sample_rate:
        g = gcd(sr, sample_rate)
        wav = scipy.signal.resample_poly(wav, sample_rate // g, sr // g).astype(np.float32)
    return wav


def save_wav(wav: np.ndarray, path: str, sample_rate: int) -> None:
    """Peak-normalize to int16 and write (reference `utils/audio_processor.py:561-563`)."""
    wav = np.asarray(wav, dtype=np.float32)
    wav_norm = wav * (MAX_WAV_VALUE / max(0.01, float(np.max(np.abs(wav)))))
    scipy.io.wavfile.write(path, sample_rate, wav_norm.astype(np.int16))
