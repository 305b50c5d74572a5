"""Host-side audio IO: wav read/write, resampling, silence trimming (a copy
of the JAX package's `voicesplit_tpu/dsp/audio_io.py`).

The reference leans on librosa for these (`librosa.load` at
`utils/audio_processor.py:565-567`, `librosa.effects.trim` in the offline
mixer `utils/generic_utils.py:308-311`).  Here they are small scipy/numpy
implementations: polyphase resampling, int/float wav decode, and an
RMS-based trim with librosa's frame semantics.  They run on the host, never
on the card.
"""

from __future__ import annotations

from math import gcd
from typing import Tuple

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
        wav = resample(wav, sr, sample_rate)
    return wav


def save_wav(wav: np.ndarray, path: str, sample_rate: int) -> None:
    """Peak-normalize to int16 and write (reference `utils/audio_processor.py:561-563`)."""
    wav = np.asarray(wav, dtype=np.float32)
    wav_norm = wav * (MAX_WAV_VALUE / max(0.01, float(np.max(np.abs(wav)))))
    scipy.io.wavfile.write(path, sample_rate, wav_norm.astype(np.int16))


def save_wav_float(wav: np.ndarray, path: str, sample_rate: int) -> None:
    """Write raw float32 samples without renormalizing.

    Dataset triplets must preserve the mixer's relative scaling between
    mixed/target (the reference writes these with
    ``librosa.output.write_wav``, which also keeps floats raw —
    `utils/generic_utils.py:335-337`); `save_wav`'s peak normalization is
    only for human-listening outputs.
    """
    scipy.io.wavfile.write(path, sample_rate, np.asarray(wav, dtype=np.float32))


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy)."""
    if orig_sr == target_sr:
        return wav
    g = gcd(orig_sr, target_sr)
    return scipy.signal.resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Center-padded per-frame RMS (librosa.feature.rms semantics)."""
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad), mode="constant")
    n = 1 + (len(yp) - frame_length) // hop_length
    strides = (yp.strides[0] * hop_length, yp.strides[0])
    frames = np.lib.stride_tricks.as_strided(yp, shape=(n, frame_length), strides=strides)
    return np.sqrt(np.mean(frames**2, axis=1))


def trim_silence(
    y: np.ndarray,
    top_db: float = 20.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Trim leading/trailing frames quieter than `top_db` below the peak.

    Same contract as ``librosa.effects.trim`` (used by the reference mixer,
    `utils/generic_utils.py:308-311`): returns ``(trimmed, (start, end))``.
    """
    rms = _frame_rms(y, frame_length, hop_length)
    power = rms**2
    ref = np.max(power)
    if ref <= 0:
        return y, (0, len(y))
    db = 10.0 * np.log10(np.maximum(power / ref, 1e-30))
    non_silent = db > -top_db
    idx = np.flatnonzero(non_silent)
    if len(idx) == 0:
        return y[0:0], (0, 0)
    start = int(idx[0]) * hop_length
    end = min(len(y), int(idx[-1] + 1) * hop_length)
    return y[start:end], (start, end)


def split_on_silence(
    y: np.ndarray,
    top_db: float = 20.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> np.ndarray:
    """Intervals ``[N, 2]`` of non-silent regions (librosa.effects.split

    semantics; used by the reference's VAD-interleave mixer,
    `utils/generic_utils.py:122-214`).
    """
    rms = _frame_rms(y, frame_length, hop_length)
    power = rms**2
    ref = np.max(power)
    if ref <= 0:
        return np.zeros((0, 2), dtype=np.int64)
    db = 10.0 * np.log10(np.maximum(power / ref, 1e-30))
    non_silent = db > -top_db
    edges = np.flatnonzero(np.diff(non_silent.astype(np.int8)))
    starts, ends = [], []
    if non_silent[0]:
        starts.append(0)
    for e in edges:
        if non_silent[e + 1]:
            starts.append(e + 1)
        else:
            ends.append(e + 1)
    if non_silent[-1]:
        ends.append(len(non_silent))
    ivals = np.stack([np.asarray(starts), np.asarray(ends)], axis=1) * hop_length
    return np.minimum(ivals, len(y))
