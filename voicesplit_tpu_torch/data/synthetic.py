"""Synthetic triplet datasets for tests and smoke runs (a copy of the JAX
package's `voicesplit_tpu/data/synthetic.py`: the same seed writes the same
files).

The reference ships tiny CSV fixtures + demo wavs
(`datasets/LibriSpeech/test_config.csv`, `audios_demo/`) as its test
data.  We additionally need datasets we can generate hermetically: this
builds wav triplets of harmonically distinct synthetic "speakers" (pitch
+ formant envelope per speaker identity) mixed with `mix_overlap`, plus
deterministic per-speaker pseudo-embeddings — enough structure for a
model to actually learn separation in smoke tests.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from voicesplit_tpu_torch.config import DatasetFormat
from voicesplit_tpu_torch.data.mixer import mix_overlap
from voicesplit_tpu_torch.dsp.audio_io import save_wav_float


def _speaker_wav(
    rng: np.random.Generator, speaker: int, n: int, sample_rate: int
) -> np.ndarray:
    """A crude 'voice': pulse train at a speaker-specific f0 with a few
    speaker-specific formant resonances and amplitude modulation."""
    srng = np.random.default_rng(speaker)
    f0 = 90.0 + 120.0 * srng.random()  # speaker pitch
    formants = 300.0 + 2500.0 * srng.random(3)
    t = np.arange(n) / sample_rate
    phase = 2 * np.pi * f0 * t + 0.1 * rng.standard_normal()
    sig = np.zeros(n)
    for k in range(1, 12):  # harmonics shaped by formants
        fk = f0 * k
        gain = sum(np.exp(-0.5 * ((fk - fm) / 220.0) ** 2) for fm in formants)
        sig += gain * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    envelope = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t + rng.uniform(0, 6))
    sig = sig * envelope + 0.01 * rng.standard_normal(n)
    return (0.25 * sig / np.max(np.abs(sig))).astype(np.float32)


def speaker_embedding(speaker: int, emb_dim: int = 256) -> np.ndarray:
    """Deterministic unit-norm pseudo d-vector for a synthetic speaker."""
    v = np.random.default_rng(10_000 + speaker).standard_normal(emb_dim)
    return (v / np.linalg.norm(v)).astype(np.float32)


def build_synthetic_dataset(
    out_dir: str,
    n_items: int,
    sample_rate: int = 16000,
    audio_len: float = 3.0,
    n_speakers: int = 8,
    emb_dim: int = 256,
    fmt: DatasetFormat | None = None,
    seed: int = 0,
) -> List[str]:
    """Write `n_items` triplets under `out_dir`; returns the mixed paths."""
    fmt = fmt or DatasetFormat()
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(sample_rate * (audio_len + 0.5))  # headroom for trimming
    out = []
    for i in range(n_items):
        spk_a, spk_b = rng.choice(n_speakers, size=2, replace=False)
        clean = _speaker_wav(rng, int(spk_a), n, sample_rate)
        intf = _speaker_wav(rng, int(spk_b), n, sample_rate)
        emb_ref = _speaker_wav(rng, int(spk_a), n, sample_rate)
        sample = mix_overlap(emb_ref, clean, intf, sample_rate, audio_len)
        if sample is None:
            continue

        def path(pattern: str) -> str:
            return os.path.join(out_dir, pattern.replace("*", "%06d" % i))

        save_wav_float(sample.emb_wav, path(fmt.emb_wav), sample_rate)
        save_wav_float(sample.target_wav, path(fmt.target_wav), sample_rate)
        save_wav_float(sample.mixed_wav, path(fmt.mixed_wav), sample_rate)
        emb_path = path(fmt.emb)
        if emb_path.endswith(".pt"):
            emb_path = emb_path[:-3] + ".npy"
        np.save(emb_path, speaker_embedding(int(spk_a), emb_dim))
        out.append(path(fmt.mixed_wav))
    return out
