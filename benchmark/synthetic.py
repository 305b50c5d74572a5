"""Synthetic mixtures and d-vectors, made from the seed.

`_speaker_wav` and `speaker_embedding` are frozen copies of
`voicesplit_tpu_torch/data/synthetic.py`'s functions of the same names
(harmonic "voices": a pulse train at a speaker's pitch shaped by three
formants, amplitude-modulated, with a little noise).  `mixtures` stands for
`data/mixer.py::mix_overlap` at its defaults, on sources that need no
trimming: the head crop of the target and of an interferer of another
speaker, summed, both scaled by 1 / (1.1 · the mixture's peak).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


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


def mixtures(seed: int, count: int, samples: int, sample_rate: int, emb_dim: int,
             n_speakers: int) -> Dict[str, np.ndarray]:
    """`count` distinct items: ``mixed_wav`` and ``target_wav`` ``[count,
    samples]`` float32, ``emb`` ``[count, emb_dim]`` (the target speaker's
    d-vector) and ``wav_len`` ``[count]`` int64.  Each item draws a target
    and an interferer speaker out of `n_speakers` (each speaker's pitch and
    formants are fixed by its number, as in the copied generator), so every
    seed gives the same kind of work."""
    rng = np.random.default_rng(seed)
    mixed = np.empty((count, samples), np.float32)
    target = np.empty((count, samples), np.float32)
    emb = np.empty((count, emb_dim), np.float32)
    for i in range(count):
        spk_a, spk_b = rng.choice(n_speakers, size=2, replace=False)
        clean = _speaker_wav(rng, int(spk_a), samples, sample_rate)
        intf = _speaker_wav(rng, int(spk_b), samples, sample_rate)
        mix = clean + intf
        norm = np.max(np.abs(mix)) * 1.1
        mixed[i] = mix / norm
        target[i] = clean / norm
        emb[i] = speaker_embedding(int(spk_a), emb_dim)
    return {"mixed_wav": mixed, "target_wav": target, "emb": emb,
            "wav_len": np.full(count, samples, np.int64)}
