"""BS.1770 loudness: the port's `dsp/loudness.py` (host numpy/scipy, a copy)
against the JAX package's on the same signals.  Both are float64 numpy
over the same filters, so the results must be equal.
"""

import numpy as np
import pytest

from voicesplit_tpu.dsp import loudness as jax_loudness
from voicesplit_tpu_torch.dsp import loudness


def _signal(kind, sr, seconds=2.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    if kind == "sine":
        return (0.5 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    if kind == "noise":
        return (0.1 * rng.standard_normal(len(t))).astype(np.float32)
    if kind == "bursts":  # speech-like: loud bursts between near-silence, gates in play
        env = (np.sin(2 * np.pi * 1.5 * t) > 0.3).astype(np.float64)
        return (env * 0.3 * np.sin(2 * np.pi * 220.0 * t) + 1e-5 * rng.standard_normal(len(t))).astype(np.float32)
    if kind == "short":  # shorter than one 400 ms block
        return (0.2 * rng.standard_normal(int(0.2 * sr))).astype(np.float32)
    return np.zeros(len(t), np.float32)  # silence


KINDS = ["sine", "noise", "bursts", "short", "silence"]


@pytest.mark.parametrize("sr", [16000, 48000])
@pytest.mark.parametrize("kind", KINDS)
def test_integrated_lufs_matches_jax(kind, sr):
    x = _signal(kind, sr)
    assert loudness.integrated_lufs(x, sr) == jax_loudness.integrated_lufs(x, sr)


@pytest.mark.parametrize("kind", KINDS)
def test_loudness_normalize_matches_jax(kind):
    x = _signal(kind, 16000, seed=1)
    got = loudness.loudness_normalize(x, 16000, target_lufs=-23.0)
    want = jax_loudness.loudness_normalize(x, 16000, target_lufs=-23.0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_k_weighting_matches_jax():
    for sr in (16000, 22050, 48000):
        np.testing.assert_array_equal(loudness._k_weighting_sos(sr), jax_loudness._k_weighting_sos(sr))


def test_calibration_anchor():
    """A full-scale 997 Hz sine reads -3.01 LUFS (BS.1770-4 Annex 1)."""
    t = np.arange(3 * 48000) / 48000
    assert abs(loudness.integrated_lufs(np.sin(2 * np.pi * 997.0 * t), 48000) + 3.01) < 0.1
