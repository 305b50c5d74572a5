"""The port's augmentation (`voicesplit_tpu_torch/dsp/augment.py`) against the
JAX package's: SpecAugment applied to JAX's own bands gives JAX's output
exactly; the port's own draws keep JAX's semantics; the host voice
augmentations agree with JAX's to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicesplit_tpu.dsp import augment as jaug
from voicesplit_tpu_torch.dsp import augment as taug

SR = 16000


def jax_bands(key, shape, max_time, max_freq, n_masks):
    """The bands JAX's `spec_time_freq_mask` draws from `key`, by the same
    splits and calls (`voicesplit_tpu/dsp/augment.py:151-182`)."""
    B, T, F = shape

    def axis(k, length, max_w):
        k1, k2 = jax.random.split(k)
        w = jax.random.randint(k1, (B, n_masks), 0, max_w + 1)
        start = jax.random.randint(k2, (B, n_masks), 0, jnp.maximum(length - w, 1))
        return torch.from_numpy(np.array(start)).long(), torch.from_numpy(np.array(w)).long()

    kt, kf = jax.random.split(key)
    return {"time": axis(kt, T, max_time) if max_time else None,
            "freq": axis(kf, F, max_freq) if max_freq else None}


@pytest.mark.parametrize("step", [0, 7, 123])
@pytest.mark.parametrize("limits", [(24, 40, 2), (5, 0, 1), (0, 9, 3)])
def test_jax_bands_give_jax_output_exactly(step, limits):
    """The train step's key, ``fold_in(PRNGKey(0x5A), step)``, on a random
    spec: the port's `apply_spec_bands` on JAX's bands is JAX's output, bit
    for bit, and on a spec of ones it is JAX's keep mask."""
    max_time, max_freq, n = limits
    shape = (3, 61, 45)
    key = jax.random.fold_in(jax.random.PRNGKey(0x5A), step)
    spec = np.random.default_rng(step).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jaug.spec_time_freq_mask(jnp.asarray(spec), key, max_time, max_freq, n))
    bands = jax_bands(key, shape, max_time, max_freq, n)
    got = taug.apply_spec_bands(torch.from_numpy(spec), bands).numpy()
    np.testing.assert_array_equal(got, want)
    keep = np.asarray(jaug.spec_time_freq_mask(jnp.ones(shape), key, max_time, max_freq, n))
    np.testing.assert_array_equal(taug.apply_spec_bands(torch.ones(shape), bands).numpy(), keep)
    assert (keep == 0).any()


def test_bf16_spec_keeps_its_dtype_and_values():
    spec = torch.rand((2, 30, 20), generator=torch.Generator().manual_seed(0)).bfloat16()
    g = torch.Generator().manual_seed(1)
    out = taug.spec_time_freq_mask(spec, g, 6, 5)
    assert out.dtype == torch.bfloat16
    kept = out != 0
    assert torch.equal(out[kept], spec[kept]) and (~kept).any()


def test_draws_shapes_and_band_limits():
    """Widths in [0, max_w], starts in [0, max(len - w, 1)), a band inside
    the axis wherever it fits, int64 ``[B, n_masks]``, time and frequency
    both active; over many draws every width occurs."""
    g = torch.Generator().manual_seed(3)
    B, T, F, n = 64, 50, 30, 2
    widths = {"time": set(), "freq": set()}
    for _ in range(20):
        bands = taug.draw_spec_bands(g, (B, T, F), max_time=12, max_freq=35, n_masks=n)
        for axis, length, max_w in (("time", T, 12), ("freq", F, 35)):
            start, width = bands[axis]
            assert start.shape == width.shape == (B, n) and start.dtype == torch.int64
            assert int(width.min()) >= 0 and int(width.max()) <= max_w
            hi = (length - width).clamp(min=1)
            assert bool((start >= 0).all()) and bool((start < hi).all())
            fits = width <= length
            assert bool((start + width <= length)[fits].all())
            widths[axis] |= set(width.flatten().tolist())
    assert widths["time"] == set(range(13)) and widths["freq"] == set(range(36))


def test_same_generator_same_bits_and_independent_items():
    spec = torch.ones((16, 80, 1))
    a = taug.spec_time_freq_mask(spec, torch.Generator().manual_seed(5), max_time=20, n_masks=1)
    b = taug.spec_time_freq_mask(spec, torch.Generator().manual_seed(5), max_time=20, n_masks=1)
    c = taug.spec_time_freq_mask(spec, torch.Generator().manual_seed(6), max_time=20, n_masks=1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    patterns = {tuple(row.int().tolist()) for row in a[:, :, 0]}
    assert len(patterns) > 8  # items draw their own bands


def test_disabled_is_a_no_op_and_draws_nothing():
    spec = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 10, 12)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    out = taug.spec_time_freq_mask(spec, g, 0, 0)
    assert torch.equal(out, spec) and torch.equal(g.get_state(), state)
    assert taug.draw_spec_bands(g, spec.shape) == {"time": None, "freq": None}


def _voice(n=SR, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = 150.0
    wav = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) / k for k in range(1, 8))
    return (0.2 * wav * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)


@pytest.mark.parametrize("fn,args", [
    ("time_stretch", (0.8,)), ("time_stretch", (1.25,)),
    ("pitch_shift", (SR, 3.0)), ("pitch_shift", (SR, -2.0)),
    ("vtlp", (SR, 0.9)), ("vtlp", (SR, 1.1)),
])
def test_host_voice_augmentation_matches_jax(fn, args):
    wav = _voice()
    want = getattr(jaug, fn)(wav, *args)
    got = getattr(taug, fn)(wav, *args)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
