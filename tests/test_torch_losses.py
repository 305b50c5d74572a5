"""Losses: the port's `voicesplit_tpu_torch.losses` against
`voicesplit_tpu.losses`, values and gradients, on numpy inputs from a seed
(fp32 on both sides, so the tolerances cover summation order only).

A zero-length item has a finite value on both sides, but the JAX
gradient of that item is NaN (which would poison a whole batch's
parameter gradients); the port's is zero.  Gradients are compared on the
other items, and the port's are checked finite on the empty one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicesplit_tpu import losses as jl
from voicesplit_tpu.losses.si_snr import si_snr_matrix as jax_si_snr_matrix
from voicesplit_tpu_torch import losses as tl

RTOL, ATOL = 1e-5, 1e-6


def _grad_t(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _assert_grads_close(got_g, want_g, lengths):
    """Equal on items of nonzero length; finite (zero) on empty ones."""
    keep = np.ones(len(got_g[0]), bool) if lengths is None else lengths > 0
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a[keep], np.asarray(b)[keep], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(a[~keep], 0.0)


def test_sequence_mask_matches_jax():
    lengths = np.array([0, 3, 7], np.int32)
    want = jl.sequence_mask(jnp.asarray(lengths), 7)
    got = tl.sequence_mask(torch.from_numpy(lengths), 7)
    assert got.dtype == torch.float32 and got.shape == (3, 1, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_power_law_loss_and_grad_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(-0.2, 1.0, (2, 9, 11)).astype(np.float32)  # negatives: signed branch
    target = rng.uniform(0.0, 1.0, (2, 9, 11)).astype(np.float32)
    pred[0, 0, :3] = 0.0  # the ε keeps |x|^0.3 differentiable at zero

    def jloss(p, t):
        return jl.power_law_compressed_loss(p, t, 0.3, 0.113)

    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(target))
    got, got_g = _grad_t(lambda p, t: tl.power_law_compressed_loss(p, t, 0.3, 0.113), pred, target)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("C", [1, 3])
def test_si_snr_with_pit_and_grad_match_jax(C):
    """General C with the permutation gather; one item of zero length (a
    finite 0-energy row) and one short item."""
    rng = np.random.default_rng(C)
    B, T = 4, 64
    source = rng.standard_normal((B, C, T)).astype(np.float32)
    # estimates near a permutation of the sources, so PIT has a clear best
    perm = rng.permutation(C)
    estimate = (source[:, perm] + 0.3 * rng.standard_normal((B, C, T))).astype(np.float32)
    lengths = np.array([T, 0, 40, 17], np.int32)

    def jloss(e, s):
        return jl.si_snr_with_pit(e, s, jnp.asarray(lengths))

    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(estimate), jnp.asarray(source))
    got, got_g = _grad_t(
        lambda e, s: tl.si_snr_with_pit(e, s, torch.from_numpy(lengths)), estimate, source
    )
    assert np.isfinite(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)
    _assert_grads_close(got_g, want_g, lengths)

    matrix = tl.si_snr_matrix(
        torch.from_numpy(estimate), torch.from_numpy(source), torch.from_numpy(lengths)
    )
    want_m = jax_si_snr_matrix(
        jnp.asarray(estimate), jnp.asarray(source), jnp.asarray(lengths)
    )
    assert matrix.shape == (B, C, C)
    np.testing.assert_allclose(matrix.numpy(), np.asarray(want_m), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_si_snr_metric_and_grad_match_jax(masked):
    rng = np.random.default_rng(7)
    B, T = 3, 80
    source = rng.standard_normal((B, T)).astype(np.float32)
    estimate = (source + 0.5 * rng.standard_normal((B, T))).astype(np.float32)
    lengths = np.array([T, 0, 33], np.int32) if masked else None

    def jfn(e, s):
        return jnp.sum(jl.si_snr(e, s, lengths=None if lengths is None else jnp.asarray(lengths)))

    want_each = jl.si_snr(
        jnp.asarray(estimate), jnp.asarray(source),
        lengths=None if lengths is None else jnp.asarray(lengths),
    )
    want_g = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(estimate), jnp.asarray(source))
    lt = None if lengths is None else torch.from_numpy(lengths)
    each = tl.si_snr(torch.from_numpy(estimate), torch.from_numpy(source), lengths=lt)
    _, got_g = _grad_t(lambda e, s: tl.si_snr(e, s, lengths=lt).sum(), estimate, source)
    assert each.shape == (B,)
    np.testing.assert_allclose(each.numpy(), np.asarray(want_each), rtol=1e-4, atol=1e-4)
    _assert_grads_close(got_g, want_g, lengths)
