"""The LSTM kernels' plain versions at the wide config's hidden size (H = 800)
and the row counts the split walk partitions, against the JAX package's
Pallas kernels.

At H = 800 in bf16 the card runs both LSTM walks on two 16-block clusters a
direction and row group (the split walk: 25 blocks of 32 units, 13 in one
cluster and 12 in the other), whose receive slots hold h in tiles of 8 rows.
These tests hold the plain versions that the split walk is checked against
on the card (`lstm_cuda.lstm_fwd_ref`, `bilstm_fwd_ref`, `lstm_bwd_ref`,
`bilstm_bwd_ref`) to `lstm_pallas._fwd` / `_fwd2` / `_bwd` / `_bwd2`, run in
interpret mode on the CPU as `tests/test_torch_lstm.py` runs them: one
direction at 1, 2 and 3 rows, two directions at 8 and 9 rows each (9: one
row past an 8-row tile), T = 4, in bf16 and fp32.  Inputs are numpy arrays
from a seeded generator.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicesplit_tpu.ops import lstm_pallas
from voicesplit_tpu_torch.ops import lstm_cuda

# the tolerances of tests/test_torch_lstm_rows.py: fp32 differs by the order
# of summation only; with bf16 operands both sides round h (and, backward,
# dgates) to bf16 before an fp32-accumulated product, so they agree almost
# as closely, and 1e-4 leaves room for one rounding tie going the other way.
ATOL = {"float32": 1e-5, "bfloat16": 1e-4}
# A tie that goes the other way moves the rounded h (or dgates) by one bf16
# ulp, and the outputs after it by up to one bf16 ulp of their largest
# magnitude: in bf16 an output may also differ by 2^-8 of its peak.
BF16_ULP = 2.0 ** -8

T, H = 4, 800
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _arr(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _cast(a, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    j = jnp.asarray(a).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _t32(x):
    return torch.from_numpy(_np(x))


def _close(got, want, dtype, name):
    want = _np(want)
    tol = ATOL[dtype] + (BF16_ULP * np.abs(want).max() if dtype == "bfloat16" else 0.0)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, err_msg=name)


def _shifted(first, seq):
    """[first, seq[0], ..., seq[T-2]]: the previous step's state, as the
    JAX wrappers feed the backward kernels."""
    return jnp.concatenate([first[None], seq[:-1]])


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lstm_fwd_ref_matches_pallas_fwd_at_wide_hidden(dtype, B):
    """One direction: serving (1 row), training (2) and an odd count (3)."""
    rng = np.random.default_rng(1200 + B)
    xp_j, xp_t = _cast(_arr(rng, (T, B, 4 * H)), dtype)
    w_j, w_t = _cast(_arr(rng, (H, 4 * H), H ** -0.5), dtype)
    h0, c0 = _arr(rng, (B, H)), _arr(rng, (B, H))
    want = lstm_pallas._fwd(xp_j, w_j, jnp.asarray(h0), jnp.asarray(c0))
    got = lstm_cuda.lstm_fwd_ref(xp_t, w_t, torch.from_numpy(h0), torch.from_numpy(c0))
    for name, a, b in zip(("hs", "cs", "gates"), got, want):
        _close(a, b, dtype, name)


@pytest.mark.parametrize("B", [8, 9])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bilstm_fwd_ref_matches_pallas_fwd2_at_wide_hidden(dtype, B):
    """Both directions at 8 rows each (the evaluation sweep's padded batch:
    one 8-row tile) and 9 (a second tile with one row)."""
    rng = np.random.default_rng(1210 + B)
    xp_j, xp_t = _cast(_arr(rng, (T, 2 * B, 4 * H)), dtype)
    wf_j, wf_t = _cast(_arr(rng, (H, 4 * H), H ** -0.5), dtype)
    wb_j, wb_t = _cast(_arr(rng, (H, 4 * H), H ** -0.5), dtype)
    zeros = jnp.zeros((2 * B, H), jnp.float32)
    want = lstm_pallas._fwd2(xp_j, wf_j, wb_j, zeros, zeros)
    got = lstm_cuda.bilstm_fwd_ref(xp_t, wf_t, wb_t)
    for name, a, b in zip(("hs", "cs", "gates"), got, want):
        _close(a, b, dtype, name)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lstm_bwd_ref_matches_pallas_bwd_at_wide_hidden_rows(dtype, B):
    """One direction at 1 and 3 rows (2, the training batch, is
    tests/test_torch_wide.py's)."""
    rng = np.random.default_rng(1220 + B)
    xp_j, _ = _cast(_arr(rng, (T, B, 4 * H)), dtype)
    w_j, w_t = _cast(_arr(rng, (H, 4 * H), H ** -0.5), dtype)
    h0, c0, dhf, dcf = (_arr(rng, (B, H)) for _ in range(4))
    dhs = _arr(rng, (T, B, H))
    hs, cs, gates = lstm_pallas._fwd(xp_j, w_j, jnp.asarray(h0), jnp.asarray(c0))
    want = lstm_pallas._bwd(
        w_j, gates, _shifted(jnp.asarray(c0), cs), _shifted(jnp.asarray(h0), hs),
        jnp.asarray(dhs), jnp.asarray(dhf), jnp.asarray(dcf), dxp_dtype=jnp.dtype(dtype),
    )
    got = lstm_cuda.lstm_bwd_ref(
        w_t, _t32(gates), _t32(cs), _t32(hs), *map(torch.from_numpy, (h0, c0, dhs, dhf, dcf)),
        getattr(torch, dtype),
    )
    for name, a, b in zip(("dxp", "dwhh", "dh0", "dc0"), got, want):
        _close(a, b, dtype, name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bilstm_bwd_ref_matches_pallas_bwd2_at_nine_rows(dtype):
    """Both directions at 9 rows each: one row past an 8-row tile (8 is
    tests/test_torch_wide.py's)."""
    B = 9
    rng = np.random.default_rng(1230)
    xp_j, _ = _cast(_arr(rng, (T, 2 * B, 4 * H)), dtype)
    wf_j, wf_t = _cast(_arr(rng, (H, 4 * H), H ** -0.5), dtype)
    wb_j, wb_t = _cast(_arr(rng, (H, 4 * H), H ** -0.5), dtype)
    dhs = _arr(rng, (T, 2 * B, H))
    zeros = jnp.zeros((2 * B, H), jnp.float32)
    hs, cs, gates = lstm_pallas._fwd2(xp_j, wf_j, wb_j, zeros, zeros)
    want = lstm_pallas._bwd2(
        wf_j, wb_j, gates, _shifted(zeros, cs), _shifted(zeros, hs), jnp.asarray(dhs),
        dxp_dtype=jnp.dtype(dtype),
    )
    got = lstm_cuda.bilstm_bwd_ref(
        wf_t, wb_t, _t32(gates), _t32(cs), _t32(hs), torch.from_numpy(dhs), getattr(torch, dtype)
    )
    for name, a, b in zip(("dxp", "dwhh_f", "dwhh_b"), got, want):
        _close(a, b, dtype, name)
