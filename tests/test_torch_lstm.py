"""LSTM parity: the port's plain kernel versions and `BiLSTM` against the
JAX package.

The JAX side runs the Pallas kernels `_fwd_kernel` / `_fwd2_kernel` in
interpret mode on the CPU (as `tests/test_pallas_lstm.py` does) through
their launchers `_fwd` / `_fwd2` and the public `fused_lstm_scan` /
`fused_bilstm_scan`.  Inputs are numpy arrays from a seeded generator.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicesplit_tpu.models import lstm as jax_lstm
from voicesplit_tpu.ops import lstm_pallas
from voicesplit_tpu_torch.models.lstm import BiLSTM, lstm_scan
from voicesplit_tpu_torch.ops import lstm_cuda

T, H = 13, 16
# fp32: order-of-summation round-off only.  bf16 operands: both sides round
# h to bf16 before an fp32-accumulated product, so they agree almost as
# closely; 1e-4 leaves room for one rounding tie going the other way.
ATOL = {"float32": 1e-5, "bfloat16": 1e-4}
# `fused_lstm_scan` returns outputs and final state cast to x's dtype: in
# bf16 that is one rounding of |h|, |c| <~ 2, i.e. up to ~8e-3
WRAPPER_ATOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _arr(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _cast(a, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    j = jnp.asarray(a).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_fwd_ref_matches_pallas_fwd_kernel(dtype):
    rng = np.random.default_rng(0)
    B = 3
    xp_j, xp_t = _cast(_arr(rng, (T, B, 4 * H)), dtype)
    w_j, w_t = _cast(_arr(rng, (H, 4 * H), 0.3), dtype)
    h0, c0 = _arr(rng, (B, H)), _arr(rng, (B, H))
    want = lstm_pallas._fwd(xp_j, w_j, jnp.asarray(h0), jnp.asarray(c0))
    got = lstm_cuda.lstm_fwd(xp_t, w_t, torch.from_numpy(h0), torch.from_numpy(c0))
    for name, a, b in zip(("hs", "cs", "gates"), got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL[dtype], err_msg=name)

    # the public batch-major wrapper: outputs and final state in x's dtype
    out_j, (hf_j, cf_j) = lstm_pallas.fused_lstm_scan(
        jnp.swapaxes(xp_j, 0, 1), w_j, jnp.asarray(h0), jnp.asarray(c0)
    )
    hs, cs, _ = got
    tol = WRAPPER_ATOL[dtype]
    np.testing.assert_allclose(hs.transpose(0, 1).numpy(), _np(out_j), atol=tol)
    np.testing.assert_allclose(hs[-1].numpy(), _np(hf_j), atol=tol)
    np.testing.assert_allclose(cs[-1].numpy(), _np(cf_j), atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_fwd_ref_matches_pallas_fwd2_kernel(dtype):
    rng = np.random.default_rng(1)
    B = 8
    xf, xb = _arr(rng, (B, T, 4 * H)), _arr(rng, (B, T, 4 * H))
    wf_j, wf_t = _cast(_arr(rng, (H, 4 * H), 0.3), dtype)
    wb_j, wb_t = _cast(_arr(rng, (H, 4 * H), 0.3), dtype)
    xcat = np.concatenate([xf.transpose(1, 0, 2), xb[:, ::-1].transpose(1, 0, 2)], axis=1)
    xcat_j, xcat_t = _cast(xcat, dtype)
    zeros = jnp.zeros((2 * B, H), jnp.float32)
    want = lstm_pallas._fwd2(xcat_j, wf_j, wb_j, zeros, zeros)
    got = lstm_cuda.bilstm_fwd(xcat_t.contiguous(), wf_t, wb_t)
    for name, a, b in zip(("hs", "cs", "gates"), got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL[dtype], err_msg=name)

    if dtype == "float32":  # the public wrapper, outputs back in natural time
        out_f, out_b = lstm_pallas.fused_bilstm_scan(
            jnp.asarray(xf), jnp.asarray(xb), wf_j, wb_j
        )
        hs = got[0]
        np.testing.assert_allclose(hs[:, :B].transpose(0, 1).numpy(), _np(out_f), atol=1e-5)
        np.testing.assert_allclose(
            hs[:, B:].flip(0).transpose(0, 1).numpy(), _np(out_b), atol=1e-5
        )


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_lstm_scan_matches_jax(reverse, masked):
    rng = np.random.default_rng(2)
    B = 2
    xp, w = _arr(rng, (B, T, 4 * H)), _arr(rng, (H, 4 * H), 0.3)
    h0, c0 = _arr(rng, (B, H)), _arr(rng, (B, H))
    mask = (rng.uniform(size=(B, T)) > 0.3).astype(np.float32) if masked else None
    out_j, (h_j, c_j) = jax_lstm.lstm_scan(
        jnp.asarray(xp), jnp.asarray(w), jnp.asarray(h0), jnp.asarray(c0), reverse,
        None if mask is None else jnp.asarray(mask),
    )
    out_t, (h_t, c_t) = lstm_scan(
        torch.from_numpy(xp), torch.from_numpy(w), torch.from_numpy(h0), torch.from_numpy(c0),
        reverse, None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), _np(c_j), atol=1e-5)


def _bilstm_params(rng, F):
    s = H ** -0.5
    return {
        f"{d}_{k}": rng.uniform(-s, s, shape).astype(np.float32)
        for d in ("fwd", "bwd")
        for k, shape in (("w_ih", (F, 4 * H)), ("w_hh", (H, 4 * H)), ("b", (4 * H,)))
    }


@pytest.mark.parametrize("B", [2, 8])
def test_bilstm_module_dispatch_matches_jax(B, monkeypatch):
    """B % 8 == 0 runs one two-direction launch, any other batch two
    one-direction launches; both equal the JAX BiLSTM (fp32)."""
    rng = np.random.default_rng(3)
    F = 10
    params = _bilstm_params(rng, F)
    x = _arr(rng, (B, T, F))
    want = jax_lstm.BiLSTM(H, use_pallas=False).apply({"params": params}, jnp.asarray(x))

    calls = {"lstm_fwd": 0, "bilstm_fwd": 0}
    for name in calls:
        fn = getattr(lstm_cuda, name)

        def spy(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(lstm_cuda, name, spy)
    m = BiLSTM(F, H)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.inference_mode():
        got = m(torch.from_numpy(x))
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)
    assert calls == ({"lstm_fwd": 0, "bilstm_fwd": 1} if B % 8 == 0 else
                     {"lstm_fwd": 2, "bilstm_fwd": 0})


def test_wrappers_reject_bad_operands():
    xp = torch.zeros(T, 2, 4 * H)
    w = torch.zeros(H, 4 * H)
    s = torch.zeros(2, H)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_fwd(xp, w.to(torch.bfloat16), s, s)  # mixed operand dtypes
    with pytest.raises(ValueError):
        lstm_cuda.lstm_fwd(xp, w, torch.zeros(3, H), s)  # h0 rows
    with pytest.raises(ValueError):
        lstm_cuda.lstm_fwd(xp.transpose(0, 1), w, s, s)  # not [T, B, 4H]
    with pytest.raises(ValueError):
        lstm_cuda.bilstm_fwd(torch.zeros(T, 3, 4 * H), w, w)  # odd row count
    with pytest.raises(TypeError):
        lstm_cuda.lstm_fwd(xp.half(), w.half(), s, s)


def test_backward_waits_for_training_slice():
    xp = torch.zeros(T, 2, 4 * H, requires_grad=True)
    hs, _, _ = lstm_cuda.lstm_fwd(xp, torch.zeros(H, 4 * H), torch.zeros(2, H), torch.zeros(2, H))
    with pytest.raises(NotImplementedError, match="training slice"):
        hs.sum().backward()
