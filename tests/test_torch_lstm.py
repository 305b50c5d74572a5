"""LSTM parity: the port's plain kernel versions, their gradients and
`BiLSTM` against the JAX package.

The JAX side runs the Pallas kernels `_fwd_kernel` / `_fwd2_kernel` /
`_bwd_kernel` / `_bwd2_kernel` in interpret mode on the CPU (as
`tests/test_pallas_lstm.py` does) through their launchers `_fwd` / `_fwd2`
/ `_bwd` / `_bwd2` and the public `fused_lstm_scan` / `fused_bilstm_scan`
(and their `jax.vjp`).  Inputs are numpy arrays from a seeded generator.
"""

import numpy as np
import pytest
import torch

import jax
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


def _fwd_outputs(xp_j, w_j, h0, c0):
    """Forward residuals of the Pallas kernel: (gates, cs, hs) time-major."""
    hs, cs, gates = lstm_pallas._fwd(xp_j, w_j, jnp.asarray(h0), jnp.asarray(c0))
    return gates, cs, hs


def _t32(a):
    return torch.from_numpy(_np(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_bwd_ref_matches_pallas_bwd_kernel(dtype):
    """`lstm_bwd_ref` (unshifted cs/hs, h0/c0 at t=0) against `_bwd` fed
    the shifted copies `_fused_bwd` builds.  Tolerance as the forward's:
    summation order only, and in bf16 both round dgates and h_prev to bf16
    before fp32-accumulated products."""
    rng = np.random.default_rng(10)
    B = 3
    xp_j, _ = _cast(_arr(rng, (T, B, 4 * H)), dtype)
    w_j, w_t = _cast(_arr(rng, (H, 4 * H), 0.3), dtype)
    h0, c0, dhf, dcf = (_arr(rng, (B, H)) for _ in range(4))
    dhs = _arr(rng, (T, B, H))
    gates, cs, hs = _fwd_outputs(xp_j, w_j, h0, c0)
    cs_prev = jnp.concatenate([jnp.asarray(c0)[None], cs[:-1]])
    hs_prev = jnp.concatenate([jnp.asarray(h0)[None], hs[:-1]])
    want = lstm_pallas._bwd(
        w_j, gates, cs_prev, hs_prev, jnp.asarray(dhs), jnp.asarray(dhf), jnp.asarray(dcf),
        dxp_dtype=jnp.dtype(dtype),
    )
    got = lstm_cuda.lstm_bwd(
        w_t, _t32(gates), _t32(cs), _t32(hs), *map(torch.from_numpy, (h0, c0, dhs, dhf, dcf)),
        getattr(torch, dtype),
    )
    assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
    for name, a, b in zip(("dxp", "dwhh", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(a.float().numpy(), _np(b), atol=ATOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_bwd_ref_matches_pallas_bwd2_kernel(dtype):
    rng = np.random.default_rng(11)
    B = 8
    xp_j, _ = _cast(_arr(rng, (T, 2 * B, 4 * H)), dtype)
    wf_j, wf_t = _cast(_arr(rng, (H, 4 * H), 0.3), dtype)
    wb_j, wb_t = _cast(_arr(rng, (H, 4 * H), 0.3), dtype)
    dhs = _arr(rng, (T, 2 * B, H))
    zeros = jnp.zeros((2 * B, H), jnp.float32)
    hs, cs, gates = lstm_pallas._fwd2(xp_j, wf_j, wb_j, zeros, zeros)
    want = lstm_pallas._bwd2(
        wf_j, wb_j, gates,
        jnp.concatenate([zeros[None], cs[:-1]]), jnp.concatenate([zeros[None], hs[:-1]]),
        jnp.asarray(dhs), dxp_dtype=jnp.dtype(dtype),
    )
    got = lstm_cuda.bilstm_bwd(
        wf_t, wb_t, _t32(gates), _t32(cs), _t32(hs), torch.from_numpy(dhs), getattr(torch, dtype)
    )
    for name, a, b in zip(("dxp", "dwhh_f", "dwhh_b"), got, want):
        np.testing.assert_allclose(a.float().numpy(), _np(b), atol=ATOL[dtype], err_msg=name)


# grads through the public wrappers: fp32 summation order only; in bf16
# dx_proj and dW_hh come back in bf16 on both sides, where a product summed
# in another order can round to the neighbouring bf16 value (one ulp of the
# largest elements, ~0.5, is 2e-3)
GRAD_ATOL = {"float32": 1e-5, "bfloat16": 2e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_fwd_autograd_matches_jax_vjp(dtype):
    """torch autograd through `lstm_fwd` (outputs hs and the final (h, c))
    against `jax.vjp` of `fused_lstm_scan`: dx_proj, dW_hh, dh0, dc0."""
    rng = np.random.default_rng(12)
    B = 2
    x_j, x_t = _cast(_arr(rng, (B, T, 4 * H)), dtype)
    w_j, w_t = _cast(_arr(rng, (H, 4 * H), 0.3), dtype)
    h0, c0 = _arr(rng, (B, H)), _arr(rng, (B, H))
    # cotangents exactly representable in the output type
    d_out_j, d_out_t = _cast(_arr(rng, (B, T, H)), dtype)
    dhf_j, dhf_t = _cast(_arr(rng, (B, H)), dtype)
    dcf_j, dcf_t = _cast(_arr(rng, (B, H)), dtype)
    _, vjp = jax.vjp(lstm_pallas.fused_lstm_scan, x_j, w_j, jnp.asarray(h0), jnp.asarray(c0))
    want = vjp((d_out_j, (dhf_j, dcf_j)))

    x_t.requires_grad_(True), w_t.requires_grad_(True)
    h0_t, c0_t = torch.from_numpy(h0).requires_grad_(), torch.from_numpy(c0).requires_grad_()
    hs, cs, _ = lstm_cuda.lstm_fwd(x_t.transpose(0, 1).contiguous(), w_t, h0_t, c0_t)
    loss = (
        (hs.transpose(0, 1) * d_out_t.float()).sum()
        + (hs[-1] * dhf_t.float()).sum()
        + (cs[-1] * dcf_t.float()).sum()
    )
    loss.backward()
    for name, a, b in zip(("dx_proj", "dw_hh", "dh0", "dc0"),
                          (x_t.grad, w_t.grad, h0_t.grad, c0_t.grad), want):
        assert a.dtype == {"dh0": torch.float32, "dc0": torch.float32}.get(name, x_t.dtype)
        np.testing.assert_allclose(a.float().numpy(), _np(b), atol=GRAD_ATOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_fwd_autograd_matches_jax_vjp(dtype):
    """The module's two-direction layout (rows [B, 2B) time-reversed, output
    flipped back) differentiated by torch against `jax.vjp` of
    `fused_bilstm_scan`."""
    rng = np.random.default_rng(13)
    B = 8
    xf_j, xf_t = _cast(_arr(rng, (B, T, 4 * H)), dtype)
    xb_j, xb_t = _cast(_arr(rng, (B, T, 4 * H)), dtype)
    wf_j, wf_t = _cast(_arr(rng, (H, 4 * H), 0.3), dtype)
    wb_j, wb_t = _cast(_arr(rng, (H, 4 * H), 0.3), dtype)
    df_j, df_t = _cast(_arr(rng, (B, T, H)), dtype)
    db_j, db_t = _cast(_arr(rng, (B, T, H)), dtype)
    _, vjp = jax.vjp(lstm_pallas.fused_bilstm_scan, xf_j, xb_j, wf_j, wb_j)
    want = vjp((df_j, db_j))

    leaves = [a.requires_grad_(True) for a in (xf_t, xb_t, wf_t, wb_t)]
    xcat = torch.cat([xf_t.transpose(0, 1), xb_t.flip(1).transpose(0, 1)], dim=1)
    hs, _, _ = lstm_cuda.bilstm_fwd(xcat.contiguous(), wf_t, wb_t)
    out_f, out_b = hs[:, :B].transpose(0, 1), hs[:, B:].flip(0).transpose(0, 1)
    ((out_f * df_t.float()).sum() + (out_b * db_t.float()).sum()).backward()
    for name, a, b in zip(("dxp_f", "dxp_b", "dw_f", "dw_b"), (t.grad for t in leaves), want):
        np.testing.assert_allclose(a.float().numpy(), _np(b), atol=GRAD_ATOL[dtype], err_msg=name)


@pytest.mark.parametrize("B", [2, 8])
def test_bilstm_module_grads_match_jax(B):
    """`BiLSTM` parameter and input grads (both dispatch paths) against
    `jax.grad` of the JAX module (fp32; its CPU path is `lax.scan`)."""
    rng = np.random.default_rng(14)
    F = 10
    params = _bilstm_params(rng, F)
    x, cot = _arr(rng, (B, T, F)), _arr(rng, (B, T, 2 * H))
    jm = jax_lstm.BiLSTM(H, use_pallas=False)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * cot)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    m = BiLSTM(F, H)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    x_t = torch.from_numpy(x).requires_grad_()
    (m(x_t) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x_t.grad.numpy(), _np(gx), atol=1e-5)
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(gp[k]), atol=1e-5, err_msg=k)


def test_nothing_is_saved_without_grad():
    xp = torch.zeros(T, 2, 4 * H, requires_grad=True)
    args = (torch.zeros(H, 4 * H), torch.zeros(2, H), torch.zeros(2, H))
    with torch.inference_mode():
        hs, _, _ = lstm_cuda.lstm_fwd(xp, *args)
    assert hs.grad_fn is None
    hs, _, _ = lstm_cuda.lstm_fwd(xp, *args)
    assert len(hs.grad_fn.saved_tensors) == 6


def test_cs_before_the_last_step_is_not_differentiable():
    xp = torch.zeros(T, 2, 4 * H, requires_grad=True)
    _, cs, _ = lstm_cuda.lstm_fwd(xp, torch.zeros(H, 4 * H), torch.zeros(2, H), torch.zeros(2, H))
    with pytest.raises(NotImplementedError, match="last step"):
        cs[0].sum().backward()


def test_backward_wrappers_reject_bad_operands():
    R = 2
    w = torch.zeros(H, 4 * H)
    gates, seq, s = torch.zeros(T, R, 4 * H), torch.zeros(T, R, H), torch.zeros(R, H)
    good = (w, gates, seq, seq, s, s, seq, s, s, torch.float32)
    lstm_cuda.lstm_bwd(*good)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_bwd(w.to(torch.bfloat16).t(), *good[1:])  # W_hh shape
    with pytest.raises(ValueError):
        lstm_cuda.lstm_bwd(w, gates.double(), *good[2:])  # gates not fp32
    with pytest.raises(ValueError):
        lstm_cuda.lstm_bwd(*good[:4], torch.zeros(3, H), *good[5:])  # h0 rows
    with pytest.raises(TypeError):
        lstm_cuda.lstm_bwd(*good[:-1], torch.float16)
    with pytest.raises(ValueError):
        lstm_cuda.bilstm_bwd(w, w, torch.zeros(T, 3, 4 * H), *([torch.zeros(T, 3, H)] * 3),
                             torch.float32)  # odd row count
