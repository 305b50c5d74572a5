"""The BatchNorm-backward prologue branches of the fused chain's data- and
weight-gradient kernels: the port's d_raw pass `conv_draw_prologue`
followed by `conv_dgrad` or `conv_wgrad` against the JAX package's Pallas
kernels with those branches, ``_conv_dgrad(..., prologue=True)`` and
``_conv_wgrad(..., rhs_prologue=True)``, in interpret mode on the CPU.

Geometry, inputs and the conversions to the JAX kernels' folded frames come
from `tests/test_torch_conv_fused.py`.  The scalar table has all six rows
set (the forward's four and the backward's mean(dz), mean(dz·x̂)), so every
term of ``d_raw = inv·(dy·act'(z) − mean(dz) − x̂·mean(dz·x̂))`` is in play.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voicesplit_tpu.ops.conv_fused as jcf
from test_torch_conv_fused import (
    B, EPS, F, FOLD, GEOMS, PEAK_TOL, SPECS, T, _assert_peak_close, _frame, _layer_inputs, _np,
    _unframe,
)
from voicesplit_tpu.ops.conv_fold import fold_kernel
from voicesplit_tpu_torch.ops import conv_fused as cf

ACTS = ("mish", "relu")
# bf16 operands, relative to each output's peak: both sides draw d_raw in
# fp32 from the same bf16 inputs and round it once, but XLA may compute
# mish' with other roundings, which can flip one bf16 rounding of d_raw.  dx
# is rounded once from an fp32 sum taken in another order (the fold), so an
# element may round the other way: one bf16 ulp, at most 2^-7 of the peak.
# dbias and dW add rounded d_raw (and exact products) in another order.
BF16_TOL = {"dx": 1e-2, "dbias": 1e-3, "dw": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _geom(spec, C):
    (kt, _), dt = SPECS[spec]
    return GEOMS[spec] if C == 64 else jcf.FrameGeom(T, F, FOLD * C, (kt - 1) * dt // 2)


def _unfold_channels(v, C) -> np.ndarray:
    """A folded [2C] per-channel sum → [C]."""
    return _np(v).reshape(FOLD, C).sum(0)


def _draw_inputs(seed, C=64):
    """Cotangent dy, raw conv output x and the full scalar table of one
    layer's BatchNorm, in both packages' layouts."""
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((B, T, F, C)).astype(np.float32)
    x = (0.2 + 1.3 * rng.standard_normal((B, T, F, C))).astype(np.float32)
    mean = (0.2 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    var = rng.uniform(1.0, 2.5, C).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    beta = (0.1 * rng.standard_normal(C)).astype(np.float32)
    mdz = (0.1 * rng.standard_normal(C)).astype(np.float32)
    mdzx = (0.1 * rng.standard_normal(C)).astype(np.float32)
    bn = (mean, var, scale, beta)
    scal_t = cf._scal_table(*map(torch.from_numpy, bn), mean_dz=torch.from_numpy(mdz),
                            mean_dzx=torch.from_numpy(mdzx), eps=EPS)
    scal_j = jcf._scal_table(*map(jnp.asarray, bn), mean_dz=jnp.asarray(mdz),
                             mean_dzx=jnp.asarray(mdzx), eps=EPS)
    return dy, x, scal_t, scal_j


def _weights(seed, kt, kf, C=64):
    return (0.08 * np.random.default_rng(seed).standard_normal((kt, kf, C, C))).astype(np.float32)


def _dgrad_branch(dy, x, w, scal, act, dt, dtype=torch.float32):
    """The port's ``prologue=True`` branch: the d_raw pass, then `conv_dgrad`."""
    d_raw = cf.conv_draw_prologue(dy, x, scal, act)
    return cf.conv_dgrad(d_raw, cf.pack_weight_flipped(torch.from_numpy(w), dtype), dt)


def _wgrad_branch(x_in, dy, x, scal_prev, scal, kt, kf, dt, act_prev, act):
    """The port's ``rhs_prologue`` branch: the d_raw pass, then `conv_wgrad`
    (with its input prologue where `act_prev` is set)."""
    d_raw = cf.conv_draw_prologue(dy, x, scal, act)
    return cf.conv_wgrad(x_in, d_raw, scal_prev, kt, kf, dt, act_prev, act_prev is not None)


def _jax_dgrad(dy, x, w, scal_j, spec, act, C=64, dtype=jnp.float32):
    (kt, _), dt = SPECS[spec]
    g = _geom(spec, C)
    wf = fold_kernel(jnp.asarray(w).astype(dtype))
    out, dbias = jcf._conv_dgrad(
        _frame(dy, g, dtype), _frame(x, g, dtype), jcf._flip_packed(wf), scal_j, g, kt, wf.shape[1],
        dt, act, prologue=True,
    )
    return _unframe(out, g), _unfold_channels(dbias[0], C)


def _jax_wgrad(x_in, dy, x, scal_prev_j, scal_j, spec, act_prev, act, C=64, dtype=jnp.float32):
    (kt, kf), dt = SPECS[spec]
    g = _geom(spec, C)
    kb = fold_kernel(jnp.zeros((kt, kf, 1, 1))).shape[1]
    lhs = act_prev is not None
    if scal_prev_j is None:
        scal_prev_j = jnp.zeros((8, FOLD * C), jnp.float32)
    dwf = jcf._conv_wgrad(
        _frame(x_in, g, dtype), _frame(dy, g, dtype), _frame(x, g, dtype), scal_prev_j, scal_j, g,
        kt, kb, dt, act_prev, act, lhs_prologue=lhs, rhs_prologue=True,
    )
    return _np(jcf._unfold_grad(dwf, kt, kf, C, C))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_dgrad_prologue_branch_matches_pallas_kernel(spec, act):
    (kt, kf), dt = SPECS[spec]
    dy, x, scal_t, scal_j = _draw_inputs(11, 64)
    w = _weights(12, kt, kf)
    want_dx, want_db = _jax_dgrad(dy, x, w, scal_j, spec, act)
    dx, db = _dgrad_branch(torch.from_numpy(dy), torch.from_numpy(x), w, scal_t, act, dt)
    assert dx.shape == (B, T, F, 64) and dx.is_contiguous() and db.shape == (64,)
    _assert_peak_close(dx.numpy(), want_dx, PEAK_TOL, "dx")
    _assert_peak_close(db.numpy(), want_db, PEAK_TOL, "dbias")


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_wgrad_rhs_prologue_branch_matches_pallas_kernel(spec, act):
    (kt, kf), dt = SPECS[spec]
    dy, x, scal_t, scal_j = _draw_inputs(13, 64)
    x_in = np.random.default_rng(14).standard_normal((B, T, F, 64)).astype(np.float32)
    want = _jax_wgrad(x_in, dy, x, None, scal_j, spec, None, act)
    got = _wgrad_branch(torch.from_numpy(x_in), torch.from_numpy(dy), torch.from_numpy(x),
                        torch.zeros(8, 64), scal_t, kt, kf, dt, None, act)
    assert got.shape == (kt, kf, 64, 64) and got.dtype == torch.float32
    _assert_peak_close(got.numpy(), want, PEAK_TOL)


@pytest.mark.parametrize("acts", [("mish", "mish"), ("relu", "mish"), ("mish", "relu")],
                         ids=lambda a: "-".join(a))
def test_wgrad_with_both_prologues_matches_pallas_kernel(acts):
    """The input's prologue (the previous layer's BN + activation) and the
    cotangent's (this layer's BN backward) on together, each with its own
    table and activation, as `_conv_wgrad`'s ``scal_prev`` / ``scal`` and
    ``act_prev`` / ``act``."""
    act_prev, act = acts
    spec = "5x5-d2"
    (kt, kf), dt = SPECS[spec]
    dy, x, scal_t, scal_j = _draw_inputs(15, 64)
    x_in, _, _, bn = _layer_inputs(16, kt, kf)
    scal_prev_t = cf._scal_table(*map(torch.from_numpy, bn), eps=EPS)
    scal_prev_j = jcf._scal_table(*map(jnp.asarray, bn), eps=EPS)
    want = _jax_wgrad(x_in, dy, x, scal_prev_j, scal_j, spec, act_prev, act)
    got = _wgrad_branch(torch.from_numpy(x_in), torch.from_numpy(dy), torch.from_numpy(x), scal_prev_t,
                        scal_t, kt, kf, dt, act_prev, act)
    _assert_peak_close(got.numpy(), want, PEAK_TOL)


@pytest.mark.parametrize("act", ACTS)
def test_branches_match_pallas_kernels_in_bf16(act):
    spec = "5x5-d4"
    (kt, kf), dt = SPECS[spec]
    dy, x, scal_t, scal_j = _draw_inputs(17, 64)
    w = _weights(18, kt, kf)
    x_in = np.random.default_rng(19).standard_normal((B, T, F, 64)).astype(np.float32)
    bf = torch.bfloat16
    dyt, xt = torch.from_numpy(dy).to(bf), torch.from_numpy(x).to(bf)
    want_dx, want_db = _jax_dgrad(dy, x, w, scal_j, spec, act, dtype=jnp.bfloat16)
    dx, db = _dgrad_branch(dyt, xt, w, scal_t, act, dt, bf)
    assert dx.dtype == bf and db.dtype == torch.float32
    _assert_peak_close(dx.float().numpy(), want_dx, BF16_TOL["dx"], "dx")
    _assert_peak_close(db.numpy(), want_db, BF16_TOL["dbias"], "dbias")
    want_dw = _jax_wgrad(x_in, dy, x, None, scal_j, spec, None, act, dtype=jnp.bfloat16)
    dw = _wgrad_branch(torch.from_numpy(x_in).to(bf), dyt, xt, torch.zeros(8, 64), scal_t, kt, kf, dt,
                       None, act)
    _assert_peak_close(dw.numpy(), want_dw, BF16_TOL["dw"], "dW")


@pytest.mark.parametrize("branch", ["dgrad", "wgrad"])
def test_branches_at_128_channels_match_pallas_kernels(branch):
    C, spec, act = 128, "5x5", "mish"
    (kt, kf), dt = SPECS[spec]
    dy, x, scal_t, scal_j = _draw_inputs(20, C)
    if branch == "dgrad":
        w = _weights(21, kt, kf, C)
        want_dx, want_db = _jax_dgrad(dy, x, w, scal_j, spec, act, C)
        dx, db = _dgrad_branch(torch.from_numpy(dy), torch.from_numpy(x), w, scal_t, act, dt)
        _assert_peak_close(dx.numpy(), want_dx, PEAK_TOL, "dx")
        _assert_peak_close(db.numpy(), want_db, PEAK_TOL, "dbias")
    else:
        x_in = np.random.default_rng(22).standard_normal((B, T, F, C)).astype(np.float32)
        want = _jax_wgrad(x_in, dy, x, None, scal_j, spec, None, act, C)
        got = _wgrad_branch(torch.from_numpy(x_in), torch.from_numpy(dy), torch.from_numpy(x),
                            torch.zeros(8, C), scal_t, kt, kf, dt, None, act)
        _assert_peak_close(got.numpy(), want, PEAK_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_branch_is_the_draw_pass_then_the_prologue_free_call(dtype):
    """The branches as the card runs them: the d_raw pass, bit for bit its
    plain version and `_prologue_draw_inplace`'s arithmetic (one rounding
    of an fp32 draw), then `conv_dgrad` / `conv_wgrad` on its output, bit
    for bit the plain versions' composition."""
    spec, act = "5x5-d2", "mish"
    (kt, kf), dt = SPECS[spec]
    dy, x, scal_t, _ = _draw_inputs(23, 64)
    td = getattr(torch, dtype)
    dyt, xt = torch.from_numpy(dy).to(td), torch.from_numpy(x).to(td)
    w = cf.pack_weight_flipped(torch.from_numpy(_weights(24, kt, kf)), td)
    x_in = torch.from_numpy(np.random.default_rng(25).standard_normal((B, T, F, 64)).astype(np.float32)).to(td)
    zero = torch.zeros(8, 64)

    d_raw = cf.conv_draw_prologue(dyt, xt, scal_t, act)
    assert d_raw.dtype == td and d_raw.is_contiguous()
    assert torch.equal(d_raw, cf.conv_draw_prologue_ref(dyt, xt, scal_t, act))
    plain_d_raw = cf.conv_draw_prologue_ref(dyt, xt, scal_t, act)
    for a, b in zip(cf.conv_dgrad(d_raw, w, dt), cf.conv_dgrad_ref(plain_d_raw, w, dt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(cf.conv_wgrad(x_in, d_raw, zero, kt, kf, dt, None, False),
                       cf.conv_wgrad_ref(x_in, plain_d_raw, zero, kt, kf, dt, None, False))

    # the draw in fp32 from the operand-type inputs, rounded once
    x32 = xt.float()
    z = x32 * scal_t[cf._S_INV] + scal_t[cf._S_SHIFT]
    dz = dyt.float() * cf._act_deriv(z, act)
    xhat = (x32 - scal_t[cf._S_MEAN]) * scal_t[cf._S_R]
    want = (scal_t[cf._S_INV] * (dz - scal_t[cf._S_MDZ] - xhat * scal_t[cf._S_MDZX])).to(td)
    assert torch.equal(d_raw, want)


@pytest.mark.parametrize("act", ACTS)
def test_draw_pass_matches_the_jax_draw_in_fp32(act):
    """In fp32 the JAX chain's XLA pass (`_materialize_draw`, which also
    re-zeroes the frame's margins) computes the same d_raw as the d_raw pass;
    its real region against the pass, and zeros outside it."""
    dy, x, scal_t, scal_j = _draw_inputs(26, 64)
    g = GEOMS["5x5-d16"]
    frame = jcf._materialize_draw(_frame(dy, g), _frame(x, g), scal_j, act, g)
    got = cf.conv_draw_prologue(torch.from_numpy(dy), torch.from_numpy(x), scal_t, act)
    _assert_peak_close(got.numpy(), _unframe(frame, g), 1e-5)
    real = jnp.zeros_like(frame).at[:, g.tpad:g.tpad + T, jcf.FOFF:jcf.FOFF + g.Fb].set(1.0)
    assert float(jnp.abs(jnp.where(real > 0, 0.0, frame)).max()) == 0.0


REFUSALS = {
    "without_x": (lambda dy, s: cf.conv_draw_prologue(dy, None, s, "mish"), "d_raw prologue needs x"),
    "without_scal": (lambda dy, s: cf.conv_draw_prologue(dy, dy, None, "relu"), "d_raw prologue needs x"),
    "without_act": (lambda dy, s: cf.conv_draw_prologue(dy, dy, s, None), "act 'mish' or 'relu'"),
    "act_gelu": (lambda dy, s: cf.conv_draw_prologue(dy, dy, s, "gelu"), "act 'mish' or 'relu'"),
    "x_of_another_shape": (lambda dy, s: cf.conv_draw_prologue(dy, dy[:, :-1].contiguous(), s, "mish"),
                           "one shape and type"),
    "x_of_another_type": (lambda dy, s: cf.conv_draw_prologue(dy, dy.to(torch.bfloat16), s, "mish"),
                          "one shape and type"),
    "scal_of_another_width": (lambda dy, s: cf.conv_draw_prologue(dy, dy, s[:, :32], "mish"),
                              "scal must be"),
    "half_precision": (lambda dy, s: cf.conv_draw_prologue(dy.half(), dy.half(), s, "mish"),
                       "bf16 or fp32"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_prologue_branches_refuse_what_they_cannot_draw(case):
    fn, match = REFUSALS[case]
    with pytest.raises((ValueError, TypeError), match=match):
        fn(torch.zeros(B, T, F, 64), torch.zeros(8, 64))
