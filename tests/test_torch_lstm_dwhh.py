"""dW_hh of the LSTM backward as its own product: `lstm_cuda.lstm_dwhh_ref`
(the plain version of the kernel that `lstm_bwd` / `bilstm_bwd` launch
after their reverse walk) against the dW_hh that the JAX package's Pallas
backward kernels `_bwd_kernel` / `_bwd2_kernel` accumulate inside their
walk, run in interpret mode on the CPU through `lstm_pallas._bwd` /
`_bwd2` (as `tests/test_torch_lstm.py` runs them); and the plain backward
versions, which now take their dW_hh from `lstm_dwhh_ref`, against the
in-walk accumulation they had before, bit for bit.  Inputs are numpy
arrays from a seeded generator.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicesplit_tpu.ops import lstm_pallas
from voicesplit_tpu_torch.ops import lstm_cuda

# the same tolerances as the backward tests of tests/test_torch_lstm.py:
# both sides multiply the same rounded operands and accumulate in fp32, and
# only the order of the sum over (t, r) differs
ATOL = {"float32": 1e-5, "bfloat16": 1e-4}
SHAPES = [(7, 1, 8), (5, 3, 24), (9, 2, 40)]  # (T, B rows a direction, H)


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


def _t32(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


def _shifted(first, seq):
    return jnp.concatenate([first[None], seq[:-1]])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "T{}-B{}-H{}".format(*s))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("directions", [1, 2])
def test_lstm_dwhh_ref_matches_pallas_backward_dw(directions, dtype, shape):
    """dW_hh of `_bwd` (one direction from a random (h0, c0)) or `_bwd2`
    (both directions, zero state) against `lstm_dwhh_ref` on the same
    forward's hs and the same backward's dxp, which in the operand type is
    the rounded dgates of the Pallas kernel's product."""
    T, B, H = shape
    R = directions * B
    rng = np.random.default_rng(20 + 7 * directions + T)
    xp_j, _ = _cast(_arr(rng, (T, R, 4 * H)), dtype)
    ws = [_cast(_arr(rng, (H, 4 * H), 0.3), dtype)[0] for _ in range(directions)]
    dhs = jnp.asarray(_arr(rng, (T, R, H)))
    if directions == 1:
        h0, c0, dhf, dcf = (jnp.asarray(_arr(rng, (R, H))) for _ in range(4))
        hs, cs, gates = lstm_pallas._fwd(xp_j, ws[0], h0, c0)
        dxp, dw, _, _ = lstm_pallas._bwd(ws[0], gates, _shifted(c0, cs), _shifted(h0, hs), dhs,
                                         dhf, dcf, dxp_dtype=jnp.dtype(dtype))
        want, h0_t = (dw,), _t32(h0)
    else:
        zeros = jnp.zeros((R, H), jnp.float32)
        hs, cs, gates = lstm_pallas._fwd2(xp_j, ws[0], ws[1], zeros, zeros)
        dxp, dwf, dwb = lstm_pallas._bwd2(ws[0], ws[1], gates, _shifted(zeros, cs),
                                          _shifted(zeros, hs), dhs, dxp_dtype=jnp.dtype(dtype))
        want, h0_t = (dwf, dwb), None
    dg = _t32(dxp).to(getattr(torch, dtype))
    got = lstm_cuda.lstm_dwhh(_t32(hs), h0_t, dg, directions, getattr(torch, dtype))
    assert len(got) == directions
    for d, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.float32 and tuple(a.shape) == (H, 4 * H)
        np.testing.assert_allclose(a.numpy(), _t32(b).numpy(), atol=ATOL[dtype], err_msg=f"d={d}")


def _walk_with_dw_inside(ws, gates, cs, hs, h0, c0, dhs, dhf, dcf, x_dtype):
    """The plain backward as it was before dW_hh became its own product:
    dW_hh accumulated inside the reverse walk."""
    T, R, G = gates.shape
    H = G // 4
    D = len(ws)
    B = R // D
    op = ws[0].dtype
    wf = [w.float() for w in ws]
    dws = [torch.zeros(H, G, dtype=torch.float32) for _ in ws]
    dxp = torch.empty(T, R, G, dtype=x_dtype)
    dh_carry, dc_carry = dhf.float(), dcf.float()
    for t in range(T - 1, -1, -1):
        i, f, g, o = gates[t].split(H, dim=-1)
        c_prev = cs[t - 1] if t else c0.float()
        h_prev = hs[t - 1] if t else h0.float()
        tc = torch.tanh(f * c_prev + i * g)
        dh = dhs[t] + dh_carry
        do = dh * tc
        dct = dh * o * (1.0 - tc * tc) + dc_carry
        dc_carry = dct * f
        dgates = torch.cat(
            [dct * g * i * (1.0 - i), dct * c_prev * f * (1.0 - f),
             dct * i * (1.0 - g * g), do * o * (1.0 - o)],
            dim=-1,
        )
        dxp[t] = dgates.to(x_dtype)
        dgr = dgates.to(op).float()
        hr = h_prev.to(op).float()
        rows = [slice(d * B, (d + 1) * B) for d in range(D)]
        dh_carry = torch.cat([dgr[r] @ w.t() for r, w in zip(rows, wf)], dim=0)
        for r, dw in zip(rows, dws):
            dw += hr[r].t() @ dgr[r]
    return dxp, dws, dh_carry, dc_carry


@pytest.mark.parametrize("x_dtype", ["same", "float32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("directions", [1, 2])
def test_plain_backward_equals_the_walk_with_dw_inside_bit_for_bit(directions, dtype, x_dtype):
    T, B, H = 9, 3, 24
    R = directions * B
    g = torch.Generator().manual_seed(5 + directions)
    op = getattr(torch, dtype)
    xd = op if x_dtype == "same" else torch.float32
    xp = torch.randn(T, R, 4 * H, generator=g).to(op)
    ws = [(0.3 * torch.randn(H, 4 * H, generator=g)).to(op) for _ in range(directions)]
    dhs = torch.randn(T, R, H, generator=g)
    if directions == 1:
        h0, c0, dhf, dcf = (torch.randn(R, H, generator=g) for _ in range(4))
        hs, cs, gates = lstm_cuda.lstm_fwd_ref(xp, ws[0], h0, c0)
        got = lstm_cuda.lstm_bwd_ref(ws[0], gates, cs, hs, h0, c0, dhs, dhf, dcf, xd)
        dxp, dws, dh0, dc0 = _walk_with_dw_inside(ws, gates, cs, hs, h0, c0, dhs, dhf, dcf, xd)
        want = (dxp, dws[0], dh0, dc0)
    else:
        hs, cs, gates = lstm_cuda.bilstm_fwd_ref(xp, ws[0], ws[1])
        got = lstm_cuda.bilstm_bwd_ref(ws[0], ws[1], gates, cs, hs, dhs, xd)
        zeros = torch.zeros(R, H)
        dxp, dws, _, _ = _walk_with_dw_inside(ws, gates, cs, hs, zeros, zeros, dhs, zeros, zeros, xd)
        want = (dxp, *dws)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_lstm_dwhh_zero_state_adds_nothing_and_directions_take_their_rows():
    """h0 None equals h0 zero; with two directions each dW sees only its own
    rows: a direction whose dg is zero gets a zero dW_hh."""
    T, B, H = 6, 2, 8
    g = torch.Generator().manual_seed(3)
    hs = torch.randn(T, 2 * B, H, generator=g)
    dg = torch.randn(T, 2 * B, 4 * H, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        a = lstm_cuda.lstm_dwhh(hs, None, dg, 2, dtype)
        b = lstm_cuda.lstm_dwhh(hs, torch.zeros(2 * B, H), dg, 2, dtype)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    dg[:, B:] = 0
    dwf, dwb = lstm_cuda.lstm_dwhh(hs, None, dg, 2, torch.float32)
    assert bool(dwf.abs().sum() > 0) and not bool(dwb.any())
    (one,) = lstm_cuda.lstm_dwhh(hs[:, :B].contiguous(), None, dg[:, :B].contiguous(), 1,
                                 torch.float32)
    assert torch.equal(one, dwf)


def test_lstm_dwhh_rejects_what_the_kernel_does_not_take():
    T, R, H = 4, 2, 8
    hs, dg = torch.zeros(T, R, H), torch.zeros(T, R, 4 * H)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_dwhh(hs, None, dg[:, :, :-4], 1, torch.float32)  # dg width
    with pytest.raises(ValueError):
        lstm_cuda.lstm_dwhh(hs[:, :1].contiguous(), None, dg[:, :1].contiguous(), 2, torch.float32)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_dwhh(hs, torch.zeros(R, H + 1), dg, 1, torch.float32)  # h0 shape
    with pytest.raises(ValueError):
        lstm_cuda.lstm_dwhh(hs.double(), None, dg, 1, torch.float32)  # hs not fp32
    with pytest.raises(ValueError):
        lstm_cuda.lstm_dwhh(hs.transpose(0, 1), None, dg, 1, torch.float32)  # not [T, R, H]
    with pytest.raises(TypeError):
        lstm_cuda.lstm_dwhh(hs, None, dg, 1, torch.float16)
