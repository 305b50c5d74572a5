"""The conv kernels' wide-tile routes: their plain versions against the
JAX package's Pallas kernels at the widths the wide tiles cut differently
from `tests/test_torch_channels.py`, and the tile table that picks each
shape's tile before the launch.

On the card, bf16 at Cin or Cout other than 64 runs `csrc/conv_fwd_wide.cu`
(all output channels of a group of up to 256 in one wgmma.m64nNk16 product)
and `csrc/conv_wgrad_wide.cu` (output groups of up to 128, each time tap's
(input slab, frequency tap) tiles in segments); here the wrappers run their
plain versions and the JAX side its Pallas kernels in interpret mode:

- the dilated conv (`conv2d_pallas`: `_fwd_kernel`; `_conv_wgrad_core`:
  `_wgrad_kernel`) at 192 and 256 channels (one tile of N = 192 / 256),
  320 (two output groups), 128 → 64, 64 → 192 and 72;
- the chain's three kernels at C = 192 (`_conv_fwd`, `_conv_dgrad`,
  `_conv_wgrad`);
- the table (`conv_cuda.fwd_tile`, `wgrad_tile`, the mirror of
  `csrc/conv_wide.cuh`; `chip_smoke.py --phases channels` holds the C table
  to it on the card) over every Cin, Cout that is a multiple of 8 from 64 to
  512, each layer kind and both operand types: each tile fits a block's
  shared memory and its accumulators the register budget.

Tolerances, relative to each output's peak: 1e-4 for fp32 values (the same
products summed in another order), as in `tests/test_torch_channels.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import voicesplit_tpu.ops.conv_fused as jcf
import voicesplit_tpu.ops.conv_pallas as jcp
from voicesplit_tpu.ops.conv_fold import FOLD, fold_input, fold_kernel, unfold_output
from voicesplit_tpu_torch.ops import conv_cuda as cc
from voicesplit_tpu_torch.ops import conv_fused as cf

B, T, F = 2, 9, 11
# (Cin, Cout): N = 192 and 256 in one tile, 320 in two groups, Cout 64 below
# Cin, Cin 64 below Cout, and a width off the 64-channel slabs
WIDTHS = {"192": (192, 192), "256": (256, 256), "320": (320, 320), "128-64": (128, 64),
          "64-192": (64, 192), "72": (72, 72)}
SPECS = {"7x1": ((7, 1), 1), "5x5-d2": ((5, 5), 2)}
C_CHAIN = 192  # the chain's width: 2·C a multiple of 128
F_CHAIN = 37   # the chain's frames need F = 37 (the fold and a frequency tile)
PEAK_TOL = 1e-4
EPS = 1e-5
LAYER_KINDS = {"7x1": (7, 1), **{f"5x5-d{d}": (5, 5) for d in (1, 2, 4, 8, 16, 32)},
               "7x3": (7, 3), "3x3": (3, 3)}  # the most time taps the forward takes at kf = 3
SWEEP = range(64, 513, 8)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _small_tiles(monkeypatch):
    monkeypatch.setenv("VOICESPLIT_CONV_TILES", "16,64")


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_peak_close(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=msg)


def _inputs(seed, kt, kf, cin, cout, f=F):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, f, cin)).astype(np.float32)
    dy = rng.standard_normal((B, T, f, cout)).astype(np.float32)
    w = ((kt * kf * cin) ** -0.5 * rng.standard_normal((kt, kf, cin, cout))).astype(np.float32)
    return x, dy, w


# ---------------------------------------------------------------------------
# The dilated conv against `conv_pallas`
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_wide_forward_plain_version_matches_pallas_kernel(width, spec):
    (kt, kf), dt = SPECS[spec]
    cin, cout = WIDTHS[width]
    x, _, w = _inputs(11, kt, kf, cin, cout)
    want = jcp.conv2d_pallas(jnp.asarray(x), jnp.asarray(w), (dt, 1))
    got = cc.conv_dilated_fwd(torch.from_numpy(x), torch.from_numpy(w), dt)
    assert got.shape == (B, T, F, cout) and got.is_contiguous()
    _assert_peak_close(got.numpy(), _np(want), PEAK_TOL)


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_wide_wgrad_plain_version_matches_pallas_kernel(width, spec):
    (kt, kf), dt = SPECS[spec]
    cin, cout = WIDTHS[width]
    x, dy, _ = _inputs(12, kt, kf, cin, cout)
    want = jcp._conv_wgrad_core(jnp.asarray(x), jnp.asarray(dy), (kt, kf), (dt, 1))
    got = cc.conv_dilated_wgrad(torch.from_numpy(x), torch.from_numpy(dy), kt, kf, dt)
    assert got.shape == (kt, kf, cin, cout) and got.dtype == torch.float32
    _assert_peak_close(got.numpy(), _np(want), PEAK_TOL)


# ---------------------------------------------------------------------------
# The chain's kernels at C = 192 against the Pallas chain's
# ---------------------------------------------------------------------------


def _geom(kt, dt):
    return jcf.FrameGeom(T, F_CHAIN, FOLD * C_CHAIN, (kt - 1) * dt // 2)


def _frame(x, geom):
    return jcf.to_frame(fold_input(jnp.asarray(x)), geom)


def _unframe(frame, geom):
    return _np(unfold_output(jcf.from_frame(frame, geom), F_CHAIN))


def _unfold_channels(v):
    return _np(v).reshape(FOLD, C_CHAIN).sum(0)


def _layer(seed, kt, kf):
    rng = np.random.default_rng(seed)
    C = C_CHAIN
    x = rng.standard_normal((B, T, F_CHAIN, C)).astype(np.float32)
    w = ((kt * kf * C) ** -0.5 * rng.standard_normal((kt, kf, C, C))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    bn = (0.2 * rng.standard_normal(C), rng.uniform(0.5, 2.0, C), rng.uniform(0.5, 1.5, C),
          0.1 * rng.standard_normal(C))
    bn = tuple(a.astype(np.float32) for a in bn)
    return x, w, bias, (cf._scal_table(*map(torch.from_numpy, bn), eps=EPS),
                        jcf._scal_table(*map(jnp.asarray, bn), eps=EPS))


def test_chain_forward_at_192_channels_matches_pallas_kernel():
    (kt, kf), dt = SPECS["5x5-d2"]
    x, w, bias, (scal_t, scal_j) = _layer(13, kt, kf)
    geom = _geom(kt, dt)
    wf = fold_kernel(jnp.asarray(w))
    frame, stats = jcf._conv_fwd(
        _frame(x, geom), jcf._pack(wf), scal_j, jnp.tile(jnp.asarray(bias), FOLD)[None, :],
        geom, kt, wf.shape[1], dt, "mish", True,
    )
    raw, st = cf.conv_bn_act_fwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), scal_t,
                                 dt, "mish", True)
    assert raw.shape == (B, T, F_CHAIN, C_CHAIN) and st.shape == (2, C_CHAIN)
    _assert_peak_close(raw.numpy(), _unframe(frame, geom), PEAK_TOL)
    _assert_peak_close(st[0].numpy(), _unfold_channels(stats[0]), PEAK_TOL, "sum")
    _assert_peak_close(st[1].numpy(), _unfold_channels(stats[1]), PEAK_TOL, "sum of squares")


def test_chain_dgrad_at_192_channels_matches_pallas_kernel():
    (kt, kf), dt = SPECS["7x1"]
    d_raw, w, _, _ = _layer(14, kt, kf)
    geom = _geom(kt, dt)
    wf = fold_kernel(jnp.asarray(w))
    frame = _frame(d_raw, geom)
    out, dbias = jcf._conv_dgrad(
        frame, frame, jcf._flip_packed(wf), jnp.zeros((8, FOLD * C_CHAIN), jnp.float32), geom, kt,
        wf.shape[1], dt, None, prologue=False,
    )
    dx, db = cf.conv_dgrad(torch.from_numpy(d_raw), cf.pack_weight_flipped(torch.from_numpy(w), torch.float32),
                           dt)
    assert dx.shape == (B, T, F_CHAIN, C_CHAIN) and db.shape == (C_CHAIN,)
    _assert_peak_close(dx.numpy(), _unframe(out, geom), PEAK_TOL)
    _assert_peak_close(db.numpy(), _unfold_channels(dbias[0]), PEAK_TOL, "dbias")


def test_chain_wgrad_at_192_channels_matches_pallas_kernel():
    (kt, kf), dt = SPECS["5x5-d2"]
    x, _, _, (scal_t, scal_j) = _layer(15, kt, kf)
    d_raw = np.random.default_rng(16).standard_normal((B, T, F_CHAIN, C_CHAIN)).astype(np.float32)
    geom = _geom(kt, dt)
    zero = jnp.zeros((8, FOLD * C_CHAIN), jnp.float32)
    kb = fold_kernel(jnp.zeros((kt, kf, 1, 1))).shape[1]
    d_frame = _frame(d_raw, geom)
    dwf = jcf._conv_wgrad(
        _frame(x, geom), d_frame, d_frame, scal_j, zero, geom, kt, kb, dt, "mish", None,
        lhs_prologue=True, rhs_prologue=False,
    )
    want = jcf._unfold_grad(dwf, kt, kf, C_CHAIN, C_CHAIN)
    got = cf.conv_wgrad(torch.from_numpy(x), torch.from_numpy(d_raw), scal_t, kt, kf, dt, "mish", True)
    assert got.shape == (kt, kf, C_CHAIN, C_CHAIN)
    _assert_peak_close(got.numpy(), _np(want), PEAK_TOL)


# ---------------------------------------------------------------------------
# The tile table
# ---------------------------------------------------------------------------


def _fits(tile, what):
    assert tile["smem_bytes"] <= cc.SMEM_LIMIT, (what, tile)
    assert 0 < tile["accumulators"] <= cc.ACCUMULATOR_LIMIT, (what, tile)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layer", sorted(LAYER_KINDS))
def test_every_width_gets_a_tile_that_fits(layer, dtype):
    """Every (Cin, Cout) that `takes_layer` sends (multiples of 8 from 64 to
    512 here) gets its route, and on the wide tiles (bf16 at other widths
    than 64) a forward and a weight-gradient tile whose shared memory fits
    a block (227 KB) and whose accumulators fit the register budget; the
    chain's modes at every C it takes (multiples of 64), the eval mode at
    every width the plain mode takes.  The wide forward
    covers all output channels up to 256 in one group, as few groups above;
    the weight gradient groups of up to 128.  C = 64 and fp32 keep the
    fixed tiles of their own instantiations."""
    kt, kf = LAYER_KINDS[layer]
    dt = getattr(torch, dtype)
    for cin in SWEEP:
        for cout in SWEEP:
            fwd = cc.fwd_tile(cin, cout, kt, kf, dt)
            wgrad = cc.wgrad_tile(cin, cout, kf, dt)
            want = "64" if cin == cout == 64 else "tiles" if dtype == "bfloat16" else "slab"
            assert fwd["route"] == wgrad["route"] == want
            if want != "tiles":
                assert fwd == wgrad == {"route": want}
                continue
            ev = cc.fwd_tile(cin, cout, kt, kf, dt, "eval")
            assert all(ev[k] == fwd[k] for k in ("n", "groups", "mt", "tf", "ring"))
            for tile in (fwd, wgrad, ev):
                _fits(tile, (cin, cout))
            assert fwd["groups"] == -(-cout // 256) and fwd["groups"] * fwd["n"] >= cout
            assert fwd["n"] in cc.FWD_WIDTHS and fwd["mt"] * 64 == fwd["tf"]
            assert fwd["wbufs"] in (2, 3, 4) and fwd["ring"] == kt + 3
            assert wgrad["groups"] == -(-cout // 128) and wgrad["groups"] * wgrad["n"] >= cout
            assert wgrad["n"] in cc.WGRAD_WIDTHS
            tiles = -(-cin // 64) * kf
            assert wgrad["seg_tiles"] <= 2 * wgrad["tw"] and wgrad["segs"] * wgrad["seg_tiles"] >= tiles
    for C in range(64, 513, 64):
        for mode in ("dgrad", "chain"):
            tile = cc.fwd_tile(C, C, kt, kf, dt, mode)
            assert tile["route"] == ("64" if C == 64 else "tiles" if dtype == "bfloat16" else "slab")
            if tile["route"] == "tiles":
                _fits(tile, (C, mode))
                assert tile["n"] >= 128  # the chain's modes are built for 128, 192 and 256


def test_tiles_at_the_model_widths():
    """The tiles the channels phase launches: 128 channels (5,5) in one
    n128 tile of two m64 products a warpgroup, four weight slices in
    flight, three weight-gradient segments of at most four tiles (two
    n128 tiles a warpgroup) touching at most two slabs; 192 and 256 in one
    n192 / n256 tile; 320 in two groups of 160 on the n192 tile; the
    chain's (7,1) forward at 128 three slices in flight."""
    bf16 = torch.bfloat16
    t = cc.fwd_tile(128, 128, 5, 5, bf16)
    assert (t["n"], t["groups"], t["mt"], t["tf"], t["wbufs"]) == (128, 1, 2, 128, 4)
    w = cc.wgrad_tile(128, 128, 5, bf16)
    assert (w["n"], w["groups"], w["tw"], w["segs"], w["seg_tiles"], w["slabs"]) == (128, 1, 2, 3, 4, 2)
    assert cc.wgrad_tile(96, 96, 5, bf16)["segs"] == 2
    assert [cc.fwd_tile(c, c, 5, 5, bf16)["n"] for c in (96, 192, 256, 320)] == [96, 192, 256, 192]
    assert cc.fwd_tile(320, 320, 5, 5, bf16)["groups"] == 2
    assert cc.fwd_tile(128, 128, 7, 1, bf16, "chain")["wbufs"] == 3
    assert cc.wgrad_tile(128, 128, 1, bf16)["segs"] == 1 and cc.wgrad_tile(256, 256, 5, bf16)["groups"] == 2
