"""The LSTM kernels' plain versions in the grid routes' shape class, against
the JAX package's Pallas kernels, and the timing script's encoder shapes.

On the card the fp32 grid routes (`lstm_fwd_grid_kernel`,
`lstm_bwd_grid_kernel`, then `lstm_dwhh_f32_kernel`) carry the GE2E speaker
encoder: one direction from a carried state, its rows in passes of up to 96
(forward) and a block's units in blocks of 8.  These tests hold the plain
versions the card checks those kernels against (`lstm_cuda.lstm_fwd_ref`,
`lstm_bwd_ref`, `lstm_dwhh_ref`) to `lstm_pallas._fwd` / `_bwd` in interpret
mode on the CPU, in fp32, one direction, from a nonzero (h0, c0) and, in the
backward, nonzero final-state cotangents, at H a multiple of 32 (64) and not
(40), and 1, 5 and 17 rows over T = 9 steps.  Inputs are numpy arrays from a
seeded generator.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicesplit_tpu.ops import lstm_pallas
from voicesplit_tpu_torch.ops import lstm_cuda

REPO = pathlib.Path(__file__).resolve().parents[1]


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# both import the standard library, numpy and the port's peaks at their top
chip_smoke = _module("chip_smoke", REPO / "chip_smoke.py")
times = _module("port_lstm_times", REPO / "scripts" / "port_lstm_times.py")

# fp32 on both sides: the order of summation differs, nothing else (the
# tolerance of tests/test_torch_lstm.py)
ATOL = 1e-5

T = 9
ROWS = [1, 5, 17]
HIDDEN = [64, 40]


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


def _close(got, want, name, atol=ATOL):
    want = np.array(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, err_msg=name)


def _shifted(first, seq):
    """[first, seq[0], ..., seq[T-2]]: the previous step's state, as the
    JAX wrapper feeds `_bwd`."""
    return jnp.concatenate([first[None], seq[:-1]])


@pytest.mark.parametrize("H", HIDDEN)
@pytest.mark.parametrize("B", ROWS)
def test_lstm_fwd_ref_matches_pallas_fwd_from_a_carry(B, H):
    rng = np.random.default_rng(700 + 7 * B + H)
    xp, w = _arr(rng, (T, B, 4 * H)), _arr(rng, (H, 4 * H), 0.3)
    h0, c0 = _arr(rng, (B, H)), _arr(rng, (B, H))
    want = lstm_pallas._fwd(*map(jnp.asarray, (xp, w, h0, c0)))
    got = lstm_cuda.lstm_fwd_ref(*map(torch.from_numpy, (xp, w, h0, c0)))
    for name, a, b in zip(("hs", "cs", "gates"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("H", HIDDEN)
@pytest.mark.parametrize("B", ROWS)
def test_lstm_bwd_ref_matches_pallas_bwd_with_final_cotangents(B, H):
    """dxp, dW_hh (the plain walk's `lstm_dwhh_ref`), dh0 and dc0 from
    nonzero dhf / dcf, and dW_hh once more from `lstm_dwhh_ref` alone on
    the Pallas kernel's dxp, as the card runs the dW_hh kernel alone."""
    rng = np.random.default_rng(800 + 7 * B + H)
    xp, w = _arr(rng, (T, B, 4 * H)), _arr(rng, (H, 4 * H), 0.3)
    h0, c0, dhf, dcf = (_arr(rng, (B, H)) for _ in range(4))
    dhs = _arr(rng, (T, B, H))
    hs, cs, gates = lstm_pallas._fwd(*map(jnp.asarray, (xp, w, h0, c0)))
    want = lstm_pallas._bwd(
        jnp.asarray(w), gates, _shifted(jnp.asarray(c0), cs), _shifted(jnp.asarray(h0), hs),
        jnp.asarray(dhs), jnp.asarray(dhf), jnp.asarray(dcf), dxp_dtype=jnp.float32,
    )
    t32 = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))  # noqa: E731
    got = lstm_cuda.lstm_bwd_ref(
        torch.from_numpy(w), t32(gates), t32(cs), t32(hs),
        *map(torch.from_numpy, (h0, c0, dhs, dhf, dcf)), torch.float32,
    )
    for name, a, b in zip(("dxp", "dwhh", "dh0", "dc0"), got, want):
        _close(a, b, name, ATOL * max(1.0, float(np.abs(np.array(b)).max())))
    (alone,) = lstm_cuda.lstm_dwhh_ref(t32(hs), torch.from_numpy(h0), t32(want[0]), 1, torch.float32)
    _close(alone, want[1], "dwhh alone", ATOL * max(1.0, float(np.abs(np.array(want[1])).max())))


def test_timing_script_times_the_encoder_shapes():
    """`scripts/port_lstm_times.py` times `lstm_fwd` at the GE2E encoder's
    training, extraction and held-out EER rows and `lstm_bwd` at its
    training rows (T=80, H=768, fp32 only), as `chip_smoke.py` runs them."""
    from voicesplit_tpu_torch.cli.train_encoder import eval_rows

    T_, R, H, _ = chip_smoke.ENCODER_SHAPES["ge2e_train"]
    want_fwd = {(1, R, H, T_), (1, chip_smoke.ENCODER_SHAPES["ge2e_extract"][1], H, T_),
                (1, eval_rows(chip_smoke.ENCODER_HOLDOUT), H, T_)}
    got_fwd = {v for k, v in times.FORWARD.items() if k.startswith("encoder")}
    got_bwd = {v for k, v in times.BACKWARD.items() if k.startswith("encoder")}
    assert got_fwd == want_fwd and got_bwd == {(1, R, H, T_)}
    for key in (*times.FORWARD, *times.BACKWARD):
        want = ("float32",) if key.startswith("encoder") else ("bfloat16", "float32")
        assert times._dtypes(key) == want
    assert set(times._entries(["encoder"])) == {k for k in (*times.FORWARD, *times.BACKWARD)
                                                if k.startswith("encoder")}
    assert times.DWHH_LIBRARY["encoder_lstm_bwd_R96"] == "float32"


@pytest.mark.parametrize("key", ["encoder_lstm_fwd_R96", "encoder_lstm_fwd_R32", "encoder_lstm_fwd_R16",
                                 "encoder_lstm_bwd_R96", "encoder_lstm_bwd_R96/dwhh"])
def test_timing_script_bounds_are_the_smokes(key):
    """Each encoder entry's bound is `chip_smoke.py`'s at its shape: the
    products at fp32's 67 TFLOP/s bound them (2 T R H 4H operations, twice
    in the backward)."""
    name, _, part = key.partition("/")
    d, b, H, T_ = {**times.FORWARD, **times.BACKWARD}[name]
    if part == "dwhh":
        want = chip_smoke.lstm_dwhh_bound(d, b, "float32", H, T_)
    elif name in times.FORWARD:
        want = chip_smoke.lstm_bound(d, b, "float32", H, T_)
    else:
        want = chip_smoke.lstm_bwd_bound(d, b, "float32", H, T_)
    got = times.bound(key, "float32")
    assert got == want and got["bound_by"] == "operations"
    products = 2 if name in times.BACKWARD and not part else 1
    assert got["flops"] == products * 2 * T_ * d * b * H * 4 * H
    assert got["bound_ms"] == pytest.approx(got["flops"] / 67e12 * 1e3)
