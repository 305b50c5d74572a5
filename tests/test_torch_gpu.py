"""Device policy of the port, and its CUDA kernels on the card.

The first tests run everywhere: an entry point asked for no device runs on
the CUDA card, and without one it raises instead of quietly using the CPU.
Tests marked ``gpu`` need an NVIDIA card (and nvcc); they skip inside the
test when there is none, so every worker collects the same tests.  On the
card: ``python -m pytest tests/test_torch_gpu.py -m gpu``.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from voicesplit_tpu_torch.cli import train_encoder
from voicesplit_tpu_torch.config import load_config
from voicesplit_tpu_torch.device import resolve_device
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import make_masknet

REPO = pathlib.Path(__file__).resolve().parents[1]
# conv2 … conv7 of the model, each layer kind once
CONV_LAYERS = {"7x1": ((7, 1), 1), "5x5-d1": ((5, 5), 1), "5x5-d2": ((5, 5), 2),
               "5x5-d4": ((5, 5), 4), "5x5-d8": ((5, 5), 8), "5x5-d16": ((5, 5), 16)}


_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)  # imports the standard library, numpy and the port's peaks at its top


def _config():
    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    cfg.model.lstm_dim, cfg.model.fc1_dim = 8, 12  # keep the CPU-side build small
    return cfg


ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(),
    "make_audio_processor": lambda: make_audio_processor(_config()).device,
    "make_masknet": lambda: next(make_masknet(_config()).parameters()).device,
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_is_the_card_never_a_silent_cpu(entry):
    if torch.cuda.is_available():
        assert ENTRY_POINTS[entry]().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[entry]()


def test_resolving_a_device_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_kernels_match_plain_versions_on_card(dtype, bidirectional):
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    g = torch.Generator().manual_seed(0)
    T, H, B = 301, 400, 8 if bidirectional else 1
    R = 2 * B if bidirectional else B
    dt = getattr(torch, dtype)
    xp = torch.randn(T, R, 4 * H, generator=g).to("cuda", dt)
    ws = [(torch.rand(H, 4 * H, generator=g) * 0.1 - 0.05).to("cuda", dt) for _ in range(2)]
    if bidirectional:
        args, kernel, plain = (xp, *ws), lstm_cuda.bilstm_fwd, lstm_cuda.bilstm_fwd_ref
    else:
        h0, c0 = (torch.randn(R, H, generator=g).cuda() for _ in range(2))
        args, kernel, plain = (xp, ws[0], h0, c0), lstm_cuda.lstm_fwd, lstm_cuda.lstm_fwd_ref
    before = dict(lstm_cuda.LAUNCHES)
    with torch.inference_mode():
        got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    name = "bilstm_fwd" if bidirectional else "lstm_fwd"
    assert lstm_cuda.LAUNCHES[name] == before[name] + 1
    # fp32: summation order only; bf16: one flipped rounding of h may carry
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
def test_separate_runs_through_the_kernels_on_card(batch):
    _need_card()
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.ops import lstm_cuda

    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed=0)
    rng = np.random.default_rng(0)
    mixed = (0.1 * rng.standard_normal((batch, 48000))).astype(np.float32)
    emb = rng.standard_normal((batch, 256)).astype(np.float32)
    lstm_cuda.reset_launch_counts()
    out = separate_batch(model, ap, mixed, emb)
    torch.cuda.synchronize()
    assert out.shape == (batch, 48000) and bool(torch.isfinite(out).all())
    want = {"lstm_fwd": 0, "bilstm_fwd": 1} if batch % 8 == 0 else {"lstm_fwd": 2, "bilstm_fwd": 0}
    assert lstm_cuda.LAUNCHES == {**want, "lstm_bwd": 0, "bilstm_bwd": 0}  # serving: no backward


def _backward_inputs(bidirectional, dtype, T=301, H=400, B=None, seed=0):
    """Forward outputs of the plain version on the card, and random
    cotangents, by default at the training path's shapes (B=2 one
    direction, B=8 two)."""
    from voicesplit_tpu_torch.ops import lstm_cuda

    g = torch.Generator().manual_seed(seed)
    if B is None:
        B = 8 if bidirectional else 2
    R = 2 * B if bidirectional else B
    dt = getattr(torch, dtype)
    xp = torch.randn(T, R, 4 * H, generator=g).to("cuda", dt)
    ws = [(torch.rand(H, 4 * H, generator=g) * 0.1 - 0.05).to("cuda", dt) for _ in range(2)]
    dhs = torch.randn(T, R, H, generator=g).cuda()
    if bidirectional:
        hs, cs, gates = lstm_cuda.bilstm_fwd_ref(xp, ws[0], ws[1])
        return (ws[0], ws[1], gates, cs, hs, dhs, dt)
    h0, c0, dhf, dcf = (torch.randn(R, H, generator=g).cuda() for _ in range(4))
    hs, cs, gates = lstm_cuda.lstm_fwd_ref(xp, ws[0], h0, c0)
    return (ws[0], gates, cs, hs, h0, c0, dhs, dhf, dcf, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_backward_kernels_match_plain_versions_on_card(dtype, bidirectional):
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    args = _backward_inputs(bidirectional, dtype)
    name = "bilstm_bwd" if bidirectional else "lstm_bwd"
    kernel = getattr(lstm_cuda, name)
    plain = getattr(lstm_cuda, name + "_ref")
    before = dict(lstm_cuda.LAUNCHES)
    with torch.inference_mode():
        got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES[name] == before[name] + 1
    # relative to the largest magnitude of each output: fp32 differs by
    # summation order only; in bf16 one rounding of dgates that falls the
    # other way carries back through the reverse walk
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_dwhh_kernel_matches_plain_version_on_card(dtype, bidirectional):
    """The dW_hh kernel alone at the training path's shapes (B=2 one
    direction from (h0, c0), B=8 two from the zero state): both sides
    multiply the same rounded operands and accumulate in fp32, so only the
    order of the sum over T * B rows (up to 2,408) differs, in either
    operand type: 1e-4 of the peak, as the fp32 backward's."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    args = _backward_inputs(bidirectional, dtype)
    dt = getattr(torch, dtype)
    if bidirectional:
        hs, h0, directions = args[4], None, 2
    else:
        hs, h0, directions = args[3], args[4], 1
    g = torch.Generator().manual_seed(1)
    dg = torch.randn(*hs.shape[:2], 4 * hs.shape[2], generator=g).to("cuda", dt)
    before = dict(lstm_cuda.LAUNCHES)
    got = lstm_cuda.lstm_dwhh(hs, h0, dg, directions, dt)
    want = lstm_cuda.lstm_dwhh_ref(hs, h0, dg, directions, dt)
    again = lstm_cuda.lstm_dwhh(hs, h0, dg, directions, dt)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == before  # counted by the backward call that launches it
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_backward_takes_the_grid_route_where_the_walk_does_not_fit_on_card(bidirectional, dtype):
    """At H=800 (configs/voicesplit_wide.json) a block's W_hh columns exceed
    what the cluster walk holds (bf16: registers, fp32: shared memory): the
    backward takes, chosen from the shape before the launch, the split walk
    in bf16 (two clusters a direction and row group, every cluster resident
    at once) and the grid route in fp32 (all its blocks resident), at the
    wide path's batches (B=2 one direction, B=8 two, T=301); it matches its
    plain version (the path's tolerances) with the same bits twice, and each
    launch is counted by route."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    D, B, H = (2, 8, 800) if bidirectional else (1, 2, 800)
    dt = getattr(torch, dtype)
    cfg = lstm_cuda.launch_config(D, B, H, dt, backward=True)
    if dtype == "bfloat16":
        route = "split"
        assert cfg["route"] == route and cfg["cluster"] == 16 and cfg["blocks"] == 32 * D, cfg
        assert cfg["max_active_clusters"] >= 2 * D and cfg["local_bytes"] == 0, cfg
    else:
        route = "grid"
        assert cfg["route"] == route and cfg["cluster"] == 0, cfg
        assert cfg["resident_blocks"] >= cfg["blocks"] and cfg["local_bytes"] == 0, cfg
        # W_hh's rows sit in shared memory, two directions too (the staged
        # chunks of dgates leave them room)
        assert cfg["w_shared"], cfg
    assert lstm_cuda.launch_config(D, B, 400, dt, backward=True)["route"] == "cluster"
    args = _backward_inputs(bidirectional, dtype, T=301, H=H, B=B, seed=H + B)
    name = "bilstm_bwd" if bidirectional else "lstm_bwd"
    kernel, plain = getattr(lstm_cuda, name), getattr(lstm_cuda, name + "_ref")
    before, routes = dict(lstm_cuda.LAUNCHES), dict(lstm_cuda.ROUTES_BWD)
    with torch.inference_mode():
        got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES[name] == before[name] + 2
    assert lstm_cuda.ROUTES_BWD == {k: v + (2 if k == route else 0) for k, v in routes.items()}
    tol = 1e-4 if dtype == "float32" else 2e-2  # as at the path's shapes
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()


# the backward split walk's shapes at H=800, bf16: (T, rows a direction,
# directions): the paths' (training 2, two directions at 8), odd rows (3;
# 9 in one direction: two row groups, two pairs), one step and two
BWD_SPLIT_SHAPES = [(301, 2, 1), (301, 8, 2), (41, 3, 1), (41, 3, 2), (41, 9, 1), (1, 1, 1), (2, 2, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BWD_SPLIT_SHAPES, ids=lambda s: "T{}-B{}-D{}".format(*s))
def test_lstm_backward_split_walk_on_card(shape):
    """The backward's split walk at H=800 in bf16: the route reported before
    the launch (pairs of 16-block clusters, every cluster resident at once,
    no spill), agreement with the plain version within the path's
    tolerance, the same bits twice, each launch counted under "split", and
    dW_hh the bits of the dW_hh kernel alone on the call's dxp (the same
    kernel on every route)."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    T, B, D = shape
    bidirectional = D == 2
    cfg = lstm_cuda.launch_config(D, B, 800, torch.bfloat16, backward=True)
    assert cfg["route"] == "split" and cfg["units"] == 32 and cfg["local_bytes"] == 0, cfg
    assert cfg["blocks"] == 2 * D * cfg["groups"] * cfg["cluster"], cfg
    assert cfg["max_active_clusters"] >= 2 * D * cfg["groups"], cfg
    args = _backward_inputs(bidirectional, "bfloat16", T=T, H=800, B=B, seed=T + B)
    name = "bilstm_bwd" if bidirectional else "lstm_bwd"
    kernel, plain = getattr(lstm_cuda, name), getattr(lstm_cuda, name + "_ref")
    routes = dict(lstm_cuda.ROUTES_BWD)
    with torch.inference_mode():
        got, again, want = kernel(*args), kernel(*args), plain(*args)
        hs, h0 = (args[3], args[4]) if D == 1 else (args[4], None)
        alone = lstm_cuda.lstm_dwhh(hs, h0, got[0], D, torch.bfloat16)
    torch.cuda.synchronize()
    assert lstm_cuda.ROUTES_BWD["split"] == routes["split"] + 2
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * b.float().abs().max().item()
    for a, b in zip(alone, got[1:1 + D]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_backward_split_walk_not_started_where_its_clusters_are_not_all_resident_on_card():
    """Two directions of 9 rows at H=800 in bf16: the backward's pairs hold 8
    rows, so two row groups a direction, eight 16-block clusters, one more
    than an H100 holds at once: the grid route, decided from the shape before
    the launch, which launches and matches its plain version."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    cfg = lstm_cuda.launch_config(2, 9, 800, torch.bfloat16, backward=True)
    assert cfg["route"] == "grid" and cfg["resident_blocks"] >= cfg["blocks"], cfg
    assert lstm_cuda.launch_config(2, 8, 800, torch.bfloat16, backward=True)["max_active_clusters"] < 8
    args = _backward_inputs(True, "bfloat16", T=9, H=800, B=9, seed=9)
    routes = dict(lstm_cuda.ROUTES_BWD)
    with torch.inference_mode():
        got, want = lstm_cuda.bilstm_bwd(*args), lstm_cuda.bilstm_bwd_ref(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.ROUTES_BWD["grid"] == routes["grid"] + 1
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * b.float().abs().max().item()


# shapes the path does not take: units not a multiple of the blocks that
# share them (H = 40: some blocks own none), one and three rows, one step
ODD_SHAPES = [(1, 1, 40), (7, 1, 40), (7, 3, 40), (5, 3, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: "T{}-B{}-H{}".format(*s))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_backward_kernels_at_odd_shapes_on_card(bidirectional, dtype, shape):
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    T, B, H = shape
    args = _backward_inputs(bidirectional, dtype, T=T, H=H, B=B, seed=T + B)
    name = "bilstm_bwd" if bidirectional else "lstm_bwd"
    kernel, plain = getattr(lstm_cuda, name), getattr(lstm_cuda, name + "_ref")
    with torch.inference_mode():
        got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2  # as at the path's shapes
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()


def _forward_inputs(bidirectional, dtype, T, H, B, seed):
    from voicesplit_tpu_torch.ops import lstm_cuda

    g = torch.Generator().manual_seed(seed)
    R = 2 * B if bidirectional else B
    dt = getattr(torch, dtype)
    xp = torch.randn(T, R, 4 * H, generator=g).to("cuda", dt)
    ws = [(torch.rand(H, 4 * H, generator=g) * 0.1 - 0.05).to("cuda", dt) for _ in range(2)]
    if bidirectional:
        return (xp, *ws), lstm_cuda.bilstm_fwd, lstm_cuda.bilstm_fwd_ref
    h0, c0 = (torch.randn(R, H, generator=g).cuda() for _ in range(2))
    return (xp, ws[0], h0, c0), lstm_cuda.lstm_fwd, lstm_cuda.lstm_fwd_ref


def _forward_matches_twice(bidirectional, dtype, T, H, B, route):
    """The forward kernel against its plain version, twice on the same
    inputs (the same bits), through `route`; its tolerance as at the path's
    shapes (fp32: order of summation; bf16: one flipped rounding of h)."""
    from voicesplit_tpu_torch.ops import lstm_cuda

    args, kernel, plain = _forward_inputs(bidirectional, dtype, T, H, B, seed=T + B + H)
    routes = dict(lstm_cuda.ROUTES)
    with torch.inference_mode():
        got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.ROUTES[route] == routes[route] + 2
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a - b).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: "T{}-B{}-H{}".format(*s))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_forward_kernels_at_odd_shapes_on_card(bidirectional, dtype, shape):
    """The cluster walk where some blocks own no unit (H=40: 2 of 16), with
    one and three rows and one step."""
    _need_card()
    T, B, H = shape
    _forward_matches_twice(bidirectional, dtype, T, H, B, "cluster")


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_kernels_over_row_groups_on_card(bidirectional, dtype, batch):
    """More rows a direction than one cluster of the backward walk holds at
    H=400 (bf16 23, fp32 11): both walks split them over row groups, one
    cluster each (at 64 rows always more than one), and match their plain
    versions with the same bits twice."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    T, H = 41, 400
    D = 2 if bidirectional else 1
    dt = getattr(torch, dtype)
    for backward in (False, True):
        cfg = lstm_cuda.launch_config(D, batch, H, dt, backward=backward)
        assert cfg["groups"] == -(-batch // cfg["rows"]) and (batch < 64 or cfg["groups"] >= 2), cfg
        assert cfg["blocks"] == D * cfg["groups"] * cfg["cluster"], cfg
    _forward_matches_twice(bidirectional, dtype, T, H, batch, "cluster")
    args = _backward_inputs(bidirectional, dtype, T=T, H=H, B=batch, seed=batch)
    name = "bilstm_bwd" if bidirectional else "lstm_bwd"
    kernel, plain = getattr(lstm_cuda, name), getattr(lstm_cuda, name + "_ref")
    before = dict(lstm_cuda.LAUNCHES)
    with torch.inference_mode():
        got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES[name] == before[name] + 2
    tol = 1e-4 if dtype == "float32" else 2e-2  # as at the path's shapes
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_forward_takes_the_grid_route_where_the_walk_does_not_fit_on_card(bidirectional, dtype):
    """At H=800 a block's columns of W_hh do not fit the cluster walk (bf16
    320 KB): the route is chosen from the shape before the launch, the split
    walk (two clusters a direction and row group, every cluster resident at
    once) in bf16 and the grid route in fp32, and it launches and matches its
    plain version."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    D = 2 if bidirectional else 1
    dt = getattr(torch, dtype)
    cfg = lstm_cuda.launch_config(D, 1, 800, dt, backward=False)
    if dtype == "bfloat16":
        assert cfg["route"] == "split" and cfg["cluster"] == 16 and cfg["blocks"] == 32 * D, cfg
        assert cfg["max_active_clusters"] >= 2 * D and cfg["local_bytes"] == 0, cfg
    else:
        assert cfg["route"] == "grid" and cfg["cluster"] == 0, cfg
        assert cfg["resident_blocks"] >= cfg["blocks"], cfg
    assert lstm_cuda.launch_config(D, 1, 400, dt, backward=False)["route"] == "cluster"
    _forward_matches_twice(bidirectional, dtype, 31, 800, 1, cfg["route"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_direction_forward_at_wide_hidden_on_card(dtype):
    """`bilstm_fwd` at H=800 and B=8 (a wide model's batch that takes the
    two-direction kernel, as the evaluation sweep pads to): bf16 on the
    split walk (four clusters), fp32 on the grid route with 8 rows of h
    staged at a time (16 do not fit beside the columns), matching its plain
    version with the same bits twice."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    cfg = lstm_cuda.launch_config(2, 8, 800, getattr(torch, dtype), backward=False)
    if dtype == "bfloat16":
        assert cfg["route"] == "split" and cfg["max_active_clusters"] >= 4, cfg
    else:
        assert cfg["route"] == "grid" and cfg["resident_blocks"] >= cfg["blocks"], cfg
    _forward_matches_twice(True, dtype, 31, 800, 8, cfg["route"])


# the split walk's shapes: (T, rows a direction) at H=800, bf16: the paths'
# (serving 1, training 2, the sweep's 8), odd rows (3, and 9: one past an
# 8-row tile), 16 (two whole tiles), one step and two
SPLIT_SHAPES = [(301, 1), (301, 2), (41, 3), (301, 8), (41, 9), (41, 16), (1, 1), (2, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda s: "T{}-B{}".format(*s))
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_forward_split_walk_on_card(bidirectional, shape):
    """The forward's split walk at H=800 in bf16: the route reported before
    the launch (a pair of 16-block clusters a direction and row group, every
    cluster resident at once, no spill up to 8 rows, one 8-row tile),
    agreement with the plain version within the path's tolerance, the same
    bits twice and each launch counted under "split"."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    T, B = shape
    D = 2 if bidirectional else 1
    cfg = lstm_cuda.launch_config(D, B, 800, torch.bfloat16, backward=False)
    assert cfg["route"] == "split" and cfg["units"] == 32, cfg
    assert cfg["local_bytes"] == 0 or cfg["rows"] > 8, cfg
    assert cfg["blocks"] == 2 * D * cfg["groups"] * cfg["cluster"], cfg
    assert cfg["max_active_clusters"] >= 2 * D * cfg["groups"], cfg
    before = dict(lstm_cuda.LAUNCHES)
    _forward_matches_twice(bidirectional, "bfloat16", T, 800, B, "split")
    name = "bilstm_fwd" if bidirectional else "lstm_fwd"
    assert lstm_cuda.LAUNCHES[name] == before[name] + 2


@pytest.mark.gpu
def test_split_walk_not_started_where_its_clusters_are_not_all_resident_on_card():
    """Two directions of 24 rows at H=800 in bf16 need eight 16-block clusters
    (two row groups of 12, a pair each), one more than an H100 holds at once:
    the route is decided from the shape before the launch, and it is the grid
    route, which launches and matches its plain version."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    split = lstm_cuda.launch_config(2, 16, 800, torch.bfloat16, backward=False)
    assert split["route"] == "split" and split["max_active_clusters"] < 8, split
    cfg = lstm_cuda.launch_config(2, 24, 800, torch.bfloat16, backward=False)
    assert cfg["route"] == "grid" and cfg["resident_blocks"] >= cfg["blocks"], cfg
    _forward_matches_twice(True, "bfloat16", 9, 800, 24, "grid")


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [2, 8])
def test_train_step_runs_through_the_kernels_on_card(batch):
    """Full-width `configs/voicesplit.json` train step (bf16, si_snr, Adam):
    the LSTM's forward and backward kernels launch once per direction
    (B=2) or once for both (B=8), the loss is finite and every parameter
    and running statistic moves."""
    _need_card()
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.ops import lstm_cuda
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed=0)
    opt = make_optimizer(cfg, model)
    state = create_train_state(model, opt)
    rng = np.random.default_rng(0)
    target = (0.1 * rng.standard_normal((batch, 48000))).astype(np.float32)
    batch_ = {
        "mixed_wav": target + (0.1 * rng.standard_normal((batch, 48000))).astype(np.float32),
        "target_wav": target,
        "emb": rng.standard_normal((batch, 256)).astype(np.float32),
        "wav_len": np.full((batch,), 48000, np.int32),
    }
    before = {k: v.clone() for k, v in model.state_dict().items()}
    lstm_cuda.reset_launch_counts()
    m = make_train_step(cfg, model, ap, opt)(state, batch_)
    torch.cuda.synchronize()
    if batch % 8 == 0:
        want = {"lstm_fwd": 0, "bilstm_fwd": 1, "lstm_bwd": 0, "bilstm_bwd": 1}
    else:
        want = {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 2, "bilstm_bwd": 0}
    assert lstm_cuda.LAUNCHES == want
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for k, v in model.state_dict().items():
        assert not torch.equal(v, before[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", sorted(CONV_LAYERS))
def test_conv_chain_kernels_match_plain_versions_on_card(layer, dtype):
    """`conv_bn_act_fwd`, `conv_dgrad` and `conv_wgrad` against their plain
    versions at a small shape whose halo (F off the 128-wide tile; T = 13,
    odd and under the reach of dilations 4 to 16) is in play, mish prologue
    on."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_fused as cf

    (kt, kf), dil = CONV_LAYERS[layer]
    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    shape, C = (2, 13, 150, 64), 64
    x = torch.randn(shape, generator=g).to("cuda", dt)
    d = torch.randn(shape, generator=g).to("cuda", dt)
    w = (torch.randn(kt, kf, C, C, generator=g) * (kt * kf * C) ** -0.5).to("cuda", dt)
    bias = (0.1 * torch.randn(C, generator=g)).cuda()
    scal = cf._scal_table(
        0.2 * torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5,
        torch.rand(C, generator=g) + 0.5, 0.1 * torch.randn(C, generator=g),
    ).cuda()
    wf = cf.pack_weight_flipped(w, dt)
    before = dict(cf.LAUNCHES)
    with torch.inference_mode():
        got = (*cf.conv_bn_act_fwd(x, w, bias, scal, dil, "mish", True),
               *cf.conv_dgrad(d, wf, dil),
               cf.conv_wgrad(x, d, scal, kt, kf, dil, "mish", True))
        want = (*cf.conv_bn_act_fwd_ref(x, w, bias, scal, dil, "mish", True),
                *cf.conv_dgrad_ref(d, wf, dil),
                cf.conv_wgrad_ref(x, d, scal, kt, kf, dil, "mish", True))
    torch.cuda.synchronize()
    # the prologue pass runs before the forward and before the weight gradient
    assert cf.LAUNCHES == {**{k: v + 1 for k, v in before.items()},
                           "conv_wgrad_prologue": before["conv_wgrad_prologue"] + 2,
                           "conv_draw_prologue": before["conv_draw_prologue"]}
    # relative to each output's peak.  fp32: summation order only.  bf16:
    # raw and dx may round the other way once (one ulp is at most 2^-7 of
    # the peak); the sums and dW add exact products in another order
    tols = {"float32": [1e-4] * 5, "bfloat16": [1e-2, 1e-3, 1e-2, 1e-3, 1e-3]}[dtype]
    for a, b, tol in zip(got, want, tols):
        assert bool(torch.isfinite(a).all())
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [64, 128])
def test_draw_pass_and_prologue_branches_match_plain_versions_on_card(C, dtype):
    """The d_raw pass (`conv_draw_prologue`) and the BatchNorm-backward
    prologue branches it makes (the pass, then `conv_dgrad`; the pass, then
    `conv_wgrad` with its input prologue on too) at a (5,5) layer: bf16 at
    the full width ``[2, 301, 601, C]``, fp32 at `chip_smoke.py`'s reduced
    shape; each against its plain version (the plain pass, then the plain
    call) within `chip_smoke.CONV_TOL` (relative to each output's peak), the
    same bits twice, and one launch counted a pass."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_fused as cf

    (kt, kf), dil = CONV_LAYERS["5x5-d1"]
    dt = getattr(torch, dtype)
    shape = ((2, 301, 601) if dtype == "bfloat16" else chip_smoke.CONV_SHAPE_FP32[:3]) + (C,)
    tol = chip_smoke.CONV_TOL[dtype]
    g = torch.Generator(device="cuda").manual_seed(C)
    x_in, dy, raw = (torch.randn(shape, device="cuda", generator=g).to(dt) for _ in range(3))
    w = (torch.randn(kt, kf, C, C, device="cuda", generator=g) * (kt * kf * C) ** -0.5).to(dt)
    wf = cf.pack_weight_flipped(w, dt)

    def table(**sums):
        return cf._scal_table(0.2 * torch.randn(C, device="cuda", generator=g),
                              0.5 + torch.rand(C, device="cuda", generator=g),
                              0.5 + torch.rand(C, device="cuda", generator=g),
                              0.1 * torch.randn(C, device="cuda", generator=g), **sums)

    scal = table(mean_dz=0.1 * torch.randn(C, device="cuda", generator=g),
                 mean_dzx=0.1 * torch.randn(C, device="cuda", generator=g))
    scal_lhs = table()

    def branches(draw, dgrad, wgrad):
        d_mish, d_relu = draw(dy, raw, scal, "mish"), draw(dy, raw, scal, "relu")
        return (d_mish, *dgrad(d_mish, wf, dil), wgrad(x_in, d_relu, scal_lhs, kt, kf, dil, "mish", True))

    before = dict(cf.LAUNCHES)
    with torch.inference_mode():
        runs = [branches(cf.conv_draw_prologue, cf.conv_dgrad, cf.conv_wgrad) for _ in range(2)]
        torch.cuda.synchronize()
        assert cf.LAUNCHES["conv_draw_prologue"] == before["conv_draw_prologue"] + 4
        want = branches(cf.conv_draw_prologue_ref, cf.conv_dgrad_ref, cf.conv_wgrad_ref)
    for a, b, kind in zip(runs[0], want, ("out", "out", "sums", "dw")):
        assert bool(torch.isfinite(a).all())
        assert (a.float() - b.float()).abs().max().item() <= tol[kind] * b.float().abs().max().item(), kind
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", ["plain", "mish"])
@pytest.mark.parametrize("layer", sorted(CONV_LAYERS))
def test_chain_forward_kernel_matches_plain_version_on_card(layer, prologue, dtype):
    """`conv_bn_act_fwd` at the main path's shape (bf16, `chip_smoke.py`'s
    `CONV_SHAPE`) and at its reduced fp32 shape: raw and both statistics
    within `chip_smoke.CONV_TOL` of the plain version (relative to each
    output's peak), the same bits twice, one wave of blocks and no spilled
    byte."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_fused as cf

    (kt, kf), dil = CONV_LAYERS[layer]
    shape = chip_smoke.CONV_SHAPE if dtype == "bfloat16" else chip_smoke.CONV_SHAPE_FP32
    tol = chip_smoke.CONV_TOL[dtype]
    act, on = ("mish", True) if prologue == "mish" else (None, False)
    g = torch.Generator().manual_seed(3)
    dt = getattr(torch, dtype)
    C = shape[-1]
    x = torch.randn(shape, generator=g).to("cuda", dt)
    w = (torch.randn(kt, kf, C, C, generator=g) * (kt * kf * C) ** -0.5).to("cuda", dt)
    bias = (0.1 * torch.randn(C, generator=g)).cuda()
    scal = cf._scal_table(
        0.2 * torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5,
        torch.rand(C, generator=g) + 0.5, 0.1 * torch.randn(C, generator=g),
    ).cuda()
    grid = cf.launch_config(shape, kt, kf, dil, dt)
    assert grid["blocks"] <= grid["resident_blocks"] and grid["local_bytes"] == 0
    with torch.inference_mode():
        raw, stats = cf.conv_bn_act_fwd(x, w, bias, scal, dil, act, on)
        raw2, stats2 = cf.conv_bn_act_fwd(x, w, bias, scal, dil, act, on)
        want_raw, want_stats = cf.conv_bn_act_fwd_ref(x, w, bias, scal, dil, act, on)
    torch.cuda.synchronize()
    assert torch.equal(raw, raw2) and torch.equal(stats, stats2)
    assert raw.shape == tuple(shape) and bool(torch.isfinite(raw).all())
    for got, want, limit in ((raw, want_raw, tol["out"]), (stats[0], want_stats[0], tol["sums"]),
                             (stats[1], want_stats[1], tol["sums"])):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= limit * want.float().abs().max().item()


# Weight-gradient cases: (kt, kf), dilation, [B, T, F].  More items than
# resident blocks; T shorter than the dilated reach (T = 13 at dilation 16:
# only the centre tap is inside); F off the 128- and 64-wide tiles; for
# kf = 1 a dilation above 1 (several residues per column) and a column
# shorter than the tap window.
WGRAD_CASES = {
    "5x5-d1-more-items-than-blocks": (((5, 5), 1), (2, 40, 300)),
    "5x5-d16-T13": (((5, 5), 16), (2, 13, 150)),
    "3x3-d2-F130": (((3, 3), 2), (1, 9, 130)),
    "7x1-d1-more-items-than-blocks": (((7, 1), 1), (2, 40, 700)),
    "7x1-d3-F70": (((7, 1), 3), (1, 29, 70)),
    "7x1-d16-T13": (((7, 1), 16), (2, 13, 150)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(WGRAD_CASES))
def test_wgrad_kernels_match_plain_versions_on_card(case, dtype):
    """`conv_wgrad` (mish prologue) and `conv_dilated_wgrad` against their
    plain versions: one launch never has more blocks than the card holds at
    once, two launches give the same bits, and `conv_wgrad` gives the bits
    of `conv_dilated_wgrad` on its prologue pass's output."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda as cc
    from voicesplit_tpu_torch.ops import conv_fused as cf

    ((kt, kf), dil), (b, t, f) = WGRAD_CASES[case]
    g = torch.Generator().manual_seed(1)
    dt = getattr(torch, dtype)
    C = 64
    x = torch.randn(b, t, f, C, generator=g).to("cuda", dt)
    d = torch.randn(b, t, f, C, generator=g).to("cuda", dt)
    scal = cf._scal_table(
        0.2 * torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5,
        torch.rand(C, generator=g) + 0.5, 0.1 * torch.randn(C, generator=g),
    ).cuda()
    grid = cf.wgrad_launch_config(x.shape, kt, kf, dil, dt)
    assert grid["blocks"] <= grid["resident_blocks"]
    if "more-items" in case:
        assert grid["blocks"] == grid["resident_blocks"]
    with torch.inference_mode():
        got = cf.conv_wgrad(x, d, scal, kt, kf, dil, "mish", True)
        again = cf.conv_wgrad(x, d, scal, kt, kf, dil, "mish", True)
        y = cf.conv_wgrad_prologue(x, scal, "mish")
        split = cc.conv_dilated_wgrad(y, d, kt, kf, dil)
        want = cf.conv_wgrad_ref(x, d, scal, kt, kf, dil, "mish", True)
        plain_dw = cc.conv_dilated_wgrad(x, d, kt, kf, dil)
        plain_want = cc.conv_dilated_wgrad_ref(x, d, kt, kf, dil)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, split)
    # fp32 and bf16 alike: exact products (bf16 x bf16 fits fp32) summed in
    # another order; relative to each result's peak
    tol = 1e-4 if dtype == "float32" else 1e-3
    for a, w_ in ((got, want), (plain_dw, plain_want)):
        assert a.shape == (kt, kf, C, C) and bool(torch.isfinite(a).all())
        assert (a - w_).abs().max().item() <= tol * w_.abs().max().item()
    if case.endswith("T13"):  # only the centre tap is inside the tensor
        outside = [i for i in range(kt) if i != (kt - 1) // 2]
        assert not got[outside].any() and not plain_dw[outside].any()


# Forward / data-gradient kernel cases: (kt, kf), dilation, [B, T, F].  B = 1
# (serving); T not a multiple of an item's rows; F = 601 (an 89-position last
# tile); T under the dilation-16 reach (19 < 32) and over it with several
# residues; more items than resident blocks; kf = 3 and a dilated kf = 1.
FWD_CASES = {
    "5x5-d1-B1-F601": (((5, 5), 1), (1, 9, 601)),
    "7x1-d1-B1-F601": (((7, 1), 1), (1, 11, 601)),
    "5x5-d16-T19": (((5, 5), 16), (2, 19, 150)),
    "5x5-d16-T45-F130": (((5, 5), 16), (1, 45, 130)),
    "5x5-d1-more-items-than-blocks": (((5, 5), 1), (2, 41, 700)),
    "7x1-d1-more-items-than-blocks": (((7, 1), 1), (2, 41, 700)),
    "3x3-d2-F70": (((3, 3), 2), (2, 11, 70)),
    "7x1-d3-F37": (((7, 1), 3), (1, 29, 37)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_kernels_match_plain_versions_on_card(case, dtype):
    """`conv_dilated_fwd` and `conv_dgrad` (one kernel body) against their
    plain versions and the sum rounded once: one launch never has more blocks
    than the card holds at once, two launches give the same bits, and
    `conv_dgrad`'s dx is the bits of `conv_dilated_fwd` on the same
    operands."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda as cc
    from voicesplit_tpu_torch.ops import conv_fused as cf

    ((kt, kf), dil), (b, t, f) = FWD_CASES[case]
    g = torch.Generator().manual_seed(2)
    dt = getattr(torch, dtype)
    C = 64
    x = torch.randn(b, t, f, C, generator=g).to("cuda", dt)
    w = (torch.randn(kt, kf, C, C, generator=g) * (kt * kf * C) ** -0.5).to("cuda", dt)
    for dgrad in (False, True):
        grid = cf.fwd_launch_config(x.shape, kt, kf, dil, dt, dgrad)
        assert grid["blocks"] <= grid["resident_blocks"]
        if "more-items" in case:
            assert grid["blocks"] == grid["resident_blocks"]
    with torch.inference_mode():
        got, again = cc.conv_dilated_fwd(x, w, dil), cc.conv_dilated_fwd(x, w, dil)
        dx, dbias = cf.conv_dgrad(x, w, dil)
        dx2, dbias2 = cf.conv_dgrad(x, w, dil)
        plain = cc.conv_dilated_fwd_ref(x, w, dil)
        once = cc.conv_dilated_fwd_round_once_ref(x, w, dil)  # every tap in fp32, rounded once
        want_dx, want_dbias = cf.conv_dgrad_ref(x, w, dil)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(dx, dx2) and torch.equal(dbias, dbias2)
    assert torch.equal(dx, got)
    assert got.shape == (b, t, f, C) and bool(torch.isfinite(got).all())
    # relative to each output's peak.  fp32: summation order only.  bf16:
    # against the sum rounded once one flipped rounding (2^-7 of the peak at
    # most), against the plain version's per-frequency-tap rounding a few;
    # dbias adds the same values in another order
    tol = {"float32": (1e-4, 1e-4, 1e-4), "bfloat16": (1e-2, 2e-2, 1e-3)}[dtype]
    for a, want, limit in ((got, once, tol[0]), (got, plain, tol[1]), (dx, want_dx, tol[0]),
                           (dbias, want_dbias, tol[2])):
        assert (a.float() - want.float()).abs().max().item() <= limit * want.float().abs().max().item()
    # the first and last time rows and frequency columns on their own
    peak = once.float().abs().max().item()
    for cut in ((slice(None), slice(0, 2)), (slice(None), slice(-2, None)),
                (slice(None), slice(None), slice(0, 2)), (slice(None), slice(None), slice(-2, None))):
        assert (got[cut].float() - once[cut].float()).abs().max().item() <= tol[0] * peak


@pytest.mark.gpu
def test_fused_train_step_runs_through_the_conv_kernels_on_card(monkeypatch):
    """Full-width train step with `VOICESPLIT_FUSED_CHAIN=1` at the config's
    batch: six launches of each conv kernel beside the LSTM's."""
    _need_card()
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.ops import conv_fused, lstm_cuda
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "1")
    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed=0)
    opt = make_optimizer(cfg, model)
    state = create_train_state(model, opt)
    rng = np.random.default_rng(0)
    target = (0.1 * rng.standard_normal((2, 48000))).astype(np.float32)
    batch = {
        "mixed_wav": target + (0.1 * rng.standard_normal((2, 48000))).astype(np.float32),
        "target_wav": target,
        "emb": rng.standard_normal((2, 256)).astype(np.float32),
        "wav_len": np.full((2,), 48000, np.int32),
    }
    before = {k: v.clone() for k, v in model.state_dict().items()}
    lstm_cuda.reset_launch_counts()
    conv_fused.reset_launch_counts()
    m = make_train_step(cfg, model, ap, opt)(state, batch)
    torch.cuda.synchronize()
    assert conv_fused.LAUNCHES == {"conv_bn_act_fwd": 6, "conv_dgrad": 6, "conv_wgrad": 6,
                                   "conv_wgrad_prologue": 10, "conv_draw_prologue": 0}
    assert lstm_cuda.LAUNCHES == {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 2, "bilstm_bwd": 0}
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for k, v in model.state_dict().items():
        assert not torch.equal(v, before[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", sorted(CONV_LAYERS))
def test_dilated_conv_kernels_match_plain_versions_on_card(layer, dtype):
    """`conv_dilated_fwd` (as forward and, with flipped weights, as data
    gradient) and `conv_dilated_wgrad` against their plain versions at a
    small shape whose halo (F off the 128-wide tile; T = 13, odd and under
    the reach of dilations 4 to 16) is in play."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda as cc

    (kt, kf), dil = CONV_LAYERS[layer]
    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    shape, C = (2, 13, 150, 64), 64
    x = torch.randn(shape, generator=g).to("cuda", dt)
    d = torch.randn(shape, generator=g).to("cuda", dt)
    w = (torch.randn(kt, kf, C, C, generator=g) * (kt * kf * C) ** -0.5).to("cuda", dt)
    wf = cc.flip_weight(w)
    before = dict(cc.LAUNCHES)
    with torch.inference_mode():
        got = (cc.conv_dilated_fwd(x, w, dil), cc.conv_dilated_fwd(d, wf, dil),
               cc.conv_dilated_wgrad(x, d, kt, kf, dil))
        want = (cc.conv_dilated_fwd_ref(x, w, dil), cc.conv_dilated_fwd_ref(d, wf, dil),
                cc.conv_dilated_wgrad_ref(x, d, kt, kf, dil))
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"conv_dilated_fwd": before["conv_dilated_fwd"] + 2,
                           "conv_dilated_wgrad": before["conv_dilated_wgrad"] + 1}
    # relative to each output's peak.  fp32: summation order only.  bf16: the
    # plain version rounds each frequency tap's partial sum (the TPU kernel's
    # rounding), the kernel rounds once: a few bf16 ulps (2^-7 of the peak
    # each at most); dW adds exact products in another order
    tols = {"float32": [1e-4] * 3, "bfloat16": [2e-2, 2e-2, 1e-3]}[dtype]
    for a, b, tol in zip(got, want, tols):
        assert bool(torch.isfinite(a).all())
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()
    # fewer channels than the JAX package sends raise; more are taken
    # (`test_conv_kernels_at_other_channel_counts_on_card`)
    with pytest.raises(NotImplementedError, match="at least 64 channels"):
        cc.conv_dilated_fwd(torch.zeros(1, 4, 4, 32, device="cuda"),
                            torch.zeros(5, 5, 32, 32, device="cuda"), 1)
    assert cc.conv_dilated_fwd(torch.zeros(1, 4, 4, 128, device="cuda"),
                               torch.zeros(5, 5, 128, 128, device="cuda"), 1).shape == (1, 4, 4, 128)


# Other channel counts than 64 (Cin, Cout): what the JAX package sends its
# Pallas conv (64 or more, in and out apart) and its chain (multiples of 64).
# Shapes with the halo in play: T under the dilated reach, F off the tiles,
# B = 1; and more items than resident blocks.
CHANNEL_WIDTHS = {"96": (96, 96), "128": (128, 128), "192": (192, 192), "64-128": (64, 128),
                  "72-136": (72, 136), "256": (256, 256), "192-256": (192, 256), "320": (320, 320),
                  "128-64": (128, 64)}
CHANNEL_CASES = {
    "5x5-d16-T19": (((5, 5), 16), (2, 19, 150)),
    "7x1-d3-F37-B1": (((7, 1), 3), (1, 29, 37)),
    "3x3-d2-F70": (((3, 3), 2), (2, 11, 70)),
    "5x5-d1-more-items-than-blocks": (((5, 5), 1), (2, 41, 300)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CHANNEL_CASES))
@pytest.mark.parametrize("width", sorted(CHANNEL_WIDTHS))
def test_conv_kernels_at_other_channel_counts_on_card(width, case, dtype):
    """Every conv kernel at Cin, Cout other than 64 against its plain
    version: `conv_dilated_fwd` (forward and, flipped, data gradient) and
    `conv_dilated_wgrad`, and where the chain takes the width (Cin = Cout, a
    multiple of 64) `conv_bn_act_fwd`, `conv_dgrad` (dx the bits of
    `conv_dilated_fwd`) and `conv_wgrad` (the bits of `conv_dilated_wgrad`
    on its prologue pass's output); the same bits twice, one wave at most."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda as cc
    from voicesplit_tpu_torch.ops import conv_fused as cf

    cin, cout = CHANNEL_WIDTHS[width]
    ((kt, kf), dil), (b, t, f) = CHANNEL_CASES[case]
    g = torch.Generator().manual_seed(4)
    dt = getattr(torch, dtype)
    x = torch.randn(b, t, f, cin, generator=g).to("cuda", dt)
    d = torch.randn(b, t, f, cout, generator=g).to("cuda", dt)
    w = (torch.randn(kt, kf, cin, cout, generator=g) * (kt * kf * cin) ** -0.5).to("cuda", dt)
    for grid in (cf.fwd_launch_config(x.shape, kt, kf, dil, dt, False, cout),
                 cf.wgrad_launch_config(x.shape, kt, kf, dil, dt, cout)):
        assert grid["blocks"] <= grid["resident_blocks"]
    wf = cc.flip_weight(w)
    with torch.inference_mode():
        out, out2 = cc.conv_dilated_fwd(x, w, dil), cc.conv_dilated_fwd(x, w, dil)
        dx = cc.conv_dilated_fwd(d, wf, dil)
        dw, dw2 = cc.conv_dilated_wgrad(x, d, kt, kf, dil), cc.conv_dilated_wgrad(x, d, kt, kf, dil)
        want = (cc.conv_dilated_fwd_round_once_ref(x, w, dil),
                cc.conv_dilated_fwd_round_once_ref(d, wf, dil),
                cc.conv_dilated_wgrad_ref(x, d, kt, kf, dil))
    torch.cuda.synchronize()
    assert out.shape == (b, t, f, cout) and dx.shape == (b, t, f, cin) and dw.shape == (kt, kf, cin, cout)
    assert torch.equal(out, out2) and torch.equal(dw, dw2)
    # relative to each output's peak.  fp32: summation order only.  bf16:
    # against the sum rounded once one flipped rounding (2^-7 of the peak at
    # most); dW adds exact products in another order
    tol = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}[dtype]
    for a, ref, limit in ((out, want[0], tol[0]), (dx, want[1], tol[0]), (dw, want[2], tol[1])):
        assert bool(torch.isfinite(a).all())
        assert (a.float() - ref.float()).abs().max().item() <= limit * ref.float().abs().max().item()
    if cin != cout or cin % cf.CHANNEL_SLAB:
        return
    bias = (0.1 * torch.randn(cin, generator=g)).cuda()
    scal = cf._scal_table(
        0.2 * torch.randn(cin, generator=g), torch.rand(cin, generator=g) + 0.5,
        torch.rand(cin, generator=g) + 0.5, 0.1 * torch.randn(cin, generator=g),
    ).cuda()
    for grid in (cf.launch_config(x.shape, kt, kf, dil, dt),
                 cf.fwd_launch_config(x.shape, kt, kf, dil, dt, True)):
        assert grid["blocks"] <= grid["resident_blocks"]
    wfc = cf.pack_weight_flipped(w, dt)
    with torch.inference_mode():
        raw, stats = cf.conv_bn_act_fwd(x, w, bias, scal, dil, "mish", True)
        raw2, stats2 = cf.conv_bn_act_fwd(x, w, bias, scal, dil, "mish", True)
        dxc, dbias = cf.conv_dgrad(d, wfc, dil)
        dwc = cf.conv_wgrad(x, d, scal, kt, kf, dil, "mish", True)
        split = cc.conv_dilated_wgrad(cf.conv_wgrad_prologue(x, scal, "mish"), d, kt, kf, dil)
        want = (*cf.conv_bn_act_fwd_ref(x, w, bias, scal, dil, "mish", True),
                *cf.conv_dgrad_ref(d, wfc, dil), cf.conv_wgrad_ref(x, d, scal, kt, kf, dil, "mish", True))
    torch.cuda.synchronize()
    assert torch.equal(raw, raw2) and torch.equal(stats, stats2)
    assert torch.equal(dxc, dx) and torch.equal(dwc, split)
    # raw and dx may round the other way once; the sums and dW add exact
    # products (or rounded values) in another order
    tols = {"float32": [1e-4] * 5, "bfloat16": [1e-2, 1e-3, 1e-2, 1e-3, 1e-3]}[dtype]
    for a, ref, limit in zip((raw, stats, dxc, dbias, dwc), want, tols):
        assert bool(torch.isfinite(a).all())
        assert (a.float() - ref.float()).abs().max().item() <= limit * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_count_off_the_copies_width_is_padded_on_card(dtype):
    """100 channels (no multiple of 8, the 16-byte copies' width): the
    wrapper zero-pads to 104 around the launch, counted in
    `CHANNEL_PADS`, and the result is the plain version's."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda as cc

    (kt, kf), dil = (5, 5), 2
    g = torch.Generator().manual_seed(5)
    dt = getattr(torch, dtype)
    x = torch.randn(2, 13, 150, 100, generator=g).to("cuda", dt)
    d = torch.randn(2, 13, 150, 100, generator=g).to("cuda", dt)
    w = (torch.randn(kt, kf, 100, 100, generator=g) * (kt * kf * 100) ** -0.5).to("cuda", dt)
    cc.reset_launch_counts()
    with torch.inference_mode():
        out = cc.conv_dilated_fwd(x, w, dil)
        dw = cc.conv_dilated_wgrad(x, d, kt, kf, dil)
        want = (cc.conv_dilated_fwd_round_once_ref(x, w, dil), cc.conv_dilated_wgrad_ref(x, d, kt, kf, dil))
    torch.cuda.synchronize()
    assert cc.CHANNEL_PADS == cc.LAUNCHES == {"conv_dilated_fwd": 1, "conv_dilated_wgrad": 1}
    assert out.shape == (2, 13, 150, 100) and out.is_contiguous() and dw.shape == (kt, kf, 100, 100)
    tol = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}[dtype]
    for a, ref, limit in zip((out, dw), want, tol):
        assert (a.float() - ref.float()).abs().max().item() <= limit * ref.float().abs().max().item()


# SHA-256 over `scripts/port_conv_bits.py`'s hashes (json.dumps, sorted keys)
# of every conv kernel's outputs at 64 channels, as the port's tree before
# the kernels took other widths gave them on an H100 SXM (132 SMs)
CONV_BITS_AT_64 = "16391236b3ab307adb869c68f2ea945fa90fcee86dd83f11ba219887a168a33e"


@pytest.mark.gpu
def test_conv_kernels_keep_their_64_channel_bits_on_card():
    """At 64 channels in and out every conv kernel is its own compile-time
    instantiation and gives the bits it gave before the other widths came:
    the digest of `scripts/port_conv_bits.py`'s hashes against the stored
    one (on another card model the grids, and so the sums' order, differ)."""
    _need_card()
    import hashlib
    import json

    from voicesplit_tpu_torch.ops import conv_cuda as cc
    from voicesplit_tpu_torch.ops import conv_fused as cf

    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the stored bits are an H100 SXM's (132 SMs)")
    spec = importlib.util.spec_from_file_location("port_conv_bits", REPO / "scripts" / "port_conv_bits.py")
    bits = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bits)
    hashes = bits.conv_bits(torch, cc, cf)
    digest = hashlib.sha256(json.dumps(hashes, sort_keys=True).encode()).hexdigest()
    assert digest == CONV_BITS_AT_64, hashes


@pytest.mark.gpu
@pytest.mark.parametrize("kf", [1, 3, 5])
def test_wide_tile_table_is_the_c_planners_on_card(kf):
    """`conv_cuda.fwd_tile` and `wgrad_tile`, the Python table of the wide
    tiles (bf16 at other widths than 64), against the C planner's
    (`csrc/conv_wide.cuh`, read through `conv_fwd_wide_tile` and
    `conv_wgrad_wide_tile`) at every Cin, Cout multiple of 8 from 64 to 512
    and every mode the forward body is built for."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda as cc

    kt = {1: 7, 3: 7, 5: 5}[kf]
    widths = range(64, 513, 8)
    for cout in widths:
        for mode in ("plain", "dgrad", "chain"):
            if mode != "plain" and (cout % 64 or cout < 128):
                continue  # the chain's modes take C a multiple of 64 above 64
            lib = cc.wide_tile_of_library("fwd", 64, cout, kt, kf, mode)
            table = cc.fwd_tile(72, cout, kt, kf, torch.bfloat16, mode)
            assert all(table[k] == v for k, v in lib.items()), (cout, mode, lib, table)
        for cin in widths:
            if cin == cout == 64:
                continue
            lib = cc.wide_tile_of_library("wgrad", cin, cout, kt, kf)
            table = cc.wgrad_tile(cin, cout, kf, torch.bfloat16)
            assert all(table[k] == v for k, v in lib.items()), (cin, cout, lib, table)


# (layer, T just past its reach): a warpgroup's sub-steps alternate between
# products and none where its input or output row leaves [0, T)
EDGE_LAYERS = {"5x5-d16-T40": ((5, 5), 16, 40), "5x5-d32-T70": ((5, 5), 32, 70)}
EDGE_WIDTHS = {"128": (128, 128), "192": (192, 192), "320": (320, 320), "128-64": (128, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("layer", sorted(EDGE_LAYERS))
@pytest.mark.parametrize("width", sorted(EDGE_WIDTHS))
def test_wide_forward_body_at_the_edges_of_time_on_card(width, layer):
    """The wide forward body (bf16) where its warpgroups' sub-steps switch
    between products and none, B=1, 2048 positions (several items a block):
    50 launches of `conv_dilated_fwd` (and, where Cin = Cout, of
    `conv_bn_act_fwd` and `conv_dgrad`) on the same inputs give the first
    launch's bits, and that one agrees with the plain version.  The refills
    after a sub-step must wait for the previous one's products whether or
    not this warpgroup issued any."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda as cc
    from voicesplit_tpu_torch.ops import conv_fused as cf

    cin, cout = EDGE_WIDTHS[width]
    (kt, kf), dil, t = EDGE_LAYERS[layer]
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, t, 2048, cin, generator=g).to("cuda", torch.bfloat16)
    d = torch.randn(1, t, 2048, cout, generator=g).to("cuda", torch.bfloat16)
    w = (torch.randn(kt, kf, cin, cout, generator=g) * (kt * kf * cin) ** -0.5).to("cuda", torch.bfloat16)
    runs = [(lambda: (cc.conv_dilated_fwd(x, w, dil),),
             lambda: (cc.conv_dilated_fwd_round_once_ref(x, w, dil),), (1e-2,))]
    if cin == cout:
        bias = (0.1 * torch.randn(cin, generator=g)).cuda()
        scal = cf._scal_table(torch.zeros(cin), torch.ones(cin), torch.ones(cin), torch.zeros(cin)).cuda()
        wf = cf.pack_weight_flipped(w, torch.bfloat16)
        runs.append((lambda: cf.conv_bn_act_fwd(x, w, bias, scal, dil, None, False),
                     lambda: cf.conv_bn_act_fwd_ref(x, w, bias, scal, dil, None, False), (1e-2, 1e-3)))
        runs.append((lambda: cf.conv_dgrad(d, wf, dil), lambda: cf.conv_dgrad_ref(d, wf, dil), (1e-2, 1e-3)))
    for kernel, plain, tols in runs:
        with torch.inference_mode():
            first = kernel()
            differ = sum(not all(torch.equal(a, b) for a, b in zip(first, kernel())) for _ in range(49))
            want = plain()
        torch.cuda.synchronize()
        assert differ == 0, f"{differ} of 49 launches differ from the first"
        for a, ref, limit in zip(first, want, tols):
            assert bool(torch.isfinite(a).all())
            assert (a.float() - ref.float()).abs().max().item() <= limit * ref.float().abs().max().item()


@pytest.mark.gpu
def test_no_wide_tile_instantiation_spills_on_card():
    """Every instantiation of the wide-tile kernels in the built library
    (`conv_cuda.wide_kernel_attributes`: the forward body plain at n 64-256,
    its dgrad and chain modes at 128-256, the weight gradient at 64-128,
    each at kf 1, 3 and 5) uses no local memory: nothing spills."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda as cc

    attrs = cc.wide_kernel_attributes()
    assert len(attrs) == 42, sorted(attrs)
    assert all(a["local_bytes"] == 0 and 0 < a["registers"] <= 255 for a in attrs.values()), attrs


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["serve", "train"])
def test_dilated_conv_switch_runs_through_the_kernels_on_card(mode, monkeypatch):
    """Full-width model with `VOICESPLIT_PALLAS_CONV=1`: six forward launches
    per serving call; twelve and six weight-gradient launches per train step
    at the config's batch, beside the LSTM's."""
    _need_card()
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1")
    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed=0)
    rng = np.random.default_rng(0)
    target = (0.1 * rng.standard_normal((2, 48000))).astype(np.float32)
    mixed = target + (0.1 * rng.standard_normal((2, 48000))).astype(np.float32)
    emb = rng.standard_normal((2, 256)).astype(np.float32)
    lstm_cuda.reset_launch_counts()
    conv_cuda.reset_launch_counts()
    if mode == "serve":
        out = separate_batch(model, ap, mixed, emb)
        torch.cuda.synchronize()
        assert out.shape == (2, 48000) and bool(torch.isfinite(out).all())
        assert conv_cuda.LAUNCHES == {"conv_dilated_fwd": 6, "conv_dilated_wgrad": 0}
        return
    opt = make_optimizer(cfg, model)
    state = create_train_state(model, opt)
    batch = {"mixed_wav": mixed, "target_wav": target, "emb": emb,
             "wav_len": np.full((2,), 48000, np.int32)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = make_train_step(cfg, model, ap, opt)(state, batch)
    torch.cuda.synchronize()
    assert conv_cuda.LAUNCHES == {"conv_dilated_fwd": 12, "conv_dilated_wgrad": 6}
    assert lstm_cuda.LAUNCHES == {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 2, "bilstm_bwd": 0}
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for k, v in model.state_dict().items():
        assert not torch.equal(v, before[k]), k


@pytest.mark.gpu
def test_spans_hold_the_calls_launches_on_card(monkeypatch, tmp_path):
    """A B=1 call with `VOICESPLIT_PALLAS_CONV=1` under the profiler: every
    kernel it launched starts after its top span starts, and the launch calls
    inside that span number at least the port's own counters' increase (6
    `conv_dilated_fwd` + 2 `lstm_fwd`), so the profiler sees the kernels
    launched through ctypes."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda

    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1")
    cfg = load_config(str(REPO / "configs" / "voicefilter.json"))
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed=0)
    rng = np.random.default_rng(0)
    mixed = (0.1 * rng.standard_normal((1, 48000))).astype(np.float32)
    emb = rng.standard_normal((1, 256)).astype(np.float32)
    separate_batch(model, ap, mixed, emb)  # the build and the DSP's bases
    torch.cuda.synchronize()

    def counted():
        return sum(conv_cuda.LAUNCHES.values()) + sum(lstm_cuda.LAUNCHES.values())

    before = counted()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        separate_batch(model, ap, mixed, emb)
        torch.cuda.synchronize()
    grew = counted() - before
    assert grew == 8
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (top,) = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == "voicesplit.separate_batch"]
    start, end = top["ts"], top["ts"] + top["dur"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels and all(e["ts"] >= start for e in kernels)
    launches = [e["name"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e["name"] and start <= e["ts"] <= end]
    assert len(launches) >= grew, sorted(set(launches))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [20, 50, 301])
def test_conv_kernels_at_time_dilation_32_on_card(T, dtype):
    """The five conv kernels (`conv_dilated_fwd` as forward and as data
    gradient, `conv_dilated_wgrad`, `conv_bn_act_fwd` with the mish
    prologue, `conv_dgrad`, `conv_wgrad`) at the wide config's extra block,
    (5,5) at time dilation 32, against their plain versions with the
    tolerances above.  T = 20: every tap but the centre lies outside
    [0, T); T = 50: the ±32 taps reach real rows, the ±64 taps do not;
    T = 301: the path's frames, each residue of 32 holding 9-10 rows."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda as cc
    from voicesplit_tpu_torch.ops import conv_fused as cf

    (kt, kf), dil, C = (5, 5), 32, 64
    g = torch.Generator().manual_seed(T)
    dt = getattr(torch, dtype)
    shape = (2, T, 601 if T == 301 else 150, C)
    x = torch.randn(shape, generator=g).to("cuda", dt)
    d = torch.randn(shape, generator=g).to("cuda", dt)
    w = (torch.randn(kt, kf, C, C, generator=g) * (kt * kf * C) ** -0.5).to("cuda", dt)
    bias = (0.1 * torch.randn(C, generator=g)).cuda()
    scal = cf._scal_table(
        0.2 * torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5,
        torch.rand(C, generator=g) + 0.5, 0.1 * torch.randn(C, generator=g),
    ).cuda()
    wf, wfc = cc.flip_weight(w), cf.pack_weight_flipped(w, dt)
    with torch.inference_mode():
        calls = {
            "conv_dilated_fwd": (lambda: (cc.conv_dilated_fwd(x, w, dil), cc.conv_dilated_fwd(d, wf, dil)),
                                 lambda: (cc.conv_dilated_fwd_ref(x, w, dil), cc.conv_dilated_fwd_ref(d, wf, dil)),
                                 {"float32": [1e-4] * 2, "bfloat16": [2e-2] * 2}),
            "conv_dilated_wgrad": (lambda: (cc.conv_dilated_wgrad(x, d, kt, kf, dil),),
                                   lambda: (cc.conv_dilated_wgrad_ref(x, d, kt, kf, dil),),
                                   {"float32": [1e-4], "bfloat16": [1e-3]}),
            "conv_bn_act_fwd": (lambda: cf.conv_bn_act_fwd(x, w, bias, scal, dil, "mish", True),
                                lambda: cf.conv_bn_act_fwd_ref(x, w, bias, scal, dil, "mish", True),
                                {"float32": [1e-4] * 2, "bfloat16": [1e-2, 1e-3]}),
            "conv_dgrad": (lambda: cf.conv_dgrad(d, wfc, dil), lambda: cf.conv_dgrad_ref(d, wfc, dil),
                           {"float32": [1e-4] * 2, "bfloat16": [1e-2, 1e-3]}),
            "conv_wgrad": (lambda: (cf.conv_wgrad(x, d, scal, kt, kf, dil, "mish", True),),
                           lambda: (cf.conv_wgrad_ref(x, d, scal, kt, kf, dil, "mish", True),),
                           {"float32": [1e-4], "bfloat16": [1e-3]}),
        }
        for name, (kernel, plain, tols) in calls.items():
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            for a, c, b, tol in zip(got, again, want, tols[dtype]):
                assert bool(torch.isfinite(a).all()) and torch.equal(a, c), name
                err = (a.float() - b.float()).abs().max().item()
                assert err <= tol * b.float().abs().max().item(), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["unfused", "pallas_conv", "fused_chain"])
def test_wide_train_step_runs_through_the_kernels_on_card(route, monkeypatch):
    """Full-width `configs/voicesplit_wide.json` train step at its batch
    (B=2) on each conv route: the LSTM's forward and backward on their
    split walks (H=800), the extra block's conv (dilation 32) on the kernel
    routes (seven kernel layers), a finite loss and every parameter and
    running statistic moved."""
    _need_card()
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.ops import conv_cuda, conv_fused, lstm_cuda
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1" if route == "pallas_conv" else "0")
    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "1" if route == "fused_chain" else "0")
    cfg = load_config(str(REPO / "configs" / "voicesplit_wide.json"))
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed=0)
    opt = make_optimizer(cfg, model)
    state = create_train_state(model, opt)
    rng = np.random.default_rng(0)
    target = (0.1 * rng.standard_normal((2, 48000))).astype(np.float32)
    batch = {"mixed_wav": target + (0.1 * rng.standard_normal((2, 48000))).astype(np.float32),
             "target_wav": target, "emb": rng.standard_normal((2, 256)).astype(np.float32),
             "wav_len": np.full((2,), 48000, np.int32)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for m in (lstm_cuda, conv_cuda, conv_fused):
        m.reset_launch_counts()
    m = make_train_step(cfg, model, ap, opt)(state, batch)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 2, "bilstm_bwd": 0}
    assert lstm_cuda.ROUTES == {"cluster": 0, "split": 2, "grid": 0} == lstm_cuda.ROUTES_BWD
    dilated = {"conv_dilated_fwd": 14, "conv_dilated_wgrad": 7}
    chain = {"conv_bn_act_fwd": 7, "conv_dgrad": 7, "conv_wgrad": 7, "conv_wgrad_prologue": 12,
             "conv_draw_prologue": 0}
    assert conv_cuda.LAUNCHES == (dilated if route == "pallas_conv" else dict.fromkeys(dilated, 0))
    assert conv_fused.LAUNCHES == (chain if route == "fused_chain" else dict.fromkeys(chain, 0))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for k, v in model.state_dict().items():
        assert not torch.equal(v, before[k]), k


@pytest.mark.gpu
def test_wide_separate_runs_through_the_grid_route_on_card():
    """`configs/voicesplit_wide.json` served at B=1: both directions through
    the forward's split walk (the grid route before it), 48000 finite
    samples, the mask within the wide serving tolerance of the plain LSTM
    versions'."""
    _need_card()
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.ops import lstm_cuda

    cfg = load_config(str(REPO / "configs" / "voicesplit_wide.json"))
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed=0)
    rng = np.random.default_rng(1)
    mixed = (0.1 * rng.standard_normal((1, 48000))).astype(np.float32)
    emb = rng.standard_normal((1, 256)).astype(np.float32)
    lstm_cuda.reset_launch_counts()
    out = separate_batch(model, ap, mixed, emb)
    torch.cuda.synchronize()
    assert out.shape == (1, 48000) and bool(torch.isfinite(out).all())
    assert lstm_cuda.LAUNCHES == {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 0, "bilstm_bwd": 0}
    assert lstm_cuda.ROUTES == {"cluster": 0, "split": 2, "grid": 0}
    with torch.inference_mode():
        spec, _ = ap.wav2spec_batch(torch.as_tensor(mixed, device="cuda"))
        e = torch.as_tensor(emb, device="cuda")
        mask = model(spec, e)
        saved = lstm_cuda._launch_lstm_fwd
        lstm_cuda._launch_lstm_fwd = lstm_cuda.lstm_fwd_ref
        try:
            mask_plain = model(spec, e)
        finally:
            lstm_cuda._launch_lstm_fwd = saved
    assert (mask - mask_plain).abs().max().item() <= chip_smoke.WIDE_SEPARATE_TOL


class _RaisingPlainVersions:
    """Makes the LSTM's plain versions raise while active: a card run that
    reaches one fails."""

    NAMES = ("lstm_fwd_ref", "bilstm_fwd_ref", "lstm_bwd_ref", "bilstm_bwd_ref")

    def __enter__(self):
        from voicesplit_tpu_torch.ops import lstm_cuda

        self.saved = {n: getattr(lstm_cuda, n) for n in self.NAMES}

        def refuse(*args, **kwargs):
            raise AssertionError("a plain LSTM version ran on the card's path")

        for n in self.NAMES:
            setattr(lstm_cuda, n, refuse)

    def __exit__(self, *exc):
        from voicesplit_tpu_torch.ops import lstm_cuda

        for n, fn in self.saved.items():
            setattr(lstm_cuda, n, fn)


def _card_batch(batch, seed=0, n=48000):
    rng = np.random.default_rng(seed)
    target = (0.1 * rng.standard_normal((batch, n))).astype(np.float32)
    return {"mixed_wav": target + (0.1 * rng.standard_normal((batch, n))).astype(np.float32),
            "target_wav": target, "emb": rng.standard_normal((batch, 256)).astype(np.float32),
            "wav_len": np.full((batch,), n, np.int32)}


@pytest.mark.gpu
def test_regularized_train_step_on_card():
    """Full-width train step (bf16, B=2) with dropout 0.3 and SpecAugment
    (24 frames, 40 bins): the LSTM kernels launch as without them and no
    plain version runs; the step's draws (both dropout masks, the bands)
    are the same bits twice at one step and other bits at the next; the
    keep share is within 0.01 of 0.7; the loss is finite."""
    _need_card()
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.dsp import augment
    from voicesplit_tpu_torch.ops import lstm_cuda
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step
    from voicesplit_tpu_torch.train import steps as steps_mod

    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    cfg.model.dropout = 0.3
    cfg.train_config.spec_aug_time, cfg.train_config.spec_aug_freq = 24, 40
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed=0)
    opt = make_optimizer(cfg, model)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, model, ap, opt)
    draws, real_draw = [], model.draw_dropout_keep

    def keep(shape, keep_prob, generator):
        k = real_draw(shape, keep_prob, generator)
        assert k.device.type == "cuda"
        draws.append(k.clone())
        return k

    def mask(spec, generator, *limits):
        bands = augment.draw_spec_bands(generator, spec.shape, *limits)
        draws.append(torch.cat([t for pair in bands.values() for t in pair], dim=1))
        return augment.apply_spec_bands(spec, bands)

    model.draw_dropout_keep = keep
    saved_mask, steps_mod.spec_time_freq_mask = steps_mod.spec_time_freq_mask, mask
    try:
        with _RaisingPlainVersions():
            lstm_cuda.reset_launch_counts()
            m = step(state, _card_batch(2))
            torch.cuda.synchronize()
            assert lstm_cuda.LAUNCHES == {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 2,
                                          "bilstm_bwd": 0}
            state.step = 0  # the same step's draws again, then the next step's
            step(state, _card_batch(2))
            step(state, _card_batch(2))
    finally:
        steps_mod.spec_time_freq_mask = saved_mask
    assert np.isfinite(float(m["loss"])) and not bool(m["loss_exploded"])
    first, again, after = draws[:3], draws[3:6], draws[6:]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not any(torch.equal(a, b) for a, b in zip(first, after))
    bands, drop = first[0], first[1:]
    assert int(bands[:, 2:4].max()) <= 24 and int(bands[:, 6:8].max()) <= 40
    share = sum(int(k.sum()) for k in drop) / sum(k.numel() for k in drop)
    assert abs(share - 0.7) <= 0.01


@pytest.mark.gpu
def test_native_loader_feeds_a_card_step(tmp_path):
    """Synthetic 3 s triplets through the native loader, placed on the card
    as the trainer places them, into one full-width train step through the
    kernels."""
    _need_card()
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.data.dataset import SeparationDataset, discover_samples
    from voicesplit_tpu_torch.data.native_loader import NativeBatchIterator
    from voicesplit_tpu_torch.data.prefetch import to_device
    from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
    from voicesplit_tpu_torch.ops import lstm_cuda
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    build_synthetic_dataset(str(tmp_path), 4, fmt=cfg.dataset.format, seed=0)
    ap = make_audio_processor(cfg)
    ds = SeparationDataset(discover_samples(str(tmp_path), cfg.dataset.format), ap,
                           cfg.audio.audio_len)
    it = NativeBatchIterator(ds, 2, seed=1, n_threads=2)
    batch = to_device(next(it), ap.device)
    it.close()
    assert batch["mixed_wav"].device.type == "cuda" and batch["mixed_wav"].shape == (2, 48000)
    model = weights.init_random_(make_masknet(cfg), seed=0)
    opt = make_optimizer(cfg, model)
    lstm_cuda.reset_launch_counts()
    m = make_train_step(cfg, model, ap, opt)(create_train_state(model, opt), batch)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 2, "bilstm_bwd": 0}
    assert np.isfinite(float(m["loss"]))


@pytest.mark.gpu
def test_debug_nans_names_an_op_on_card(tmp_path):
    """`Trainer(debug_nans=True)` on the card, a NaN in batch 2: caught at
    step 3, the report names the op that met it first."""
    _need_card()
    from voicesplit_tpu_torch.data.dataset import IteratorState
    from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
    from voicesplit_tpu_torch.train.trainer import Trainer

    class Poisoned:
        count = 0

        def batches_per_epoch(self):
            return 100

        @property
        def state(self):
            return IteratorState()

        def load_state(self, state):
            pass

        def __iter__(self):
            return self

        def __next__(self):
            b = _card_batch(2, seed=self.count)
            if self.count == 2:
                b["mixed_wav"][0, 7] = np.nan
            self.count += 1
            return b

    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    build_synthetic_dataset(str(tmp_path / "test"), 1, fmt=cfg.dataset.format, seed=0)
    cfg.dataset.test_dir = str(tmp_path / "test")
    tr = Trainer(cfg, log_dir=str(tmp_path / "logs"), train_loader=Poisoned(), enable_tb=False,
                 debug_nans=True)
    res = tr.fit(max_steps=6, validate_at_epoch_start=False)
    tr.close()
    assert res["exploded"] is True and res["step"] == 3
    first = res["nan_report"].splitlines()[0]
    assert first.startswith("nan or inf in the output of "), first


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("T", [25, 50])
def test_carried_lstm_fwd_chunks_match_plain_on_card(T, batch):
    """Streaming's use of `lstm_fwd`: four chained chunks, each from the
    previous launch's final (h, c) rounded to bf16 as `UniLSTM` rounds the
    carry, against the same chain through the plain version (bf16 operands,
    H=400): the kernel route, each chunk's hs / cs and the final state."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    g = torch.Generator().manual_seed(T + batch)
    H = 400
    w = (torch.rand(H, 4 * H, generator=g) * 0.1 - 0.05).to("cuda", torch.bfloat16)
    xs = [torch.randn(T, batch, 4 * H, generator=g).to("cuda", torch.bfloat16) for _ in range(4)]
    state = {k: [torch.zeros(batch, H, device="cuda")] * 2 for k in ("kernel", "plain")}
    lstm_cuda.reset_launch_counts()
    with torch.inference_mode():
        for xp in xs:
            for name, fn in (("kernel", lstm_cuda.lstm_fwd), ("plain", lstm_cuda.lstm_fwd_ref)):
                h0, c0 = (s.to(torch.bfloat16).float().contiguous() for s in state[name])
                hs, cs, _ = fn(xp, w, h0, c0)
                state[name] = [hs[-1], cs[-1]]
                if name == "kernel":
                    got = (hs, cs)
            for a, b in zip(got, (hs, cs)):
                assert (a - b).abs().max().item() <= 2e-2  # bf16: one flipped rounding of h
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES["lstm_fwd"] == 4 and lstm_cuda.ROUTES["cluster"] == 4
    for a, b in zip(state["kernel"], state["plain"]):
        assert (a - b).abs().max().item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("layer", sorted(CONV_LAYERS))
def test_conv_dilated_fwd_on_the_streaming_window_on_card(layer):
    """The symmetric streaming model's conv window, [1, 180, 601, 64] bf16
    (130 frames of history and a chunk of 50): each layer against the plain
    version that rounds once as the kernel does, and the edge rows alone."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda

    (kt, kf), dt = CONV_LAYERS[layer]
    g = torch.Generator().manual_seed(kt * 100 + dt)
    x = torch.randn(1, 180, 601, 64, generator=g).to("cuda", torch.bfloat16)
    w = (torch.randn(kt, kf, 64, 64, generator=g) / (kt * kf * 64) ** 0.5).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        got = conv_cuda.conv_dilated_fwd(x, w, dt)
        want = conv_cuda.conv_dilated_fwd_round_once_ref(x, w, dt)
    peak = want.float().abs().max().item()
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 1e-2 * peak  # bf16: one rounding of the output either way
    edge = (kt - 1) * dt // 2
    if edge:
        assert err[:, :edge].max().item() <= 1e-2 * peak
        assert err[:, -edge:].max().item() <= 1e-2 * peak


@pytest.mark.gpu
def test_causal_stream_matches_plain_versions_on_card():
    """The causal streaming model at full width in bf16: one `lstm_fwd` a
    chunk and no conv kernel even with the dilated switch on, and the
    stream within 5e-3 of its peak of the same stream through the plain
    LSTM version."""
    _need_card()
    import os

    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda
    from voicesplit_tpu_torch.streaming import StreamingSeparator

    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    cfg.model.causal = True
    model = weights.init_random_(make_masknet(cfg, streaming=True), seed=0)
    sep = StreamingSeparator(cfg, model, 50)
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal((1, 16000))).astype(np.float32)
    emb = rng.standard_normal((1, 256)).astype(np.float32)
    before = os.environ.get("VOICESPLIT_PALLAS_CONV")
    os.environ["VOICESPLIT_PALLAS_CONV"] = "1"
    try:
        lstm_cuda.reset_launch_counts()
        conv_cuda.reset_launch_counts()
        out = sep.separate(wav, emb)
        torch.cuda.synchronize()
    finally:
        if before is None:
            del os.environ["VOICESPLIT_PALLAS_CONV"]
        else:
            os.environ["VOICESPLIT_PALLAS_CONV"] = before
    chunks = (16000 + sep.latency_samples) // sep.chunk_samples + 1
    assert lstm_cuda.LAUNCHES["lstm_fwd"] == chunks and not any(conv_cuda.LAUNCHES.values())
    with chip_smoke._PlainVersions(lstm_cuda):
        plain = sep.separate(wav, emb)
    assert out.shape == (1, 16000) and np.isfinite(out).all()
    assert np.abs(out - plain).max() <= 5e-3 * np.abs(plain).max()


# the speaker encoders' LSTM shapes, fp32: (T, rows, H, route of the forward).
# GE2E (H=768, 80-frame windows): a training step's 16 x 6 = 96 rows, the
# training CLI's held-out EER batch (4 held-out speakers: 16 rows) and the
# extraction CLI's fixed batches of 32 windows, none of which a cluster walk
# holds in fp32 (a block's W_hh columns alone are 590 KB): the grid route;
# CorentinJ (H=256, 160-frame windows): 32 windows, one cluster.
ENCODER_SHAPES = [(80, 96, 768, "grid"), (80, train_encoder.eval_rows(4), 768, "grid"),
                  (80, 32, 768, "grid"), (160, 32, 256, "cluster")]


def _encoder_lstm_inputs(T, R, H, seed, dhs_last_only=False):
    """A layer's inputs as the encoder gives them: W_hh uniform(±1/sqrt(H)),
    xp the projection of unit-variance inputs, the zero state; cotangents of
    the top layer (dhs nonzero at the last step only) or of a lower one."""
    g = torch.Generator().manual_seed(seed)
    s = H ** -0.5
    w = torch.empty(H, 4 * H).uniform_(-s, s, generator=g).cuda()
    xp = (torch.randn(T, R, 4 * H, generator=g) * 0.5).cuda()
    zeros = torch.zeros(R, H, device="cuda")
    dhs = torch.randn(T, R, H, generator=g).cuda()
    if dhs_last_only:
        dhs[:-1] = 0
    return xp, w, zeros, dhs


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ENCODER_SHAPES, ids=lambda s: "T{}-R{}-H{}".format(*s[:3]))
def test_lstm_forward_at_the_encoder_shapes_on_card(shape):
    """`lstm_fwd` in fp32 at the speaker encoders' shapes: the route chosen
    from the shape before the launch, every block of a grid resident at
    once, no spill, agreement with the plain version (1e-4, as at the
    path's shapes) and the same bits twice."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    T, R, H, route = shape
    cfg = lstm_cuda.launch_config(1, R, H, torch.float32, backward=False)
    assert cfg["route"] == route and cfg["local_bytes"] == 0, cfg
    if route == "grid":
        assert cfg["resident_blocks"] >= cfg["blocks"], cfg
    xp, w, zeros, _ = _encoder_lstm_inputs(T, R, H, seed=R + H)
    routes = dict(lstm_cuda.ROUTES)
    with torch.inference_mode():
        got = lstm_cuda.lstm_fwd(xp, w, zeros, zeros)
        again = lstm_cuda.lstm_fwd(xp, w, zeros, zeros)
        want = lstm_cuda.lstm_fwd_ref(xp, w, zeros, zeros)
    torch.cuda.synchronize()
    assert lstm_cuda.ROUTES[route] == routes[route] + 2
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("top", [True, False], ids=["top-layer", "lower-layer"])
def test_lstm_backward_at_the_ge2e_training_shape_on_card(top):
    """`lstm_bwd` in fp32 at a GE2E training step's shape (T=80, 96 rows,
    H=768): the grid route, all blocks resident, W_hh's rows in shared
    memory; agreement with the plain version within 1e-4 of each output's
    peak and the same bits twice, for the top layer's cotangents (the last
    frame only) and a lower layer's (every frame)."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    T, R, H = 80, 96, 768
    cfg = lstm_cuda.launch_config(1, R, H, torch.float32, backward=True)
    assert cfg["route"] == "grid" and cfg["resident_blocks"] >= cfg["blocks"], cfg
    assert cfg["w_shared"] and cfg["local_bytes"] == 0, cfg
    xp, w, zeros, dhs = _encoder_lstm_inputs(T, R, H, seed=7, dhs_last_only=top)
    with torch.inference_mode():
        hs, cs, gates = lstm_cuda.lstm_fwd_ref(xp, w, zeros, zeros)
    args = (w, gates, cs, hs, zeros, zeros, dhs, zeros, zeros, torch.float32)
    routes = dict(lstm_cuda.ROUTES_BWD)
    with torch.inference_mode():
        got, again, want = lstm_cuda.lstm_bwd(*args), lstm_cuda.lstm_bwd(*args), lstm_cuda.lstm_bwd_ref(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.ROUTES_BWD["grid"] == routes["grid"] + 2
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.gpu
def test_ge2e_step_runs_through_the_kernels_on_card():
    """One GE2E training step at full width (N=16 x M=6 = 96 rows, H=768, 3
    layers, fp32): exactly 3 `lstm_fwd` and 3 `lstm_bwd` launches, all on
    the grid routes; the loss (1e-5 relative) and every gradient (1e-4 of
    its peak; b's, 0 but for round-off, 1e-6) against the same batch through
    the plain versions."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda
    from voicesplit_tpu_torch.train.encoder import GE2E, SpeakerEncoder, make_ge2e_step
    from voicesplit_tpu_torch.train.state import make_adam
    from voicesplit_tpu_torch.weights import init_encoder_for_training_

    N, M = 16, 6
    g = torch.Generator().manual_seed(0)
    mels = (torch.randn(N * M, 40, 80, generator=g) - 2.0).cuda()  # log-mel-like
    model = GE2E(init_encoder_for_training_(SpeakerEncoder(), 0).cuda())
    step = make_ge2e_step(model, make_adam(model.parameters(), 1e-4), N, M)
    lstm_cuda.reset_launch_counts()
    loss = step(mels)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == {"lstm_fwd": 3, "bilstm_fwd": 0, "lstm_bwd": 3, "bilstm_bwd": 0}
    assert lstm_cuda.ROUTES["grid"] == 3 and lstm_cuda.ROUTES_BWD["grid"] == 3
    assert bool(torch.isfinite(loss))

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        value = model.loss(mels, N, M)
        value.backward()
        return value.item(), [p.grad.clone() for p in model.parameters()]

    got, g_kernel = loss_and_grads()
    with chip_smoke._PlainVersions(lstm_cuda):
        want, g_plain = loss_and_grads()
    assert abs(got - want) <= 1e-5 * abs(want)
    for (name, _), a, b in zip(model.named_parameters(), g_kernel, g_plain):
        if name == "b":
            assert a.abs().item() <= 1e-6 and b.abs().item() <= 1e-6
        else:
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item(), name


# rows of the fp32 grid routes at the GE2E encoder's width (T=80, H=768):
# one row, a pass's row slots partly used (9, 17, 95), whole (16, 32, 96;
# the encoder's held-out EER, extraction and training batches; 48: the
# forward's 6 and the backward's 2 row slots a lane)
GRID_ROWS = [1, 9, 16, 17, 32, 48, 95, 96]


def _grid_case(D, B, H, T, dtype, seed):
    """The forward and the backward on the grid route at D directions of B
    rows: the route and every block resident (checked before the launch),
    no spill, agreement with the plain versions (fp32 1e-4, bf16 2e-2: the
    forward absolute, the backward of each output's peak, as at the path's
    shapes), the same bits twice.  One direction runs from a nonzero (h0,
    c0) with nonzero final cotangents (dhf, dcf)."""
    from voicesplit_tpu_torch.ops import lstm_cuda

    dt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for backward in (False, True):
        cfg = lstm_cuda.launch_config(D, B, H, dt, backward=backward)
        assert cfg["route"] == "grid" and cfg["cluster"] == 0, cfg
        assert cfg["resident_blocks"] >= cfg["blocks"] and cfg["local_bytes"] == 0, cfg
    args, kernel, plain = _forward_inputs(D == 2, dtype, T, H, B, seed)
    routes = dict(lstm_cuda.ROUTES)
    with torch.inference_mode():
        got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.ROUTES["grid"] == routes["grid"] + 2
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a - b).abs().max().item() <= tol
    args = _backward_inputs(D == 2, dtype, T=T, H=H, B=B, seed=seed + 1)
    name = "bilstm_bwd" if D == 2 else "lstm_bwd"
    kernel, plain = getattr(lstm_cuda, name), getattr(lstm_cuda, name + "_ref")
    routes = dict(lstm_cuda.ROUTES_BWD)
    with torch.inference_mode():
        got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.ROUTES_BWD["grid"] == routes["grid"] + 2
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", GRID_ROWS)
def test_grid_routes_at_the_encoder_width_on_card(rows):
    _need_card()
    _grid_case(1, rows, 768, 80, "float32", seed=rows)


# other shapes of the grid routes: (directions, rows a direction, H, T,
# operand type): H not a multiple of 4 (h staged by plain loads), more units
# a block than a unit block holds (H=1100: 9 units, blocks of 8 and 1), the
# wide config's fp32 shapes (one and two rows a pass, one lane a column),
# bf16 two directions of 24 rows, and two directions where the longer
# chunks do not fit beside W_hh (H=832 at 4 rows, H=800 at 32: the short
# ones)
GRID_SHAPES = [(1, 3, 802, 7, "float32"), (1, 3, 1100, 5, "float32"), (1, 1, 800, 41, "float32"),
               (1, 2, 800, 41, "float32"), (2, 8, 800, 41, "float32"), (2, 24, 800, 9, "bfloat16"),
               (2, 4, 832, 9, "float32"), (2, 32, 800, 5, "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GRID_SHAPES, ids=lambda s: "D{}-B{}-H{}-T{}-{}".format(*s))
def test_grid_routes_at_other_shapes_on_card(shape):
    _need_card()
    D, B, H, T, dtype = shape
    _grid_case(D, B, H, T, dtype, seed=B + H)


@pytest.mark.gpu
def test_grid_backward_stages_w_hh_where_it_does_not_fit_on_card():
    """Two directions in fp32 at H=1000: the backward's rows of W_hh (256 KB)
    leave shared memory and are staged with dgates chunk by chunk; the
    backward still matches its plain version with the same bits twice (the
    forward's columns do not fit either: refused before and after)."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    cfg = lstm_cuda.launch_config(2, 2, 1000, torch.float32, backward=True)
    assert cfg["route"] == "grid" and not cfg["w_shared"], cfg
    assert cfg["resident_blocks"] >= cfg["blocks"] and cfg["local_bytes"] == 0, cfg
    args = _backward_inputs(True, "float32", T=5, H=1000, B=2, seed=3)
    with torch.inference_mode():
        got, again, want = lstm_cuda.bilstm_bwd(*args), lstm_cuda.bilstm_bwd(*args), lstm_cuda.bilstm_bwd_ref(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


# the fp32 dW_hh kernel alone: (T, rows a direction, H, directions): the
# GE2E training step's, ragged ones (H=40: a 64 x 128 tile past H and 4H;
# T B = 45, not a multiple of the 16-row chunk) and H=42 (plain loads)
DWHH_SHAPES = [(80, 96, 768, 1), (9, 5, 40, 1), (9, 5, 40, 2), (7, 3, 42, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DWHH_SHAPES, ids=lambda s: "T{}-B{}-H{}-D{}".format(*s))
def test_lstm_dwhh_f32_kernel_matches_plain_version_on_card(shape):
    """Against `lstm_dwhh_ref` within 1e-4 of the peak (the same rounded
    operands, another order of the sum over T B rows), the same bits twice,
    from a nonzero h0 in one direction and the zero state in two."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    T, B, H, D = shape
    g = torch.Generator().manual_seed(T + B + H + D)
    hs = torch.randn(T, D * B, H, generator=g).cuda()
    h0 = torch.randn(D * B, H, generator=g).cuda() if D == 1 else None
    dg = torch.randn(T, D * B, 4 * H, generator=g).cuda()
    got = lstm_cuda.lstm_dwhh(hs, h0, dg, D, torch.float32)
    again = lstm_cuda.lstm_dwhh(hs, h0, dg, D, torch.float32)
    want = lstm_cuda.lstm_dwhh_ref(hs, h0, dg, D, torch.float32)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, c)
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def _step_batch(batch, seed=0, n=48000):
    rng = np.random.default_rng(seed)
    target = (0.1 * rng.standard_normal((batch, n))).astype(np.float32)
    return {
        "mixed_wav": target + (0.1 * rng.standard_normal((batch, n))).astype(np.float32),
        "target_wav": target,
        "emb": rng.standard_normal((batch, 256)).astype(np.float32),
        "wav_len": np.full((batch,), n, np.int32),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["unfused", "fused_chain"])
def test_voicefilter_step_matches_plain_versions_on_card(route, monkeypatch):
    """`configs/voicefilter.json` (relu, power-law loss, bf16) at B=2: exact
    launches (on the chain 6 + 6 + 6 and 10 relu prologue passes), and the
    step against the same step through the plain versions with the smoke's
    TRAIN_TOL (unfused, the LSTM's) or FUSED_TOL (the chain's)."""
    _need_card()
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.ops import conv_fused, lstm_cuda
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "1" if route == "fused_chain" else "0")
    cfg = load_config(str(REPO / "configs" / "voicefilter.json"))
    assert cfg.loss.loss_name == "power_law_compression" and cfg.model_name == "voicefilter"
    cfg.train_config.learning_rate = chip_smoke.TRAIN_LR
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed=0)
    opt = make_optimizer(cfg, model)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, model, ap, opt)
    batch = _step_batch(2)
    snap = chip_smoke._snapshot(model, opt, state)
    lstm_cuda.reset_launch_counts()
    conv_fused.reset_launch_counts()
    mk = step(state, batch)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 2, "bilstm_bwd": 0}
    want = chip_smoke.CONV_LAUNCHES if route == "fused_chain" else {k: 0 for k in conv_fused.LAUNCHES}
    assert conv_fused.LAUNCHES == want
    through = chip_smoke._chain_state(model)
    lstm_k = chip_smoke._lstm_grads(model)
    chip_smoke._restore(model, opt, state, snap)
    with chip_smoke._PlainVersions(conv_fused if route == "fused_chain" else lstm_cuda):
        mp = step(state, batch)
    if route == "fused_chain":
        cmp = chip_smoke._compare_steps(torch, mk, through, mp, chip_smoke._chain_state(model))
        chip_smoke._check_step_agreement("voicefilter chain", cmp, chip_smoke.FUSED_TOL)
    else:
        lstm_p = chip_smoke._lstm_grads(model)
        tol = chip_smoke.TRAIN_TOL
        assert abs(float(mk["loss"]) - float(mp["loss"])) <= tol["loss_rel"] * abs(float(mp["loss"]))
        for k in lstm_p:
            assert chip_smoke._peak_rel(lstm_k[k], lstm_p[k]) <= tol["lstm_grad_peak_rel"], k


@pytest.mark.gpu
@pytest.mark.parametrize("layer", ["5x5-d1", "5x5-d2", "5x5-d4", "5x5-d8", "5x5-d16"])
def test_relu_prologue_on_every_chain_layer_on_card(layer):
    """Each chain layer that takes a prologue, with relu (the voicefilter
    model), through the three conv kernels against their plain versions at
    the training shape (bf16): the smoke's CONV_TOL and the same bits twice."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda, conv_fused

    g = torch.Generator().manual_seed(7)
    chip_smoke._check_conv_case(torch, conv_fused, conv_cuda, f"{layer}/relu", chip_smoke.CONV_SHAPE,
                                layer, "relu", "bfloat16", g)


@pytest.mark.gpu
@pytest.mark.parametrize("seconds", [3.0, 14.0])
def test_reference_dvector_matches_plain_versions_on_card(seconds, tmp_path):
    """`embed_reference` (what `cli.separate --reference_wav` takes) with a
    random GE2E ``embedder.pt`` in the reference's layout: 3 `lstm_fwd` a
    window batch of 32 on the grid route, the d-vector within 1e-5 of the
    plain versions'."""
    _need_card()
    from voicesplit_tpu_torch.data.synthetic import _speaker_wav
    from voicesplit_tpu_torch.ops import lstm_cuda
    from voicesplit_tpu_torch.train.encoder import embed_reference, load_ge2e_encoder, window_count

    chip_smoke._random_embedder(torch, tmp_path / "embedder.pt", 0)
    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    ap = make_audio_processor(cfg)
    enc = load_ge2e_encoder(str(tmp_path / "embedder.pt"), 40, "cuda").eval()
    wav = _speaker_wav(np.random.default_rng(1), 0, int(seconds * 16000), 16000)
    batches = -(-window_count(ap.get_mel(wav).shape[1], 80, 40) // 32)
    lstm_cuda.reset_launch_counts()
    got = embed_reference(enc, ap, wav)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == {"lstm_fwd": 3 * batches, "bilstm_fwd": 0, "lstm_bwd": 0,
                                  "bilstm_bwd": 0}
    assert lstm_cuda.ROUTES["grid"] == 3 * batches
    with chip_smoke._PlainVersions(lstm_cuda):
        want = embed_reference(enc, ap, wav)
    assert np.abs(got - want).max() <= chip_smoke.DVECTOR_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["unfused", "fused_chain"])
def test_nccl_world_of_one_step_is_the_step_without_a_group_on_card(route, monkeypatch):
    """A train step under an NCCL process group of one rank (the BatchNorm
    and gradient all-reduces run) gives the parameters, running statistics
    and metrics of the same step with no group, bit for bit."""
    _need_card()
    import torch.distributed as dist

    from voicesplit_tpu_torch.parallel.mesh import initialize_distributed

    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "1" if route == "fused_chain" else "0")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    cfg.train_config.learning_rate = chip_smoke.TRAIN_LR
    model, opt, state, step, batch = chip_smoke._fresh_step(cfg, 0, 2)
    snap = chip_smoke._snapshot(model, opt, state)
    results = {}
    for name in ("no_group", "group", "no_group_again"):
        chip_smoke._restore(model, opt, state, snap)
        if name == "group":
            assert initialize_distributed(f"localhost:{chip_smoke._free_port()}", 1, 0)
        try:
            m = step(state, batch)
            torch.cuda.synchronize()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        results[name] = ({k: v.clone() for k, v in model.state_dict().items()},
                         float(m["loss"]), float(m["grad_norm"]))
    base = results["no_group"]
    for name in ("group", "no_group_again"):
        sd, loss, gn = results[name]
        assert (loss, gn) == base[1:], name
        for k, v in sd.items():
            assert torch.equal(v, base[0][k]), (name, k)


# --- long-form separation and exported programs (chip_smoke's long and export
# phases, at a 20 s clip where the phase takes 120 s) ------------------------

LONG_TEST_SECONDS = 20.0  # 2,001 frames


def _long_setup(seed=0):
    from voicesplit_tpu_torch import weights

    cfg = load_config(str(REPO / "configs" / "voicesplit.json"))
    ap = make_audio_processor(cfg)
    model = weights.init_random_(make_masknet(cfg), seed)
    n = int(LONG_TEST_SECONDS * ap.sample_rate)
    wav, emb = chip_smoke.synthetic_batch(seed + 11, 1, n, ap.sample_rate, cfg.model.emb_dim)
    return cfg, ap, model, wav, emb


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["library", "dilated"])
def test_separate_long_world_of_one_is_separate_batch_on_card(route, monkeypatch):
    """No process group: the whole utterance on the card, `separate_batch`'s
    bits, both LSTM directions on `lstm_fwd` (and conv2 … conv7 on
    `conv_dilated_fwd` with the switch)."""
    _need_card()
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda
    from voicesplit_tpu_torch.parallel import sequence

    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1" if route == "dilated" else "0")
    cfg, ap, model, wav, emb = _long_setup()
    chip_smoke._reset_counts(torch, lstm_cuda, conv_cuda)
    got = sequence.separate_long(cfg, model, wav[0], emb[0])
    counted = chip_smoke._counts(torch, lstm_cuda, conv_cuda)
    assert {k: counted[k] for k in chip_smoke.LONG_LAUNCHES[route]} == chip_smoke.LONG_LAUNCHES[route]
    assert lstm_cuda.ROUTES["cluster"] == 2
    assert np.array_equal(got, separate_batch(model, ap, wav, emb)[0].cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("route", ["library", "dilated"])
def test_sharded_mask_matches_the_world_of_one_on_card(route, shards, monkeypatch):
    """K shards in one process (halos, the carry relay, the padded tail)
    against the world of one's mask: the same bits, or only the library
    calls that pick their kernel by shape differing, within
    LONG_SHARDED_TOL; 2·K² `lstm_fwd` launches (every shard holds valid
    frames) and 6 `conv_dilated_fwd` a shard with the switch."""
    _need_card()
    import torch.nn.functional as tnf

    from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda
    from voicesplit_tpu_torch.parallel import sequence

    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1" if route == "dilated" else "0")
    cfg, ap, model, wav, emb = _long_setup(1)
    e = torch.as_tensor(emb, device="cuda")
    with torch.inference_mode():
        spec, _ = ap.wav2spec_batch(torch.as_tensor(wav, device="cuda"))
        T = spec.shape[1]
        Tp = sequence.pad_frames(T, shards, model.conv_context_left)
        assert Tp > T  # the tail is padded
        want = sequence.make_sp_mask_fn(model, sequence.InProcessExchange(1))(spec, e, T)
        chip_smoke._reset_counts(torch, lstm_cuda, conv_cuda)
        got = sequence.make_sp_mask_fn(model, sequence.InProcessExchange(shards))(
            tnf.pad(spec, (0, 0, 0, Tp - T)), e, T)[:, :T]
        counted = chip_smoke._counts(torch, lstm_cuda, conv_cuda)
    expected = chip_smoke.long_sharded_launches(shards, shards, route == "dilated")
    assert {k: counted[k] for k in expected} == expected
    if not torch.equal(got, want):
        ops = chip_smoke._sp_differences(torch, lstm_cuda, model, spec, e, shards)["differs"]
        assert set(ops) <= set(chip_smoke.LIBRARY_SHAPE_OPS), ops
        assert (got - want).abs().max().item() <= chip_smoke.LONG_SHARDED_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
def test_relay_is_exact_at_the_long_form_shapes_on_card(shards):
    """The world of one's LSTM inputs cut into K padded shards through the
    carry relay: `BiLSTM`'s two `lstm_fwd` over the utterance, bit for bit."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    cfg, ap, model, wav, emb = _long_setup(4)
    with torch.inference_mode():
        spec, _ = ap.wav2spec_batch(torch.as_tensor(wav, device="cuda"))
    got = chip_smoke._relay_exact(torch, lstm_cuda, model, spec, torch.as_tensor(emb, device="cuda"),
                                  shards)
    assert got == {"fwd": True, "bwd": True}


@pytest.mark.gpu
def test_long_form_kernels_on_windows_match_plain_versions_on_card():
    """`lstm_fwd` at B=1 from a nonzero carry and `conv_dilated_fwd` on a
    window whose last frames are zero, against their plain versions (the
    helper checks and raises)."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda

    _, _, model, _, _ = _long_setup(2)
    out = chip_smoke._long_kernel_windows(torch, lstm_cuda, conv_cuda, model, 2)
    assert out["lstm_fwd_from_carry"]["max_abs_err"] <= chip_smoke.TOL["bfloat16"]


@pytest.mark.gpu
def test_separate_long_refuses_one_frame_past_the_index_limit_on_card():
    _need_card()
    from voicesplit_tpu_torch.parallel import sequence

    cfg, ap, model, wav, emb = _long_setup(3)
    limit = sequence.MAX_CONV_ELEMENTS // (601 * 64)
    assert limit == 55831
    with pytest.raises(ValueError, match="at most 55831 frames a device"):
        sequence.separate_long(cfg, model, np.resize(wav[0], limit * ap.hop_length), emb[0])


@pytest.mark.gpu
def test_exported_programs_load_cold_and_launch_the_kernels_on_card(tmp_path):
    """The export phase: the separator (symbolic batch, with the dilated
    switch, pinned to 8) and the chunk step exported for the card, loaded in
    a fresh interpreter with only the operators imported, their launches
    counted there, outputs against the eager path (the phase checks)."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda

    launches = chip_smoke.phase_export(torch, lstm_cuda, conv_cuda, 0, tmp_path)
    assert launches["lstm_fwd"] == 2 * 4 + chip_smoke.EXPORT_CHUNKS
    assert launches["bilstm_fwd"] == 1 and launches["conv_dilated_fwd"] == 6


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["lstm_fwd", "bilstm_fwd", "conv_dilated_fwd"])
def test_operator_launches_its_kernel_and_fakes_its_shapes_on_card(name):
    """Each operator on CUDA tensors launches its kernel once (counted), and
    its fake implementation gives the real outputs' shapes and types."""
    _need_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda

    bf = torch.bfloat16
    args = {
        "lstm_fwd": lambda: (torch.randn(31, 3, 1600, device="cuda").to(bf),
                             0.05 * torch.randn(400, 1600, device="cuda").to(bf),
                             torch.zeros(3, 400, device="cuda"), torch.zeros(3, 400, device="cuda")),
        "bilstm_fwd": lambda: (torch.randn(31, 16, 1600, device="cuda").to(bf),
                               0.05 * torch.randn(400, 1600, device="cuda").to(bf),
                               0.05 * torch.randn(400, 1600, device="cuda").to(bf)),
        "conv_dilated_fwd": lambda: (torch.randn(1, 33, 601, 64, device="cuda").to(bf),
                                     0.05 * torch.randn(5, 5, 64, 64, device="cuda").to(bf), 2),
    }[name]()
    module = conv_cuda if name.startswith("conv") else lstm_cuda
    op = getattr(torch.ops.voicesplit, name)
    chip_smoke._reset_counts(torch, module)
    real = op(*args)
    assert chip_smoke._counts(torch, module)[name] == 1
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    real, fake = (real, fake) if isinstance(real, tuple) else ((real,), (fake,))
    assert [(tuple(f.shape), f.dtype, f.device.type) for f in fake] == \
        [(tuple(r.shape), r.dtype, r.device.type) for r in real]


# --- the gate split and conv-block remat (chip_smoke's model_parallel and
# remat phases, at 1 s clips) ----------------------------------------------


def _short_config(name="voicesplit.json"):
    cfg = load_config(str(REPO / "configs" / name))
    cfg.train_config.learning_rate = chip_smoke.TRAIN_LR
    cfg.audio.audio_len = 1.0  # 101 frames
    return cfg


def _counted_steps(step, state, batch, n, *modules):
    """`n` steps; the launches of each, the losses and the state's bits."""
    counts, losses = [], []
    for _ in range(n):
        chip_smoke._reset_counts(torch, *modules)
        losses.append(float(step(state, batch)["loss"]))
        counts.append(chip_smoke._counts(torch, *modules))
    return counts, losses, chip_smoke._state_bits(torch, state)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("config", ["voicesplit.json", "voicesplit_wide.json"])
def test_split_state_steps_as_the_unsharded_state_on_card(config, shards, monkeypatch):
    """Three steps with the training state split over K in-process model
    shards against three unsharded steps from the same weights: losses,
    parameters, Adam's moments and running statistics bit for bit; 2 + 2
    LSTM launches a step (the split walks at H=800)."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda, conv_fused, lstm_cuda
    from voicesplit_tpu_torch.parallel import InProcessShardExchange, make_mesh, shard_train_state
    from voicesplit_tpu_torch.train import make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "0")
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "0")
    cfg = _short_config(config)
    modules = (lstm_cuda, conv_fused, conv_cuda)
    runs = {}
    for k in (1, shards):
        model, opt, state, step, batch = chip_smoke._fresh_step(cfg, 0, 2)
        if k > 1:
            state = shard_train_state(state, make_mesh(), model_parallel=True,
                                      exchange=InProcessShardExchange(k))
            step = make_train_step(cfg, model, make_audio_processor(cfg), state.optimizer)
        runs[k] = _counted_steps(step, state, batch, 3, *modules)
    counts, losses, bits = runs[shards]
    assert losses == runs[1][1]
    assert not chip_smoke._bits_differ(torch, bits, runs[1][2])
    routes = chip_smoke.WIDE_ROUTES if cfg.model.lstm_dim == chip_smoke.GRID_HIDDEN else None
    for c in counts:
        want = {k: 0 for m in modules for k in m.LAUNCHES}
        assert c == {**want, **chip_smoke.WIDE_TRAIN_LAUNCHES}
        chip_smoke._check_routes(lstm_cuda, c, "split", routes)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["unfused", "pallas_conv", "fused_chain"])
def test_remat_step_is_the_plain_step_on_card(route, monkeypatch):
    """Two B=2 steps with VOICESPLIT_REMAT_CONV=1 against two without, from
    the same weights: the same bits (losses, parameters, moments, running
    statistics) and the switch's launches (18 `conv_dilated_fwd` a step with
    the dilated switch)."""
    _need_card()
    from voicesplit_tpu_torch.ops import conv_cuda, conv_fused, lstm_cuda

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "1" if route == "fused_chain" else "0")
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1" if route == "pallas_conv" else "0")
    cfg = _short_config()
    modules = (lstm_cuda, conv_fused, conv_cuda)
    runs = {}
    for remat in ("0", "1"):
        monkeypatch.setenv("VOICESPLIT_REMAT_CONV", remat)
        model, opt, state, step, batch = chip_smoke._fresh_step(cfg, 0, 2)
        runs[remat] = _counted_steps(step, state, batch, 2, *modules)
    assert runs["1"][1] == runs["0"][1]
    assert not chip_smoke._bits_differ(torch, runs["1"][2], runs["0"][2])
    want = {k: 0 for m in modules for k in m.LAUNCHES}
    want.update(chip_smoke.TRAIN_LAUNCHES[2], **chip_smoke.REMAT_CONV_LAUNCHES[route])
    assert runs["1"][0] == [want, want]


@pytest.mark.gpu
def test_serving_cli_on_jax_and_port_checkpoints_on_card(tmp_path, monkeypatch):
    """`cli.separate --checkpoint_path` at full width on the card, as the
    smoke's checkpoint phase: a JAX-layout ``.msgpack`` and the port's
    ``.pt`` of the same weights with no ``-c`` and a ``.pt`` d-vector (2
    `lstm_fwd` each), a JAX-layout causal streaming file with
    ``--streaming`` (1 a chunk), each file the bytes `separate_batch` or
    `StreamingSeparator` writes for the same trees; the BiLSTM file with
    ``--streaming`` refused before any launch."""
    _need_card()
    from voicesplit_tpu_torch.ops import lstm_cuda

    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "0")
    checks = []
    monkeypatch.setattr(chip_smoke, "emit", lambda phase, **fields: checks.append(fields))
    launches = chip_smoke.phase_checkpoint(torch, lstm_cuda, 0, tmp_path)
    calls = checks[0]["calls"]
    chunks = checks[0]["streaming_chunks"]
    assert launches["lstm_fwd"] == 2 + 2 + chunks and launches["bilstm_fwd"] == 0
    assert all(c["same_bytes_as_direct"] for k, c in calls.items() if k != "bilstm_streaming_refused")
    assert calls["bilstm_streaming_refused"]["launches"]["lstm_fwd"] == 0
