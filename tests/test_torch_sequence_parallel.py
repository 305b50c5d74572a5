"""Sequence-parallel long-form separation: the port's `parallel/sequence.py`
against the JAX package's, and the conv stack's edge mask.

K shards run in one process through `InProcessExchange` (the relay and the
halos of K devices); the JAX package runs its `shard_map` on the 8-device
CPU mesh of `tests/conftest.py`.  Narrow widths as `tests/test_sequence_parallel.py`
(4 conv channels, LSTM 24, fp32, all 601 bins); the edge-mask tests use
`tests/test_torch_masknet.py`'s widths, with 64 conv channels on the dilated
route so that its layers reach `conv_cuda` (the plain versions here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from voicesplit_tpu.config import load_config_from_str as jax_load_config_from_str
from voicesplit_tpu.models.lstm import lstm_scan as jax_lstm_scan
from voicesplit_tpu.models.masknet import MaskNet as JaxMaskNet
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.parallel import sequence as jseq
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli.separate import separate_batch
from voicesplit_tpu_torch.config import Config, load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import MaskNet, make_masknet
from voicesplit_tpu_torch.ops import lstm_cuda
from voicesplit_tpu_torch.parallel import sequence as seq
from voicesplit_tpu_torch.parallel.sequence import InProcessExchange, make_sp_mask_fn, pad_frames

SR = 16000
K = 8
# the mask against JAX's: the tolerance JAX holds its own sharded pass to
MASK_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config_text(causal=False) -> str:
    c = Config()
    c.model_name = "voicesplit"
    c.model.lstm_dim = 24
    c.model.fc1_dim = 32
    c.model.conv_channels = 4
    c.model.conv_out_channels = 2
    c.model.causal = causal
    c.train_config.compute_dtype = "float32"
    return c.to_json()


def _pair(causal=False, seed=0):
    """The port's model and the JAX model with its variables, same weights."""
    text = _config_text(causal)
    port = make_masknet(load_config_from_str(text), device="cpu")
    params, stats = weights.random_jax_variables(port, seed)
    port.load_state_dict(weights.state_dict_from_jax(params, stats))
    jcfg = jax_load_config_from_str(text)
    return text, port, jax_make_masknet(jcfg), {"params": params, "batch_stats": stats}


def _relay_inputs(B=2, Tc=10, H=16, seed=0):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((B, K * Tc, 4 * H)).astype(np.float32)
    w_hh = (0.3 * rng.standard_normal((H, 4 * H))).astype(np.float32)
    return xp, w_hh


def _port_relay(xp, w_hh, reverse, t_valid):
    B, T, _ = xp.shape
    Tc = T // K
    xps = [torch.from_numpy(xp[:, d * Tc:(d + 1) * Tc]) for d in range(K)]
    n_valid = [min(max(t_valid - d * Tc, 0), Tc) for d in range(K)]
    outs = seq._relay_scan(xps, torch.from_numpy(w_hh), reverse, n_valid, InProcessExchange(K))
    return torch.cat(outs, dim=0).transpose(0, 1).numpy()  # [B, T, H]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_relay_scan_matches_one_jax_scan(reverse):
    """K-1 relay rounds of `lstm_fwd` plus the output scan, K=8 shards,
    against the unsharded `lstm_scan` of the JAX package."""
    xp, w_hh = _relay_inputs()
    zeros = jnp.zeros((xp.shape[0], w_hh.shape[0]), jnp.float32)
    want, _ = jax_lstm_scan(jnp.asarray(xp), jnp.asarray(w_hh), zeros, zeros, reverse)
    got = _port_relay(xp, w_hh, reverse, xp.shape[1])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_relay_scan_skips_the_padded_tail_as_jax_masks_it(reverse):
    """Valid frames a prefix, 55 of 80: shard 5 half valid, shards 6 and 7
    none.  JAX holds the carry over masked frames; the port runs each shard
    over its valid prefix only: the same outputs on every real frame."""
    xp, w_hh = _relay_inputs(seed=1)
    t_valid = 55
    zeros = jnp.zeros((xp.shape[0], w_hh.shape[0]), jnp.float32)
    mask = (np.arange(xp.shape[1]) < t_valid).astype(np.float32)
    want, _ = jax_lstm_scan(jnp.asarray(xp), jnp.asarray(w_hh), zeros, zeros, reverse,
                            frame_mask=jnp.asarray(mask))
    got = _port_relay(xp, w_hh, reverse, t_valid)
    np.testing.assert_allclose(got[:, :t_valid], np.asarray(want)[:, :t_valid], atol=1e-6)
    assert not got[:, t_valid:].any()


def test_relay_scan_launches_k_squared_less_empty_shards(monkeypatch):
    """A direction of K in-process shards runs K-1 relay rounds and one
    output scan, a `lstm_fwd` a shard each: K² launches, less those of the
    shards with no valid frame (6 non-empty shards of 8: 7·6 + 6)."""
    calls = []
    real = lstm_cuda.lstm_fwd
    monkeypatch.setattr(lstm_cuda, "lstm_fwd", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    xp, w_hh = _relay_inputs(seed=2)
    _port_relay(xp, w_hh, False, 80)
    assert len(calls) == K * K
    calls.clear()
    _port_relay(xp, w_hh, True, 55)
    assert len(calls) == (K - 1) * 6 + 6
    assert sorted(set(calls)) == [5, 10]  # valid prefixes only


def _sp_inputs(T, seed):
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0, 1, (2, T, 601)).astype(np.float32)
    emb = rng.standard_normal((2, 256)).astype(np.float32)
    return spec, emb


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "tail-padded"])
@pytest.mark.parametrize("causal", [False, True], ids=["symmetric", "causal"])
def test_sp_mask_matches_jax_shard_map(causal, padded):
    """The port's K=8 in-process pass against JAX's `make_sp_mask_fn` on its
    8-device CPU mesh; with 16 alignment frames a shard appended and
    t_valid the real frame count, the real frames' mask is the same."""
    _, port, jmodel, variables = _pair(causal, seed=1)
    Tc = port.conv_context_left + 3  # the least legal shard and a little
    T = K * Tc
    spec, emb = _sp_inputs(T, seed=2)
    Tp = T + (K * 16 if padded else 0)
    spec_p = np.zeros((2, Tp, 601), np.float32)
    spec_p[:, :T] = spec
    mesh = jseq.make_seq_mesh(K)
    want = jseq.make_sp_mask_fn(jmodel, mesh)(
        variables, jax.device_put(spec_p, NamedSharding(mesh, P(None, "seq", None))),
        jnp.asarray(emb), jnp.asarray(T, jnp.int32))
    with torch.inference_mode():
        got = make_sp_mask_fn(port, InProcessExchange(K))(
            torch.from_numpy(spec_p), torch.from_numpy(emb), T)
    assert got.shape == (2, Tp, 601) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[:, :T], np.asarray(want)[:, :T], atol=MASK_ATOL)


def test_sp_mask_world_of_one_is_the_models_bits():
    """One shard: no halo, no mask, the model's own operations."""
    _, port, _, _ = _pair(seed=3)
    spec, emb = _sp_inputs(90, seed=4)
    s, e = torch.from_numpy(spec), torch.from_numpy(emb)
    with torch.inference_mode():
        assert torch.equal(make_sp_mask_fn(port, InProcessExchange(1))(s, e, 90), port(s, e))


@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_sp_mask_any_shard_count_matches_the_one_device_pass(n_shards):
    """fp32 on the CPU: the same sums, only the conv's window differs."""
    _, port, _, _ = _pair(seed=5)
    T = 301
    Tp = pad_frames(T, n_shards, port.conv_context_left)
    spec, emb = _sp_inputs(T, seed=6)
    spec_p = np.zeros((2, Tp, 601), np.float32)
    spec_p[:, :T] = spec
    with torch.inference_mode():
        want = port(torch.from_numpy(spec), torch.from_numpy(emb))
        got = make_sp_mask_fn(port, InProcessExchange(n_shards))(
            torch.from_numpy(spec_p), torch.from_numpy(emb), T)
    np.testing.assert_allclose(got.numpy()[:, :T], want.numpy(), atol=1e-5)


@pytest.mark.parametrize("T, n, least, want", [(100, 8, 10, 104), (100, 8, 70, 560),
                                                 (560, 8, 70, 560)])
def test_pad_frames_as_jax(T, n, least, want):
    assert pad_frames(T, n, least) == want == jseq.pad_frames(T, n, least)


def test_shard_over_the_index_limit_raises(monkeypatch):
    _, port, _, _ = _pair(seed=7)
    spec, emb = _sp_inputs(80, seed=8)
    monkeypatch.setattr(seq, "MAX_CONV_ELEMENTS", 2 * 79 * 601 * 4)
    with pytest.raises(ValueError, match="at most 79 frames a device"):
        make_sp_mask_fn(port, InProcessExchange(1))(
            torch.from_numpy(spec), torch.from_numpy(emb), 80)


def _long_wav(seed, seconds=4):
    rng = np.random.default_rng(seed)
    return ((0.1 * rng.standard_normal(SR * seconds)).astype(np.float32),
            rng.standard_normal(256).astype(np.float32))


def test_separate_long_matches_jax():
    """4 s (401 frames, padded to 520 over 8 shards): the port's in-process
    K=8 pass against JAX's `separate_long` on its 8-device mesh."""
    text, port, _, variables = _pair(seed=9)
    wav, emb = _long_wav(10)
    want = jseq.separate_long(jax_load_config_from_str(text), variables, wav, emb,
                              mesh=jseq.make_seq_mesh(K))
    got = seq.separate_long(load_config_from_str(text), port, wav, emb,
                            mesh=InProcessExchange(K))
    assert got.shape == wav.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_separate_long_world_of_one_is_separate_batch():
    """Without a process group: the whole utterance on one device, the bits
    of `separate_batch`."""
    text, port, _, _ = _pair(seed=11)
    wav, emb = _long_wav(12, seconds=2)
    got = seq.separate_long(load_config_from_str(text), port, wav, emb)
    ap = make_audio_processor(load_config_from_str(text), device="cpu")
    want = separate_batch(port, ap, wav[None], emb[None])[0].numpy()
    assert np.array_equal(got, want)


# --- the conv stack's edge mask ---------------------------------------------

DIMS = dict(num_freq=33, emb_dim=16, lstm_dim=16, fc1_dim=24, fc2_dim=33)
ROUTES = {  # route: (conv channels, causal, VOICESPLIT_PALLAS_CONV)
    "library": (8, False, "0"),
    "causal": (8, True, "0"),
    "dilated": (64, False, "1"),
}


def _mask_models(route, seed, monkeypatch):
    channels, causal, switch = ROUTES[route]
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", switch)
    port = MaskNet(activation="mish", conv_channels=channels, causal=causal, **DIMS).eval()
    params, stats = weights.random_jax_variables(port, seed)
    port.load_state_dict(weights.state_dict_from_jax(params, stats))
    jmodel = JaxMaskNet(activation="mish", conv_channels=channels, causal=causal, **DIMS)
    return port, jmodel, {"params": params, "batch_stats": stats}


def _mask_inputs(seed, T=40):
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0, 1, (2, T, DIMS["num_freq"])).astype(np.float32)
    edge = (rng.uniform(size=(2, T)) > 0.3).astype(np.float32)
    return spec, edge


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_edge_mask_matches_jax_on_every_eval_route(route, monkeypatch):
    port, jmodel, variables = _mask_models(route, 12, monkeypatch)
    spec, edge = _mask_inputs(13)
    want = jmodel.apply(variables, jnp.asarray(spec), False, jnp.asarray(edge),
                        method=jmodel.conv_features)
    with torch.inference_mode():
        got = port.conv_features(torch.from_numpy(spec), edge_mask=torch.from_numpy(edge))
    peak = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5 * max(peak, 1.0))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_all_ones_edge_mask_keeps_the_bits(route, monkeypatch):
    port, _, _ = _mask_models(route, 14, monkeypatch)
    spec, _ = _mask_inputs(15)
    s = torch.from_numpy(spec)
    with torch.inference_mode():
        assert torch.equal(port.conv_features(s, edge_mask=torch.ones(1, s.shape[1])),
                           port.conv_features(s))


def test_masked_tail_acts_as_the_convs_zero_padding(monkeypatch):
    """Garbage frames after T, marked 0: the first T frames are those of a
    pass over the T frames alone."""
    port, _, _ = _mask_models("library", 16, monkeypatch)
    spec, _ = _mask_inputs(17, T=56)
    edge = torch.zeros(1, 56)
    edge[:, :40] = 1
    with torch.inference_mode():
        got = port.conv_features(torch.from_numpy(spec), edge_mask=edge)[:, :40]
        want = port.conv_features(torch.from_numpy(spec[:, :40]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_fused_chain_refuses_an_edge_mask(monkeypatch):
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "0")
    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "1")
    port = MaskNet(activation="mish", conv_channels=64, **DIMS).train()
    spec, edge = _mask_inputs(19)
    with pytest.raises(NotImplementedError, match="fused conv chain"):
        port.conv_features(torch.from_numpy(spec), edge_mask=torch.from_numpy(edge))


def test_cli_sequence_parallel_writes_the_default_paths_file(tmp_path):
    """``--sequence_parallel`` without a process group: a world of one,
    the file of the default serving path."""
    from test_torch_separate import _cli_files
    from voicesplit_tpu_torch.cli.separate import main

    _, _, _, args = _cli_files(tmp_path)
    main(args)
    want = (tmp_path / "out.wav").read_bytes()
    main(args + ["--sequence_parallel"])
    assert (tmp_path / "out.wav").read_bytes() == want
