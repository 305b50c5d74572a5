"""The gate split (`voicesplit_tpu_torch/parallel/sharding.py`, model-sharded
training state with replicated compute) in one process: the partition table
against the JAX package's `_MODEL_RULES`, K in-process model shards against
the one-process step bit for bit, the K=2 step against JAX's own
`tests/test_parallel.py` step on its 4x2 CPU mesh, checkpoints across the
split, and the one-process refusal of ``model_parallel > 1``.  The
multi-process runs are `tests/test_torch_model_parallel_dist.py`.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from test_torch_train import GRAD_REL, _assert_grads_close
from voicesplit_tpu.config import Config as JaxConfig
from voicesplit_tpu.dsp.processor import AudioProcessor as JaxAudioProcessor
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.parallel import make_mesh as jax_make_mesh
from voicesplit_tpu.parallel import param_partition_spec as jax_param_partition_spec
from voicesplit_tpu.parallel import shard_train_state as jax_shard_train_state
from voicesplit_tpu.parallel import batch_sharding as jax_batch_sharding
from voicesplit_tpu.train import create_train_state as jax_create_train_state
from voicesplit_tpu.train import make_optimizer as jax_make_optimizer
from voicesplit_tpu.train import make_train_step as jax_make_train_step
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.config import Config, load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import MaskNet, make_masknet
from voicesplit_tpu_torch.parallel import (
    InProcessShardExchange,
    make_mesh,
    param_partition_spec,
    shard_train_state,
)
from voicesplit_tpu_torch.parallel.sharding import shard_bounds
from voicesplit_tpu_torch.train import create_train_state, make_eval_step, make_optimizer, make_train_step
from voicesplit_tpu_torch.train import checkpoint as ckpt
from voicesplit_tpu_torch.train.trainer import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
HOP, FRAMES = 32, 40
L = HOP * FRAMES
LR = 1e-3
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The partition table
# ---------------------------------------------------------------------------

MODELS = {
    "voicefilter": dict(activation="relu"),
    "voicesplit": dict(activation="mish"),
    "voicesplit_extra_block": dict(activation="mish", num_extra_dilated_blocks=1),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_partition_table_is_jax_model_rules_in_the_port_layout(name):
    """Each JAX leaf is filled with its index along the axis its spec puts on
    ``model`` (zeros where replicated) and carried into the port's layout by
    `weights.params_from_jax`: the port parameter must vary along exactly the
    dimension `param_partition_spec` names, and a replicated leaf must be
    replicated in the port."""
    port = MaskNet(num_freq=33, emb_dim=16, lstm_dim=16, fc1_dim=24, fc2_dim=33,
                   conv_channels=8, **MODELS[name])
    params, _ = weights.random_jax_variables(port, seed=0)
    specs = jax_param_partition_spec(params, model_parallel=True)

    def marker(leaf, spec):
        axes = [i for i, a in enumerate(spec) if a == "model"]
        if not axes:
            return np.zeros(np.shape(leaf), np.float32)
        shape = [1] * np.ndim(leaf)
        shape[axes[0]] = np.shape(leaf)[axes[0]]
        return np.broadcast_to(np.arange(shape[axes[0]], dtype=np.float32).reshape(shape),
                               np.shape(leaf)).copy()

    marked = jax.tree_util.tree_map(marker, params, specs, is_leaf=lambda x: isinstance(x, P))
    carried = weights.params_from_jax(marked)
    table = param_partition_spec(port, model_parallel=True)
    assert set(table) == set(carried) == {k for k, _ in port.named_parameters()}
    split = 0
    for k, t in carried.items():
        varies = [d for d in range(t.dim()) if t.shape[d] > 1
                  and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        if table[k] == "replicated":
            assert not varies, (k, varies)
        else:
            split += 1
            assert varies == [table[k]], (k, varies, table[k])
    # every conv block's kernel, bias, BN scale and bias, the LSTM's six, fc1's kernel
    n_blocks = len(port.block_names)
    assert split == 4 * n_blocks + 6 + 1
    assert set(param_partition_spec(port, model_parallel=False).values()) == {"replicated"}


@pytest.mark.parametrize("size,k,want", [(1600, 3, [534, 534, 532]), (8, 3, [3, 3, 2]),
                                         (2, 4, [1, 1, 0, 0]), (64, 4, [16] * 4)])
def test_shards_are_laid_as_gspmd_lays_them(size, k, want):
    bounds = [shard_bounds(size, i, k) for i in range(k)]
    assert [b - a for a, b in bounds] == want
    assert bounds[0][0] == 0 and all(bounds[i][1] == bounds[i + 1][0] for i in range(k - 1))


# ---------------------------------------------------------------------------
# K in-process shards against the one-process step
# ---------------------------------------------------------------------------


def _config_text(weight_decay=0.0, clip=None, decay_steps=None, channels=8):
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=HOP, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = L / SR
    d["model"].update(conv_channels=channels, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=16)
    d["train_config"].update(compute_dtype="float32", learning_rate=LR, weight_decay=weight_decay,
                             grad_clip_norm=clip, lr_decay_steps=decay_steps)
    return json.dumps(d)


def _batch(B, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / SR
    target = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300, (B, 1)) * t)
    mixed = target + 0.2 * np.sin(2 * np.pi * rng.uniform(400, 900, (B, 1)) * t)
    mixed += 0.02 * rng.standard_normal((B, L))
    return {"mixed_wav": mixed.astype(np.float32), "target_wav": target.astype(np.float32),
            "emb": rng.standard_normal((B, 16)).astype(np.float32),
            "wav_len": np.full((B,), L, np.int32)}


def _state(text, shards=0, seed=0):
    """A fresh port state from `seed`; with `shards`, split over that many
    in-process model shards."""
    tc = load_config_from_str(text)
    model = weights.init_random_(make_masknet(tc, device="cpu"), seed)
    state = create_train_state(model, make_optimizer(tc, model))
    if shards:
        state = shard_train_state(state, make_mesh(), model_parallel=True,
                                  exchange=InProcessShardExchange(shards))
    step = make_train_step(tc, model, make_audio_processor(tc, device="cpu"), state.optimizer)
    return tc, state, step


def _full(state):
    """Parameters and running statistics, the one-process layout's optimizer
    state dict, and the step."""
    state.gather_()
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            ckpt.optimizer_state_dict(state), state.step)


def _assert_same(got, want):
    (gsd, gopt, gstep), (wsd, wopt, wstep) = got, want
    assert gstep == wstep
    for k, v in wsd.items():
        assert torch.equal(gsd[k], v), k
    assert gopt["param_groups"] == wopt["param_groups"]
    assert list(gopt["state"]) == list(wopt["state"])
    for i, entry in wopt["state"].items():
        assert list(gopt["state"][i]) == list(entry)
        for k, v in entry.items():
            assert torch.equal(gopt["state"][i][k], v), (i, k)


# route: (switches, conv channels).  The JAX package's conditions send a
# layer to the dilated kernel at 64 channels or more and to the chain at a
# multiple of 64, so those routes run at 64, the narrowest width both take.
ROUTES = {"library": ({}, 8), "fused_chain": ({"VOICESPLIT_FUSED_CHAIN": "1"}, 64),
          "dilated": ({"VOICESPLIT_PALLAS_CONV": "1"}, 64)}
SPLIT_CASES = [("library", 2), ("library", 3), ("library", 4),
               ("fused_chain", 2), ("fused_chain", 3), ("fused_chain", 4), ("dilated", 3)]


@pytest.mark.parametrize("route,k", SPLIT_CASES)
def test_in_process_split_equals_the_one_process_step(route, k, monkeypatch):
    """Two steps with K in-process model shards (3 splits 4H = 64 and the
    8-channel convs unevenly, 4 leaves the 2-channel projection's last two
    shards empty; at 64 channels 3 gives 22, 22, 20) against the one-process
    step from the same weights: the losses, parameters, Adam moments and
    running statistics bit for bit."""
    switches, channels = ROUTES[route]
    for key, v in switches.items():
        monkeypatch.setenv(key, v)
    text = _config_text(channels=channels)
    _, one, step1 = _state(text)
    _, split, step_k = _state(text, shards=k)
    assert all(len(v) == k for v in split.shards.owned.values())
    for i in range(2):
        batch = _batch(2, seed=10 + i)
        m1, mk = step1(one, batch), step_k(split, batch)
        assert float(m1["loss"]) == float(mk["loss"]) and float(m1["grad_norm"]) == float(mk["grad_norm"])
    _assert_same(_full(split), _full(one))


def test_in_process_split_with_adamw_clipping_and_the_schedule(monkeypatch):
    """AdamW's two parameter groups, an active clip and the cosine schedule,
    three steps with K=2: the same bits as one process."""
    text = _config_text(weight_decay=0.01, clip=1e-2, decay_steps=2)
    _, one, step1 = _state(text)
    _, split, step_k = _state(text, shards=2)
    assert [len(g["params"]) for g in split.optimizer.param_groups] != \
        [len(g["params"]) for g in one.optimizer.param_groups]
    for i in range(3):
        batch = _batch(2, seed=20 + i)
        m1, mk = step1(one, batch), step_k(split, batch)
        assert float(mk["grad_norm"]) > 1e-2  # the clip is active
        assert float(m1["loss"]) == float(mk["loss"])
    _assert_same(_full(split), _full(one))


def test_split_state_holds_a_kth_of_the_split_moments():
    """Each shard's slices and their Adam moments are about 1/K of the split
    parameters' (GSPMD's ceil split), and the slices' gradients are all the
    optimizer steps beside the replicated parameters'."""
    text = _config_text()
    _, one, step1 = _state(text)
    _, split, step_k = _state(text, shards=4)
    step_k(split, _batch(2, seed=1))
    step1(one, _batch(2, seed=1))
    b = split.shards.bytes(split.optimizer)
    full = b["working_copy"]
    assert len(b["shards"]) == 4
    assert sum(s["params"] for s in b["shards"]) == full
    assert sum(s["optimizer_state"] for s in b["shards"]) == 2 * full + 4 * 4 * len(split.shards.dims)
    for s in b["shards"]:
        assert s["params"] <= full / 4 + 4 * 8 * len(split.shards.dims)
    total = sum(p.numel() * 4 for p in one.model.parameters())
    assert b["replicated_params"] == total - full
    assert all(p.grad is None for k, p in split.model.named_parameters() if k in split.shards.dims)


def test_eval_step_gathers_the_slices_first():
    """After a split step the module's split parameters are stale until a
    gather; an eval step given the state gathers first and gives the
    one-process eval's bits."""
    text = _config_text()
    tc, one, step1 = _state(text)
    _, split, step_k = _state(text, shards=2)
    batch = _batch(2, seed=3)
    step1(one, batch)
    step_k(split, batch)
    assert split.shards.stale
    ap = make_audio_processor(tc, device="cpu")
    got = make_eval_step(tc, split.model, ap, split)(_batch(2, seed=4))
    want = make_eval_step(tc, one.model, ap)(_batch(2, seed=4))
    assert not split.shards.stale
    assert torch.equal(got["mask"], want["mask"]) and float(got["loss"]) == float(want["loss"])


# ---------------------------------------------------------------------------
# Against JAX's own model-parallel step (tests/test_parallel.py's set-up)
# ---------------------------------------------------------------------------


def _jax_parallel_config():
    c = JaxConfig()
    c.model_name = "voicefilter"
    c.loss.loss_name = "power_law_compression"
    c.audio.audio_len = 0.4
    c.model.lstm_dim = 32
    c.model.fc1_dim = 48
    c.model.conv_channels = 8
    c.model.conv_out_channels = 2
    c.train_config.batch_size = 8
    c.train_config.compute_dtype = "float32"
    return c


def _jax_parallel_batch(B, seed=0):
    rng = np.random.default_rng(seed)
    n = int(SR * 0.4)
    return {
        "emb": rng.standard_normal((B, 256)).astype(np.float32),
        "target_wav": (0.1 * rng.standard_normal((B, n))).astype(np.float32),
        "mixed_wav": (0.2 * rng.standard_normal((B, n))).astype(np.float32),
        "wav_len": np.full((B,), n, np.int32),
    }


def test_split_step_agrees_with_jax_on_its_4x2_mesh():
    """`tests/test_parallel.py::test_model_parallel_specs_and_step`'s state and
    8-row batch: JAX's step on `make_mesh(data=4, model=2)` with
    ``shard_train_state(..., model_parallel=True)`` against the port's step
    with K=2 in-process shards from the same weights.  The loss to rtol 2e-4,
    as JAX holds its own sharded step; the running statistics to 1e-5, Adam's
    first moments within `GRAD_REL` of the largest and the parameters to
    2·lr, the fp32 train-step tolerances of `tests/test_torch_train.py`."""
    jc = _jax_parallel_config()
    jap = JaxAudioProcessor(jc.audio)
    jmodel = jax_make_masknet(jc)
    tx = jax_make_optimizer(jc)
    T = jap.frames_for(int(SR * jc.audio.audio_len))
    jstate = jax_create_train_state(jc, jmodel, jax.random.PRNGKey(0), (2, T, 601), tx)
    jstep = jax_make_train_step(jc, jmodel, jap, tx, donate=False)
    batch = _jax_parallel_batch(8)
    mesh = jax_make_mesh(data=4, model=2)
    sharded = jax_shard_train_state(jstate, mesh, model_parallel=True)
    sh = jax_batch_sharding(mesh, batch)
    jnew, jm = jstep(sharded, {k: jax.device_put(v, sh[k]) for k, v in batch.items()})

    tc = load_config_from_str(jc.to_json())
    model = make_masknet(tc, device="cpu")
    params, stats = jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    model.load_state_dict(weights.state_dict_from_jax(params, stats))
    state = shard_train_state(create_train_state(model, make_optimizer(tc, model)), make_mesh(),
                              model_parallel=True, exchange=InProcessShardExchange(2))
    m = make_train_step(tc, model, make_audio_processor(tc, device="cpu"), state.optimizer)(state, batch)

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-4)
    lr = tc.train_config.learning_rate
    got_sd, _, _ = _full(state)
    want_sd = weights.state_dict_from_jax(jax.device_get(jnew.params), jax.device_get(jnew.batch_stats))
    for k, v in want_sd.items():
        tol = 1e-5 if k.endswith((".mean", ".var")) else 2 * lr + 1e-7
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=tol, rtol=0, err_msg=k)
    mu = weights.params_from_jax(weights._adam_state(jax.device_get(jnew.opt_state)).mu)
    full_opt = ckpt.optimizer_state_dict(state)
    names = [k for k, _ in model.named_parameters()]
    exp_avg = {names[i]: st["exp_avg"].numpy() for i, st in full_opt["state"].items()}
    _assert_grads_close(exp_avg, {k: v.numpy() for k, v in mu.items()}, GRAD_REL)


# ---------------------------------------------------------------------------
# Checkpoints across the split
# ---------------------------------------------------------------------------


def test_split_checkpoint_is_the_one_process_file(tmp_path):
    """After two steps, the file written from the K=3 split state equals,
    byte for byte, the one written by one process at the same step."""
    text = _config_text(weight_decay=0.01)
    tc, one, step1 = _state(text)
    _, split, step_k = _state(text, shards=3)
    for i in range(2):
        step1(one, _batch(2, seed=30 + i))
        step_k(split, _batch(2, seed=30 + i))
    a = ckpt.save_checkpoint(str(tmp_path / "one"), one, tc)
    b = ckpt.save_checkpoint(str(tmp_path / "split"), split, tc)
    assert pathlib.Path(a).name == pathlib.Path(b).name == "checkpoint_2.pt"
    assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()


@pytest.mark.parametrize("direction", ["one_to_split", "split_to_one"])
def test_checkpoint_resumes_across_the_split(direction, tmp_path):
    """Two steps on one side, saved; restored on the other (the split state
    slices the full file); the third step there has the uninterrupted
    one-process run's bits."""
    text = _config_text(weight_decay=0.01)
    tc, ref, step_ref = _state(text)
    src_k, dst_k = (0, 2) if direction == "one_to_split" else (2, 0)
    _, src, step_src = _state(text, shards=src_k)
    for i in range(2):
        step_ref(ref, _batch(2, seed=40 + i))
        step_src(src, _batch(2, seed=40 + i))
    path = ckpt.save_checkpoint(str(tmp_path), src, tc)
    _, dst, step_dst = _state(text, shards=dst_k, seed=9)  # other weights: replaced
    ckpt.restore_train_state(ckpt.load_checkpoint(path), dst)
    _assert_same(_full(dst), _full(ref))
    step_ref(ref, _batch(2, seed=42))
    step_dst(dst, _batch(2, seed=42))
    _assert_same(_full(dst), _full(ref))


def test_jax_adam_state_carried_then_split_steps_as_one_process():
    """A JAX optax Adam state (random moments, update count 4) carried by
    `weights.optimizer_state_from_jax` into the one-process state, then
    split over 2 shards: its next step has the one-process step's bits."""
    from test_torch_train import Pair, _batch as train_batch, _config_text as train_config_text
    from test_torch_train import _random_adam_state

    a = Pair(train_config_text("float32", "si_snr", "voicesplit", 0.01, 5, 1.0))
    b = Pair(train_config_text("float32", "si_snr", "voicesplit", 0.01, 5, 1.0))
    _random_adam_state(a, count=4, seed=3)
    _random_adam_state(b, count=4, seed=3)
    split = shard_train_state(b.state, make_mesh(), model_parallel=True,
                              exchange=InProcessShardExchange(2))
    batch = train_batch(2, seed=5)
    m1 = a.port_step()(a.state, batch)
    m2 = make_train_step(b.tc, b.model, b.ap, split.optimizer)(split, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_same(_full(split), _full(a.state))


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------


def test_one_process_model_parallel_raises_naming_the_world(tmp_path):
    config = Config()
    with pytest.raises(ValueError, match="the world has 1"):
        Trainer(config, log_dir=str(tmp_path), device="cpu", model_parallel=2)
    state = create_train_state(MaskNet(num_freq=33, emb_dim=16, lstm_dim=16, fc1_dim=24,
                                       fc2_dim=33, conv_channels=8), torch.optim.Adam([torch.zeros(1)]))
    with pytest.raises(ValueError, match="process group"):
        shard_train_state(state, make_mesh(), model_parallel=True)
