"""The port's checkpoints (`voicesplit_tpu_torch/train/checkpoint.py`): its
own files, the reader of the JAX package's msgpack files, partial restore
against the JAX package's, and serving from a trainer checkpoint.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.data.dataset import IteratorState as JaxIteratorState
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.train import checkpoint as jckpt
from voicesplit_tpu.train import state as jax_state
from voicesplit_tpu.train import steps as jax_steps
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli import separate as separate_cli
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.data.dataset import IteratorState
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.train import checkpoint as ckpt
from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
HOP, FRAMES = 32, 24
L = HOP * FRAMES
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config_text(fc1_dim=24, weight_decay=0.0):
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=HOP, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = L / 16000
    d["model"].update(conv_channels=8, lstm_dim=16, fc1_dim=fc1_dim, fc2_dim=65, emb_dim=16)
    d["train_config"].update(compute_dtype="float32", learning_rate=LR, weight_decay=weight_decay)
    return json.dumps(d)


def _batch(batch, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    target = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300, (batch, 1)) * t)
    mixed = target + 0.2 * np.sin(2 * np.pi * rng.uniform(400, 900, (batch, 1)) * t)
    mixed += 0.02 * rng.standard_normal((batch, L))
    return {
        "mixed_wav": mixed.astype(np.float32), "target_wav": target.astype(np.float32),
        "emb": rng.standard_normal((batch, 16)).astype(np.float32),
        "wav_len": np.full((batch,), L, np.int32),
    }


def _port_state(text, seed=0):
    tc = load_config_from_str(text)
    model = weights.init_random_(make_masknet(tc, device="cpu"), seed)
    optimizer = make_optimizer(tc, model)
    state = create_train_state(model, optimizer)
    step = make_train_step(tc, model, make_audio_processor(tc, device="cpu"), optimizer)
    return tc, state, step


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"] and sorted(oa["state"]) == sorted(ob["state"])
    for i, entry in oa["state"].items():
        for k, v in entry.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k])), (i, k)
    assert a.step == b.step


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])  # Adam; AdamW with two parameter groups
def test_round_trip_with_optimizer_and_data_state(weight_decay, tmp_path):
    """Two steps, save, restore into a fresh state: the same model,
    optimizer, step and data position, and the same third step, bit for
    bit."""
    text = _config_text(weight_decay=weight_decay)
    tc, state, step = _port_state(text)
    for i in range(2):
        step(state, _batch(2, seed=i))
    data_state = IteratorState(epoch=3, position=7, seed=42)
    path = ckpt.save_checkpoint(str(tmp_path), state, tc, data_state)
    assert path.endswith("checkpoint_2.pt") and ckpt.is_checkpoint_name(path)
    assert not list(tmp_path.glob("*.tmp"))

    payload = ckpt.load_checkpoint(path)
    assert sorted(payload) == ["batch_stats", "config_str", "data_state", "model", "optimizer", "step"]
    assert sorted(payload["batch_stats"]) == sorted(
        f"conv{i}.bn.{s}" for i in range(1, 9) for s in ("mean", "var"))
    assert ckpt.config_from_checkpoint(path).to_json() == tc.to_json()

    _, fresh, fresh_step = _port_state(text, seed=9)
    restored, got_data = ckpt.restore_train_state(payload, fresh)
    assert restored is fresh and got_data == data_state
    _assert_same_state(fresh, state)
    m, want = fresh_step(fresh, _batch(2, seed=5)), step(state, _batch(2, seed=5))
    assert float(m["loss"]) == float(want["loss"])
    _assert_same_state(fresh, state)


def test_checkpoint_holds_copies_not_the_live_tensors(tmp_path):
    """The payload is copied before the writer thread runs: a train step
    that updates the parameters in place meanwhile does not reach the file."""
    tc, state, step = _port_state(_config_text())
    step(state, _batch(2, seed=0))
    payload = ckpt._payload(state, tc, None)
    saved = {k: v.clone() for k, v in payload["model"].items()}
    step(state, _batch(2, seed=1))
    for k, v in payload["model"].items():
        assert torch.equal(v, saved[k]) and not torch.equal(v, state.model.state_dict()[k]), k


def test_async_writer_and_listing(tmp_path):
    tc, state, step = _port_state(_config_text())
    writer = ckpt.AsyncCheckpointer()
    paths = []
    for i in range(3):
        step(state, _batch(2, seed=i))
        paths.append(writer.save(str(tmp_path), state, tc))
    writer.wait()
    assert [pathlib.Path(p).name for p in ckpt.list_checkpoints(str(tmp_path))] == [
        "checkpoint_1.pt", "checkpoint_2.pt", "checkpoint_3.pt"]
    assert ckpt.latest_checkpoint(str(tmp_path)) == paths[-1]
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    assert ckpt.load_checkpoint(paths[-1])["step"] == 3
    # sorted by step, not by name
    (tmp_path / "checkpoint_10.pt").write_bytes(b"")
    assert ckpt.list_checkpoints(str(tmp_path))[-1].endswith("checkpoint_10.pt")

    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    bad = ckpt.AsyncCheckpointer()
    with pytest.raises((RuntimeError, OSError)):
        bad.save(str(blocked / "sub"), state, tc)
        bad.wait()


def test_full_restore_refuses_a_model_of_other_shapes_before_it_loads(tmp_path):
    tc, state, _ = _port_state(_config_text())
    path = ckpt.save_checkpoint(str(tmp_path), state, tc)
    _, other, _ = _port_state(_config_text(fc1_dim=20), seed=4)
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    with pytest.raises(ValueError, match="fc1.weight: checkpoint"):
        ckpt.restore_train_state(ckpt.load_checkpoint(path), other)
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, before[k]), k  # nothing was loaded
    with pytest.raises(ValueError, match="does not fit the model"):
        ckpt.load_model_variables(load_config_from_str(_config_text(fc1_dim=20)), path)
    sd = ckpt.load_model_variables(tc, path)
    assert sorted(sd) == sorted(state.model.state_dict())


@pytest.mark.parametrize("reinit", [None, ["fc1"], ["lstm", "conv8"]])
def test_partial_restore_matches_jax_on_a_changed_fc1(reinit):
    """A checkpoint of one model into a fresh model whose ``fc1`` has another
    width (so ``fc1`` and ``fc2.kernel`` change shape), with `reinit_layers`:
    the port takes and keeps the same leaves as the JAX package's
    `partial_restore`."""
    old = make_masknet(load_config_from_str(_config_text()), device="cpu")
    loaded_params, _ = weights.random_jax_variables(old, seed=1)
    new = make_masknet(load_config_from_str(_config_text(fc1_dim=20)), device="cpu")
    init_params, init_stats = weights.random_jax_variables(new, seed=2)
    new.load_state_dict(weights.state_dict_from_jax(init_params, init_stats))

    want = weights.params_from_jax(jax.device_get(
        jckpt.partial_restore(init_params, loaded_params, reinit)))
    taken = ckpt.partial_restore(new, weights.params_from_jax(loaded_params), reinit)
    got = dict(new.named_parameters())
    for k, v in want.items():
        assert torch.equal(got[k].detach(), v), k
    fresh = weights.params_from_jax(init_params)
    kept = sorted(k for k in got if torch.equal(got[k].detach(), fresh[k]))
    assert sorted(set(got) - set(taken)) == kept
    assert {"fc1.weight", "fc1.bias", "fc2.weight"} <= set(kept) and "fc2.bias" not in kept or reinit
    for pat in reinit or []:
        assert all(k in kept for k in got if pat in k)


def test_restore_train_state_partial_resets_step_and_optimizer(tmp_path):
    tc, state, step = _port_state(_config_text())
    step(state, _batch(2, seed=0))
    path = ckpt.save_checkpoint(str(tmp_path), state, tc, IteratorState(1, 2, 3))
    _, fresh, _ = _port_state(_config_text(fc1_dim=20), seed=4)
    stats_before = {k: v.clone() for k, v in fresh.model.state_dict().items() if ".bn.mean" in k}
    restored, data_state = ckpt.restore_train_state(
        ckpt.load_checkpoint(path), fresh, partial=True, reinit_layers=["conv1"])
    assert restored.step == 0 and data_state == IteratorState()
    assert not restored.optimizer.state_dict()["state"]
    sd, want = fresh.model.state_dict(), state.model.state_dict()
    assert torch.equal(sd["conv2.conv.weight"], want["conv2.conv.weight"])
    assert not torch.equal(sd["conv1.conv.weight"], want["conv1.conv.weight"])
    for k, v in stats_before.items():
        assert torch.equal(sd[k], v), k  # running statistics stay fresh


# ---------------------------------------------------------------------------
# The JAX package's msgpack checkpoints
# ---------------------------------------------------------------------------


def test_jax_checkpoint_gives_the_jax_output_and_the_same_next_step(tmp_path):
    """A ``.msgpack`` written by the JAX package after one AdamW step, read by
    `load_jax_checkpoint`: the port's model gives the JAX model's mask, and
    the next train step of each package from that state agrees (fp32: loss
    1e-5, every weight 1e-5 = 1e-2·lr, since after one real step Adam
    divides by the root of a single squared gradient and so amplifies the
    round-off of a small one, Adam's first moment within 1e-4 of the model's
    largest; the conv biases, whose
    exact gradient under a train-mode BatchNorm is zero, so that Adam
    normalizes round-off into a full step, within 2·lr)."""
    pytest.importorskip("msgpack")
    text = _config_text(weight_decay=0.01)
    jc, tc = jax_config(text), load_config_from_str(text)
    jmodel, jap = jax_make_masknet(jc), jax_audio_processor(jc)
    template = make_masknet(tc, device="cpu")
    params, stats = weights.random_jax_variables(template, 3)
    tx = jax_state.make_optimizer(jc)
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params))
    jstep = jax_steps.make_train_step(jc, jmodel, jap, tx, donate=False)
    jstate, _ = jstep(jstate, _batch(2, seed=0))
    path = jckpt.save_checkpoint(str(tmp_path), jstate, jc, JaxIteratorState(epoch=1, position=4, seed=7))
    assert path.endswith("checkpoint_1.msgpack")

    loaded = ckpt.load_jax_checkpoint(path)
    assert loaded["step"] == 1 and loaded["data_state"] == IteratorState(1, 4, 7)
    assert load_config_from_str(loaded["config_str"]).to_json() == tc.to_json()
    model = make_masknet(tc, device="cpu")
    model.load_state_dict(weights.state_dict_from_jax(loaded["params"], loaded["batch_stats"]))
    optimizer = make_optimizer(tc, model)
    state = create_train_state(model, optimizer)
    state.step = weights.optimizer_state_from_jax(loaded["opt_state"], model, optimizer)
    assert state.step == 1

    rng = np.random.default_rng(1)
    spec = rng.uniform(0, 1, (2, 9, 65)).astype(np.float32)
    emb = rng.standard_normal((2, 16)).astype(np.float32)
    want = jmodel.apply({"params": jstate.params, "batch_stats": jstate.batch_stats},
                        jnp.asarray(spec), jnp.asarray(emb))
    with torch.no_grad():
        got = model(torch.from_numpy(spec), torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)

    batch = _batch(2, seed=1)
    jstate, jm = jstep(jstate, batch)
    m = make_train_step(tc, model, make_audio_processor(tc, device="cpu"), optimizer)(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    want_sd = weights.state_dict_from_jax(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    for k, v in model.state_dict().items():
        tol = 2 * LR + 1e-7 if k.endswith("conv.bias") else 1e-5
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=tol, rtol=0, err_msg=k)
    mu = weights.params_from_jax(weights._adam_state(jax.device_get(jstate.opt_state)).mu)
    scale = max(float(v.abs().max()) for v in mu.values())
    for k, p in model.named_parameters():
        np.testing.assert_allclose(
            optimizer.state[p]["exp_avg"].numpy(), mu[k].numpy(), atol=1e-4 * scale, rtol=0,
            err_msg=k)


def test_msgpack_decoder_reads_flax_extension_types(tmp_path):
    """Arrays of several types, numpy scalars, a bfloat16 array (widened to
    float32) and nested tuples-as-dicts, written by flax's serializer."""
    pytest.importorskip("msgpack")
    import flax.serialization

    rng = np.random.default_rng(0)
    bf = jnp.asarray(rng.standard_normal(5), jnp.bfloat16)
    tree = {
        "model": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "idx": np.arange(6, dtype=np.int32).reshape(2, 3), "half": bf},
        "batch_stats": {},
        "optimizer": {"0": {"count": np.int32(5), "mu": {}, "nu": {}}, "1": {}},
        "step": 5, "config_str": "{}", "data_state": {"epoch": 0, "position": 2, "seed": 1},
    }
    path = tmp_path / "checkpoint_5.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    got = ckpt.load_jax_checkpoint(str(path))
    np.testing.assert_array_equal(got["params"]["w"], tree["model"]["w"])
    np.testing.assert_array_equal(got["params"]["idx"], tree["model"]["idx"])
    assert got["params"]["idx"].dtype == np.int32
    np.testing.assert_array_equal(got["params"]["half"], np.asarray(bf.astype(jnp.float32)))
    assert got["opt_state"]["0"]["count"] == 5 and got["data_state"].position == 2
    assert weights._adam_state(got["opt_state"]).count == 5


def test_missing_msgpack_is_a_plain_import_error(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "msgpack", None)  # makes ``import msgpack`` raise
    with pytest.raises(ImportError, match="'msgpack' package"):
        ckpt.load_jax_checkpoint(str(tmp_path / "checkpoint_1.msgpack"))


# ---------------------------------------------------------------------------
# Serving from a trainer checkpoint
# ---------------------------------------------------------------------------


def test_separate_cli_takes_a_trainer_checkpoint_as_weights(tmp_path):
    """``--weights checkpoint_<step>.pt`` gives the output of the same
    weights saved by `weights.save`."""
    tc, state, step = _port_state(_config_text())
    step(state, _batch(2, seed=0))
    config_path = tmp_path / "config.json"
    config_path.write_text(tc.to_json())
    ckpt_path = ckpt.save_checkpoint(str(tmp_path), state, tc)
    weights.save(state.model, str(tmp_path / "weights.pt"))
    ap = make_audio_processor(tc, device="cpu")
    ap.save_wav(_batch(1, seed=3)["mixed_wav"][0], str(tmp_path / "mix.wav"))
    np.save(tmp_path / "emb.npy", _batch(1, seed=3)["emb"][0])
    outs = []
    for name, w in (("a.wav", ckpt_path), ("b.wav", str(tmp_path / "weights.pt"))):
        separate_cli.main([
            "-c", str(config_path), "--weights", w, "--mixed_wav", str(tmp_path / "mix.wav"),
            "--emb", str(tmp_path / "emb.npy"), "--output", str(tmp_path / name), "--device", "cpu"])
        outs.append((tmp_path / name).read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 44
    other = tmp_path / "other"
    other.mkdir()
    bad = ckpt.save_checkpoint(str(other), _port_state(_config_text(fc1_dim=20))[1],
                               load_config_from_str(_config_text(fc1_dim=20)))
    with pytest.raises(ValueError, match="does not fit the model"):
        separate_cli.main([
            "-c", str(config_path), "--weights", bad, "--mixed_wav", str(tmp_path / "mix.wav"),
            "--emb", str(tmp_path / "emb.npy"), "--output", str(tmp_path / "c.wav"), "--device", "cpu"])
