"""The port's training entry point (`voicesplit_tpu_torch/train/trainer.py`,
`cli/train.py`) against the JAX package's `Trainer` from the same weights
and files, at a narrow width on the CPU.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.data.dataset import train_dataloader as jax_train_dataloader
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.train.trainer import Trainer as JaxTrainer
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli import train as train_cli
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
from voicesplit_tpu_torch.parallel import make_mesh
from voicesplit_tpu_torch.train.checkpoint import list_checkpoints, load_checkpoint
from voicesplit_tpu_torch.train.trainer import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
AUDIO_LEN, EMB = 0.25, 16
N_TRAIN, N_EVAL = 10, 3  # 5 batches of 2 per epoch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    fmt = load_config_from_str(_config_text(root)).dataset.format
    build_synthetic_dataset(str(root / "train"), N_TRAIN, audio_len=AUDIO_LEN, emb_dim=EMB, fmt=fmt, seed=0)
    build_synthetic_dataset(str(root / "test"), N_EVAL, audio_len=AUDIO_LEN, emb_dim=EMB, fmt=fmt, seed=1)
    return root


def _config_text(root, **train):
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=32, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = AUDIO_LEN
    d["model"].update(conv_channels=8, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=EMB)
    d["train_config"].update(
        compute_dtype="float32", learning_rate=1e-3, batch_size=2, seed=3, epochs=3,
        summary_interval=1, check_interval=1, checkpoint_interval=3)
    d["train_config"].update(train)
    d["dataset"].update(train_dir=str(root / "train"), test_dir=str(root / "test"))
    return json.dumps(d)


def _trainer(root, log_dir, checkpoint_path=None, text=None, **kwargs):
    config = load_config_from_str(text or _config_text(root))
    return Trainer(config, checkpoint_path=checkpoint_path, log_dir=str(log_dir),
                   enable_tb=False, device="cpu", **kwargs)


def _records(log_dir, key):
    lines = (pathlib.Path(log_dir) / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if key in r]


def test_fit_matches_the_jax_trainer(workspace, tmp_path):
    """Five steps across an epoch boundary and a checkpoint interval, each
    package's `Trainer` over the same files from the same weights (the JAX
    trainer's own initial ones): the same batches in the same order, so the
    train loss of every step and every validation agree (fp32; 1e-3, five
    Adam steps apart at most)."""
    text = _config_text(workspace)
    # the JAX trainer reads through its Python iterator, which its own tests
    # hold to its native loader; the port's trainer reads through its native one
    jc = jax_config(text)
    jtr = JaxTrainer(jc, log_dir=str(tmp_path / "jax"), enable_tb=False,
                     train_loader=jax_train_dataloader(jc, jax_audio_processor(jc)))
    tr = _trainer(workspace, tmp_path / "port")
    tr.model.load_state_dict(weights.state_dict_from_jax(
        jax.device_get(jtr.state.params), jax.device_get(jtr.state.batch_stats)))
    want = jtr.fit(max_steps=7)
    got = tr.fit(max_steps=7)
    tr.close()
    assert sorted(got) == sorted(want) == ["audio_sec_per_sec_per_chip", "grad_norm", "loss", "step"]
    assert got["step"] == want["step"] == 7
    jl, tl = _records(tmp_path / "jax", "train_loss"), _records(tmp_path / "port", "train_loss")
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == list(range(1, 8))
    np.testing.assert_allclose([r["train_loss"] for r in tl], [r["train_loss"] for r in jl], rtol=1e-3)
    np.testing.assert_allclose([r["grad_norm"] for r in tl], [r["grad_norm"] for r in jl], rtol=2e-2)
    je, te = _records(tmp_path / "jax", "eval_loss"), _records(tmp_path / "port", "eval_loss")
    # epoch starts at steps 0 and 5, checkpoint intervals at 3 and 6
    assert [r["step"] for r in te] == [r["step"] for r in je] == [0, 3, 5, 6]
    np.testing.assert_allclose([r["eval_loss"] for r in te], [r["eval_loss"] for r in je], rtol=1e-3)
    np.testing.assert_allclose([r["eval_si_snr"] for r in te], [r["eval_si_snr"] for r in je], atol=1e-2)
    # checkpoints at the intervals and the final state off an interval boundary
    assert [pathlib.Path(p).name for p in list_checkpoints(str(tmp_path / "port"))] == [
        "checkpoint_3.pt", "checkpoint_6.pt", "checkpoint_7.pt"]
    assert sorted(p.name for p in (tmp_path / "jax").glob("checkpoint_*")) == [
        "checkpoint_3.msgpack", "checkpoint_6.msgpack", "checkpoint_7.msgpack"]
    # the data position in the checkpoint is the JAX trainer's
    from voicesplit_tpu.train.checkpoint import load_checkpoint as jax_load

    assert load_checkpoint(str(tmp_path / "port" / "checkpoint_6.pt"))["data_state"] == {
        k: int(v) for k, v in jax_load(str(tmp_path / "jax" / "checkpoint_6.msgpack"))["data_state"].items()}
    assert tr.wall_seconds["fit"] >= tr.wall_seconds["train_step"] > 0
    assert type(tr.train_loader).__name__ == "NativeBatchIterator"


@pytest.mark.parametrize("prefetch_depth", [0, 2])
def test_resumed_run_equals_the_uninterrupted_one(prefetch_depth, workspace, tmp_path):
    """Seven steps in one run against four steps, a checkpoint, and a second
    trainer resumed from it: the same batches after the resume (the
    checkpoint holds the state of the last batch handed out, not of the
    prefetcher's readahead), the same weights, optimizer and step at the
    end, bit for bit (one thread pool, the same order of sums)."""
    whole = _trainer(workspace, tmp_path / "whole", prefetch_depth=prefetch_depth)
    whole.fit(max_steps=7, validate_at_epoch_start=False)
    whole.close()
    first = _trainer(workspace, tmp_path / "first", prefetch_depth=prefetch_depth)
    first.fit(max_steps=4, validate_at_epoch_start=False)
    first.close()
    ckpt = tmp_path / "first" / "checkpoint_4.pt"
    assert load_checkpoint(str(ckpt))["data_state"] == {"epoch": 0, "position": 4, "seed": 3}
    second = _trainer(workspace, tmp_path / "second", checkpoint_path=str(ckpt),
                      prefetch_depth=prefetch_depth)
    assert second.state.step == 4
    result = second.fit(max_steps=7, validate_at_epoch_start=False)
    second.close()
    assert result["step"] == 7
    a = load_checkpoint(str(tmp_path / "whole" / "checkpoint_7.pt"))
    b = load_checkpoint(str(tmp_path / "second" / "checkpoint_7.pt"))
    for group in ("model", "batch_stats"):
        for k, v in a[group].items():
            assert torch.equal(v, b[group][k]), k
    assert a["data_state"] == b["data_state"] == {"epoch": 1, "position": 2, "seed": 3}
    losses = {name: [r["train_loss"] for r in _records(tmp_path / name, "train_loss")]
              for name in ("whole", "first", "second")}
    assert losses["first"] + losses["second"] == losses["whole"]


def test_checkpoint_of_another_shape_warm_starts(workspace, tmp_path, capsys):
    """A checkpoint whose ``fc1`` has another width: the full restore fails
    with the reason printed, the partial one takes what fits and honours
    ``reinit_layers``; step, optimizer and data position start fresh."""
    donor = _trainer(workspace, tmp_path / "donor")
    donor.fit(max_steps=2, validate_at_epoch_start=False)
    donor.close()
    ckpt = str(tmp_path / "donor" / "checkpoint_2.pt")
    text = json.loads(_config_text(workspace, reinit_layers=["conv8"]))
    text["model"]["fc1_dim"] = 20
    tr = _trainer(workspace, tmp_path / "warm", checkpoint_path=ckpt, text=json.dumps(text))
    printed = capsys.readouterr().out
    assert "Full restore failed" in printed and "fc1.weight" in printed and "partial init" in printed
    assert tr.state.step == 0 and tr.train_loader.state.position == 0
    sd, want = tr.model.state_dict(), load_checkpoint(ckpt)["model"]
    assert torch.equal(sd["conv2.conv.weight"], want["conv2.conv.weight"])
    assert torch.equal(sd["lstm.fwd_w_hh"], want["lstm.fwd_w_hh"])
    assert not torch.equal(sd["conv8.conv.weight"], want["conv8.conv.weight"])
    assert tr.fit(max_steps=1, validate_at_epoch_start=False)["step"] == 1
    tr.close()


def test_request_preemption_checkpoints_and_returns(workspace, tmp_path):
    tr = _trainer(workspace, tmp_path / "logs", prefetch_depth=0)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    tr.request_preemption()
    result = tr.fit(max_steps=50, validate_at_epoch_start=False)
    assert result.get("preempted") is True and result["step"] == 1
    payload = load_checkpoint(str(tmp_path / "logs" / "checkpoint_1.pt"))
    assert payload["step"] == 1 and payload["data_state"]["position"] == 1
    # the handlers fit() installed are gone again, and the flag is cleared:
    # a later fit() trains instead of stopping at once
    assert {s: signal.getsignal(s) for s in handlers} == handlers
    assert tr.fit(max_steps=3, validate_at_epoch_start=False)["step"] == 3
    tr.close()


def test_signal_handler_requests_a_stop_then_escalates(workspace, tmp_path):
    tr = _trainer(workspace, tmp_path / "logs", prefetch_depth=0)
    tr._handle_signal(signal.SIGTERM, None)
    assert tr._preempt_requested
    with pytest.raises(KeyboardInterrupt):
        tr._handle_signal(signal.SIGTERM, None)
    tr.close()


@pytest.mark.parametrize("check_interval,summary_interval,found_at", [(1, 100, 2), (4, 100, 4), (50, 3, 3)])
def test_explosion_guard_rides_the_check_cadence(check_interval, summary_interval, found_at,
                                                 workspace, tmp_path):
    """A step whose loss is not finite from step 2 on: `fit` returns at the
    next step that reads the metrics (the check or the summary cadence)."""
    text = _config_text(workspace, check_interval=check_interval, summary_interval=summary_interval,
                        checkpoint_interval=1000)
    tr = _trainer(workspace, tmp_path / "logs", text=text, prefetch_depth=0)
    real_step = tr.train_step

    def step(state, batch):
        m = real_step(state, batch)
        if state.step >= 2:
            m = {**m, "loss": torch.tensor(float("nan")), "loss_exploded": torch.tensor(True)}
        return m

    tr.train_step = step
    result = tr.fit(max_steps=20, validate_at_epoch_start=False)
    tr.close()
    assert result["exploded"] is True and result["step"] == found_at and np.isnan(result["loss"])
    assert not list_checkpoints(str(tmp_path / "logs"))


def test_parts_not_yet_ported_raise(workspace, tmp_path):
    """The gate split in one process raises as the JAX package's mesh cannot
    be built there (its runs over several processes are
    `tests/test_torch_model_parallel_dist.py`)."""
    config = load_config_from_str(_config_text(workspace))
    for kwargs, match in (({"mesh": make_mesh(model=2, ranks=[0, 1])}, "a world of 1"),
                          ({"model_parallel": 2}, "the world has 1")):
        with pytest.raises(ValueError, match=match):
            Trainer(config, log_dir=str(tmp_path), device="cpu", **kwargs)
    # the streaming model and a causal config build (their training is
    # held to the JAX package's in tests/test_torch_streaming_train.py)
    tr = Trainer(config, log_dir=str(tmp_path), device="cpu", streaming=True, enable_tb=False)
    tr.close()
    assert tr.model.streaming and not tr.model.causal
    config.model.causal = True
    tr = Trainer(config, log_dir=str(tmp_path), device="cpu", enable_tb=False)
    tr.close()
    assert tr.model.streaming and tr.model.causal


CLI_FLAGS = {"model_parallel": ["--model_parallel", "2"]}


@pytest.mark.parametrize("flag", sorted(CLI_FLAGS))
def test_cli_flags_not_yet_ported_raise(flag, workspace, tmp_path):
    """``--model_parallel 2`` in one process raises before anything is
    written: the world of 1 is no multiple of the model axis."""
    config_path = tmp_path / "c.json"
    config_path.write_text(_config_text(workspace))
    with pytest.raises(ValueError, match="1 ranks not divisible by model=2"):
        train_cli.main(["-c", str(config_path), "--device", "cpu",
                        "--logs_path", str(tmp_path / "logs"), *CLI_FLAGS[flag]])
    assert not (tmp_path / "logs").exists()


def test_cli_without_a_card_raises_unless_the_cpu_is_named(workspace, tmp_path):
    config_path = tmp_path / "c.json"
    config_path.write_text(_config_text(workspace, logs_path=str(tmp_path / "logs")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["-c", str(config_path), "--max_steps", "1"])


def test_cli_trains_resumes_and_never_loads_jax(workspace, tmp_path):
    """A fresh interpreter runs the training CLI for four steps, then resumes
    from the middle checkpoint; JAX never loads.  The logs directory holds
    the config copy, the checkpoints and the metrics."""
    config_path = tmp_path / "c.json"
    config_path.write_text(_config_text(workspace, logs_path=str(tmp_path / "unused")))
    logs, logs2 = tmp_path / "logs", tmp_path / "logs2"
    code = textwrap.dedent(
        f"""
        import sys
        from voicesplit_tpu_torch.cli.train import main
        first = main(["-c", {str(config_path)!r}, "--logs_path", {str(logs)!r}, "--max_steps", "4",
                      "--eval_sdr", "--device", "cpu"])
        second = main(["-c", {str(config_path)!r}, "--logs_path", {str(logs2)!r}, "--max_steps", "5",
                       "--checkpoint_path", {str(logs / "checkpoint_3.pt")!r}, "--device", "cpu"])
        assert first["step"] == 4 and second["step"] == 5, (first, second)
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "voicesplit_tpu")]
        assert not bad, bad
        print("NO_JAX_OK")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2"},  # as `_few_threads`, for the new process
    )
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout and "Resumed checkpoint step 3" in proc.stdout
    assert load_config_from_str((logs / "config.json").read_text()).train_config.logs_path == str(logs)
    assert [pathlib.Path(p).name for p in list_checkpoints(str(logs))] == [
        "checkpoint_3.pt", "checkpoint_4.pt"]
    evals = _records(logs, "eval_sdr")
    assert [r["step"] for r in evals] == [0, 3] and all(np.isfinite(r["eval_si_snri"]) for r in evals)
    assert [r["step"] for r in _records(logs2, "train_loss")] == [4, 5]
