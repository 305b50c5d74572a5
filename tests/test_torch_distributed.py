"""Data-parallel training of the port over `torch.distributed`: two CPU ranks
over gloo against the one-process step on the whole batch and the JAX
package's one-device step, the preemption agreement, and the training CLI in
two processes.

The ranks run in spawned interpreters (`tests/torch_dist_worker.py`, as
`tests/test_multihost.py` spawns the JAX package's workers); they import no
JAX and write ``.npz`` files that this process compares.  The config is
`tests/test_parallel.py`'s small fp32 power-law one, at 2 rows a rank.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from test_torch_train import Pair
from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
from voicesplit_tpu_torch.train.checkpoint import list_checkpoints, load_checkpoint

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dist_worker.py"
WORLD, ROWS = 2, 2  # ranks, rows a rank
SR = 16000
TIMEOUT = 300  # seconds a worker may take

# two ranks against one process over the same 4 rows: the same sums taken in
# another order (fp32).  The gradients of conv1 … conv3 pass back through up
# to seven BatchNorms whose sums cancel: the one-process step on the same four
# rows in another order moves them by up to 2e-3 of their peak (conv3's BN
# bias; conv4 onwards and the LSTM and dense leaves 5e-5 at most), so the
# gradients are held at `tests/test_torch_train.py`'s fp32 5e-3 of each
# leaf's peak.  Normalizing each rank's rows alone misses by 1e-2 to 2 of it.
LOSS_RTOL = 1e-5
GRAD_PEAK_REL = 5e-3  # of each leaf's peak
STAT_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads for this file's in-process work (the workers set
    their own), as `tests/test_torch_trainer.py` does."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config_text(**train) -> str:
    c = Config()
    c.model_name = "voicefilter"
    c.loss.loss_name = "power_law_compression"
    c.audio.audio_len = 0.4
    c.model.lstm_dim = 32
    c.model.fc1_dim = 48
    c.model.conv_channels = 8
    c.model.conv_out_channels = 2
    c.train_config.batch_size = ROWS
    c.train_config.compute_dtype = "float32"
    for k, v in train.items():
        setattr(c.train_config, k, v)
    return c.to_json()


def _batch(B: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    L = int(SR * 0.4)
    return {
        "emb": rng.standard_normal((B, 256)).astype(np.float32),
        "target_wav": (0.1 * rng.standard_normal((B, L))).astype(np.float32),
        "mixed_wav": (0.2 * rng.standard_normal((B, L))).astype(np.float32),
        "wav_len": np.full((B,), L, np.int32),
    }


def _run_ranks(argv_of_rank, timeout=TIMEOUT, world=WORLD):
    """Spawns one worker a rank, two threads each (as this file's tests
    run); returns their outputs once all exit 0."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(argv_of_rank(r, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO))
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def _grads(model) -> dict:
    return {k: p.grad.detach().numpy().copy() for k, p in model.named_parameters()}


def _assert_grads_close(got: dict, want: dict, rel: float) -> None:
    """Each leaf within `rel` of its own peak.  The conv biases are left out:
    each feeds a train-mode BatchNorm, so its exact gradient is zero and both
    sides hold only round-off there."""
    for k, v in want.items():
        if k.endswith("conv.bias"):
            continue
        np.testing.assert_allclose(got[k], v, atol=rel * np.abs(v).max(), rtol=0, err_msg=k)


def _one_process_step(pair: Pair, batch: dict, route: str, monkeypatch):
    """The port's step in this process, no group, from the pair's weights."""
    monkeypatch.setenv("VOICESPLIT_FUSED_CHAIN", "1" if route == "fused_chain" else "0")
    before = {k: v.clone() for k, v in pair.model.state_dict().items()}
    m = pair.port_step()(pair.state, batch)
    out = {"loss": float(m["loss"]), "grads": _grads(pair.model),
           "after": {k: v.clone().numpy() for k, v in pair.model.state_dict().items()}}
    pair.model.load_state_dict(before)
    return out


@pytest.fixture(scope="module")
def two_rank_setup(tmp_path_factory):
    """The config, weights and 4-row batch, JAX's one-device step on the
    batch, and the one-process port step on each route."""
    root = tmp_path_factory.mktemp("dist")
    text = _config_text()
    (root / "config.json").write_text(text)
    batch = _batch(WORLD * ROWS)
    np.savez(root / "batch.npz", **batch)
    pair = Pair(text, seed=0)
    torch.save(pair.model.state_dict(), root / "weights.pt")
    _, jm = pair.jax_step()(pair.jstate, batch)
    return root, text, batch, float(jax.device_get(jm["loss"]))


@pytest.mark.parametrize("route", ["unfused", "fused_chain"])
def test_two_ranks_step_equals_the_global_batch_step(route, two_rank_setup, tmp_path, monkeypatch):
    """(i) One step on two gloo ranks, 2 rows each, against the one-process
    port step on all 4 rows and JAX's one-device step: the loss (rtol 1e-5),
    the gradients the optimizer took (1e-5 of each leaf's peak), the running
    statistics (1e-6); both ranks' parameters equal bit for bit (rank 1 began
    from other weights: the broadcast replaced them).  (ii) The same
    comparison with each rank normalizing its own rows, the step a missing
    BatchNorm all-reduce would take (computed here as the mean of two
    one-process steps on 2 rows each), misses those tolerances."""
    root, text, batch, jax_loss = two_rank_setup
    outs = [tmp_path / f"rank{r}.npz" for r in range(WORLD)]
    _run_ranks(lambda r, port: [
        sys.executable, str(WORKER), str(r), str(WORLD), str(port), "step", str(outs[r]),
        str(root / "config.json"), str(root / "weights.pt"), str(root / "batch.npz"), route])
    ranks = [dict(np.load(p)) for p in outs]

    pair = Pair(text, seed=0)
    whole = _one_process_step(pair, batch, route, monkeypatch)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(float(got["loss"]), whole["loss"], rtol=LOSS_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(float(got["loss"]), jax_loss, rtol=LOSS_RTOL, err_msg=f"rank {r}")
        _assert_grads_close({k[5:]: v for k, v in got.items() if k.startswith("grad/")},
                            whole["grads"], GRAD_PEAK_REL)
        for k, v in whole["after"].items():
            if k.endswith((".mean", ".var")):
                np.testing.assert_allclose(got[f"after/{k}"], v, atol=STAT_ATOL, rtol=0, err_msg=k)
    for k in ranks[0]:
        assert np.array_equal(ranks[0][k], ranks[1][k]), f"ranks differ at {k}"

    # (ii) per-rank statistics: each half on its own, gradients averaged
    halves = [_one_process_step(pair, {k: v[r * ROWS:(r + 1) * ROWS] for k, v in batch.items()},
                                route, monkeypatch) for r in range(WORLD)]
    per_rank = {k: np.mean([h["grads"][k] for h in halves], axis=0) for k in whole["grads"]}
    misses = {k: np.abs(per_rank[k] - v).max() / np.abs(v).max()
              for k, v in whole["grads"].items() if not k.endswith("conv.bias")}
    assert max(misses.values()) > 10 * GRAD_PEAK_REL, misses
    per_rank_loss = float(np.mean([h["loss"] for h in halves]))
    assert abs(per_rank_loss - whole["loss"]) > LOSS_RTOL * abs(whole["loss"])  # 7e-5 here


def test_preemption_on_one_rank_stops_both_at_the_same_step(tmp_path):
    """(iii) Rank 0 alone is asked to stop; rank 1 can stop only through the
    all-gather at the guard's cadence (check_interval 2): both stop at step 2
    and one checkpoint is written, by rank 0."""
    data = tmp_path / "data"
    build_synthetic_dataset(str(data), 8, audio_len=0.4, emb_dim=256, seed=0)
    text = json.loads(_config_text(summary_interval=100, check_interval=2,
                                   checkpoint_interval=1000, epochs=10000))
    text["dataset"].update(train_dir=str(data), test_dir=str(data))
    (tmp_path / "config.json").write_text(json.dumps(text))
    logs = tmp_path / "logs"
    outs = [tmp_path / f"rank{r}.json" for r in range(WORLD)]
    _run_ranks(lambda r, port: [
        sys.executable, str(WORKER), str(r), str(WORLD), str(port), "preempt", str(outs[r]),
        str(tmp_path / "config.json"), str(logs)])
    got = [json.loads(p.read_text()) for p in outs]
    assert got == [{"step": 2, "preempted": True}] * WORLD, got
    ckpts = list_checkpoints(str(logs))
    assert [pathlib.Path(p).name for p in ckpts] == ["checkpoint_2.pt"]
    assert int(load_checkpoint(ckpts[0])["step"]) == 2


def test_cli_trains_in_two_processes_and_only_rank_0_writes(tmp_path):
    """(iv) `cli.train --coordinator --num_processes 2 --process_id k` trains
    two steps; each rank names its own logs directory, and only rank 0's
    exists afterwards (config copy, metrics, checkpoint, and the TensorBoard
    events where TensorBoard is installed)."""
    data = tmp_path / "data"
    build_synthetic_dataset(str(data), 8, audio_len=0.4, emb_dim=256, seed=0)
    text = json.loads(_config_text(summary_interval=1, check_interval=1, checkpoint_interval=1000))
    text["dataset"].update(train_dir=str(data), test_dir=str(data))
    config = tmp_path / "config.json"
    config.write_text(json.dumps(text))
    logs = [tmp_path / f"logs{r}" for r in range(WORLD)]
    outs = _run_ranks(lambda r, port: [
        sys.executable, "-m", "voicesplit_tpu_torch.cli.train", "-c", str(config),
        "--logs_path", str(logs[r]), "--max_steps", "2", "--device", "cpu",
        "--coordinator", f"localhost:{port}", "--num_processes", str(WORLD), "--process_id", str(r)])
    assert all("'step': 2" in out for out in outs), outs
    assert not logs[1].exists()
    names = sorted(p.name for p in logs[0].iterdir() if not p.name.startswith("events.out"))
    assert names == ["checkpoint_2.pt", "config.json", "metrics.jsonl"], names
    records = [json.loads(line) for line in (logs[0] / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train_loss" in r] == [1, 2]
