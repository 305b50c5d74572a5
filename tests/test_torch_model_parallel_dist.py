"""The gate split over `torch.distributed`: gloo CPU ranks spawned as
`tests/test_torch_distributed.py` spawns them (`tests/torch_dist_worker.py`,
no JAX).  A ``1 x 2`` mesh against the one-process step, a ``2 x 2`` mesh
against the two-rank data-parallel step, each bit for bit, and the training
CLI with ``--model_parallel 2`` in two processes.  The config is
`tests/test_parallel.py`'s small fp32 power-law one.
"""

import json
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

from test_torch_distributed import ROWS, _batch, _config_text, _run_ranks
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step
from voicesplit_tpu_torch.train.checkpoint import list_checkpoints, load_checkpoint, restore_train_state
from voicesplit_tpu_torch.weights import init_random_

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dist_worker.py"
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp")
    (root / "config.json").write_text(_config_text())
    np.savez(root / "batch.npz", **_batch(2 * ROWS))
    config = load_config_from_str(_config_text())
    model = init_random_(make_masknet(config, device="cpu"), 0)
    torch.save(model.state_dict(), root / "weights.pt")
    return root


def _steps(setup, tmp_path, world, model_axis, tag):
    outs = [tmp_path / f"{tag}{r}.npz" for r in range(world)]
    _run_ranks(lambda r, port: [
        sys.executable, str(WORKER), str(r), str(world), str(port), "step", str(outs[r]),
        str(setup / "config.json"), str(setup / "weights.pt"), str(setup / "batch.npz"),
        "unfused", str(model_axis), str(STEPS)], world=world)
    return [dict(np.load(p)) for p in outs]


def _assert_same_bits(got: dict, want: dict, what: str) -> None:
    keys = [k for k in want if not k.startswith("grad/")]
    assert keys and all(k in got for k in keys), what
    for k in keys:
        assert np.array_equal(got[k], want[k]), f"{what}: {k}"


def test_one_by_two_equals_the_one_process_step(setup, tmp_path):
    """Two steps on a 1 x 2 mesh (both ranks hold all four rows and half of
    every split parameter) against two one-process steps in this process:
    loss, grad_norm, parameters, running statistics and Adam's moments bit
    for bit, on both ranks."""
    ranks = _steps(setup, tmp_path, 2, 2, "mp")
    config = load_config_from_str(_config_text())
    model = make_masknet(config, device="cpu")
    model.load_state_dict(torch.load(setup / "weights.pt"))
    optimizer = make_optimizer(config, model)
    state = create_train_state(model, optimizer)
    step = make_train_step(config, model, make_audio_processor(config, device="cpu"), optimizer)
    batch = dict(np.load(setup / "batch.npz"))
    for _ in range(STEPS):
        m = step(state, batch)
    want = {"loss": np.asarray(float(m["loss"])), "grad_norm": np.asarray(float(m["grad_norm"]))}
    want.update({f"after/{k}": v.numpy() for k, v in model.state_dict().items()})
    for i, (k, p) in enumerate(model.named_parameters()):
        want[f"exp_avg/{k}"] = optimizer.state[p]["exp_avg"].numpy()
        want[f"exp_avg_sq/{k}"] = optimizer.state[p]["exp_avg_sq"].numpy()
    for r, got in enumerate(ranks):
        _assert_same_bits(got, want, f"rank {r}")


def test_two_by_two_equals_the_two_rank_data_parallel_step(setup, tmp_path):
    """Two steps on a 2 x 2 mesh (4 ranks: the data groups {0, 2} and {1, 3}
    sum the BatchNorm statistics and the gradients, the model groups {0, 1}
    and {2, 3} gather the slices) against two steps on two data-parallel
    ranks: every rank's loss, parameters, running statistics and moments bit
    for bit rank 0's of the data-parallel run."""
    mp = _steps(setup, tmp_path, 4, 2, "mp")
    dp = _steps(setup, tmp_path, 2, 1, "dp")
    _assert_same_bits(dp[1], dp[0], "data-parallel ranks")
    for r, got in enumerate(mp):
        _assert_same_bits(got, dp[0], f"rank {r} of the 2 x 2 mesh")


def test_cli_model_parallel_in_two_processes(tmp_path):
    """`cli.train --model_parallel 2 --num_processes 2` for two steps: only
    rank 0 writes, and its checkpoint is the file of the one-process CLI run
    byte for byte; it restores into a one-process state."""
    from voicesplit_tpu_torch.cli import train as train_cli

    data = tmp_path / "data"
    build_synthetic_dataset(str(data), 8, audio_len=0.4, emb_dim=256, seed=0)
    text = json.loads(_config_text(summary_interval=1, check_interval=1, checkpoint_interval=1000))
    text["dataset"].update(train_dir=str(data), test_dir=str(data))
    config = tmp_path / "config.json"
    config.write_text(json.dumps(text))
    logs = [tmp_path / f"logs{r}" for r in range(2)]
    outs = _run_ranks(lambda r, port: [
        sys.executable, "-m", "voicesplit_tpu_torch.cli.train", "-c", str(config),
        "--logs_path", str(logs[r]), "--max_steps", "2", "--device", "cpu",
        "--coordinator", f"localhost:{port}", "--num_processes", "2", "--process_id", str(r),
        "--model_parallel", "2"])
    assert all("'step': 2" in out for out in outs), outs
    assert not logs[1].exists()
    (split_ckpt,) = list_checkpoints(str(logs[0]))
    assert pathlib.Path(split_ckpt).name == "checkpoint_2.pt"
    split_bytes = pathlib.Path(split_ckpt).read_bytes()
    cfg = load_config_from_str(json.dumps(text))
    model = make_masknet(cfg, device="cpu")
    state, _ = restore_train_state(load_checkpoint(split_ckpt),
                                   create_train_state(model, make_optimizer(cfg, model)))
    assert state.step == 2
    # one process over the same logs path (the checkpoint holds the config,
    # logs path included), with the ranks' two threads (the CPU's reductions
    # split their sums by thread)
    shutil.rmtree(logs[0])
    assert train_cli.main(["-c", str(config), "--logs_path", str(logs[0]), "--max_steps", "2",
                           "--device", "cpu"])["step"] == 2
    assert pathlib.Path(split_ckpt).read_bytes() == split_bytes
