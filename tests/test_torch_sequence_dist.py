"""Sequence-parallel separation over gloo CPU ranks: `separate_long` with the
time axis over 2 and 3 spawned ranks (`tests/torch_seq_worker.py`, no JAX)
against the same shards run in one process and the one-device pass.

The halos and the LSTM carries cross between the ranks point to point
(`batch_isend_irecv`), the masks are all-gathered; every rank returns the
whole waveform.  fp32 at `tests/test_torch_sequence_parallel.py`'s widths.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.config import Config, load_config_from_str
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.parallel.sequence import InProcessExchange, pad_frames, separate_long

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_seq_worker.py"
SR = 16000
TIMEOUT = 300  # seconds a worker may take


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_match_one_process(world, tmp_path):
    c = Config()
    c.model_name = "voicesplit"
    c.model.lstm_dim, c.model.fc1_dim = 24, 32
    c.model.conv_channels, c.model.conv_out_channels = 4, 2
    c.train_config.compute_dtype = "float32"
    config = load_config_from_str(c.to_json())
    (tmp_path / "config.json").write_text(c.to_json())
    model = weights.init_random_(make_masknet(config, device="cpu"), world)
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    rng = np.random.default_rng(world)
    wav = (0.1 * rng.standard_normal(int(SR * 2.5))).astype(np.float32)  # 251 frames
    emb = rng.standard_normal(256).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", wav=wav, emb=emb)

    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "2"}
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(port), str(outs[r]),
         str(tmp_path / "config.json"), str(tmp_path / "weights.pt"), str(tmp_path / "inputs.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO))
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    got = [np.load(o) for o in outs]

    in_process = separate_long(config, model, wav, emb, mesh=InProcessExchange(world))
    one_device = separate_long(config, model, wav, emb)
    Tc = pad_frames(251, world, model.conv_context_left) // world
    for r, g in enumerate(got):
        # each rank: the same shard operations as the in-process run, its
        # K relay scans a direction over its valid frames
        assert np.array_equal(g["wav"], in_process), f"rank {r}"
        valid = min(max(251 - r * Tc, 0), Tc)
        assert list(g["lstm_fwd_frames"]) == [valid] * (2 * world)
    np.testing.assert_allclose(got[0]["wav"], one_device, atol=1e-5)
