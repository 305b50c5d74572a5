"""One rank of the port's data-parallel tests (`tests/test_torch_distributed.py`).

Joins a gloo process group of CPU ranks through
`voicesplit_tpu_torch.parallel.initialize_distributed` and imports nothing of
JAX.  Modes:

- ``step OUT CONFIG WEIGHTS BATCH ROUTE [MODEL STEPS]``: train steps on this
  rank's rows of the batch, from the weights file on rank 0 and from other
  weights elsewhere (the broadcast replaces them), over a ``(world / MODEL,
  MODEL)`` mesh (default 1: data parallel; MODEL > 1 splits the gates, and
  the ranks of a model group share their rows): the batch is cut into one
  equal slice a data row.  Writes the last step's loss and grad_norm, the
  gradients the optimizer took (data parallel only), the running statistics
  and parameters after the steps, and Adam's moments in the one-process
  layout to ``OUT`` (``.npz``).  ``ROUTE`` is ``unfused`` or ``fused_chain``;
  STEPS (default 1) repeats the batch.
- ``preempt OUT CONFIG LOGS``: `Trainer.fit` for up to 20 steps with a
  preemption requested on rank 0 only; writes the step it stopped at.

Usage: python torch_dist_worker.py RANK WORLD PORT MODE ...
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(2)

rank, world, port, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
args = sys.argv[5:]

from voicesplit_tpu_torch.config import load_config_from_str  # noqa: E402
from voicesplit_tpu_torch.parallel import initialize_distributed, make_mesh  # noqa: E402

initialize_distributed(f"localhost:{port}", world, rank, device="cpu")


def step_mode(out, config_path, weights_path, batch_path, route, model_axis="1", steps="1"):
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.parallel import shard_train_state
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step
    from voicesplit_tpu_torch.train.checkpoint import optimizer_state_dict
    from voicesplit_tpu_torch.weights import init_random_

    os.environ["VOICESPLIT_FUSED_CHAIN"] = "1" if route == "fused_chain" else "0"
    config = load_config_from_str(open(config_path).read())
    model = make_masknet(config, device="cpu")
    if rank == 0:
        model.load_state_dict(torch.load(weights_path))
    else:
        init_random_(model, seed=100 + rank)  # replaced by rank 0's
    ap = make_audio_processor(config, device="cpu")
    mesh = make_mesh(model=int(model_axis))
    state = shard_train_state(create_train_state(model, make_optimizer(config, model)), mesh)
    batch = dict(np.load(batch_path))
    row = mesh.coords(rank)[0]
    rows = len(batch["mixed_wav"]) // mesh.data
    mine = {k: v[row * rows:(row + 1) * rows] for k, v in batch.items()}
    step = make_train_step(config, model, ap, state.optimizer)
    for _ in range(int(steps)):
        m = step(state, mine)
    params = dict(model.named_parameters())
    arrays = {} if state.shards else {f"grad/{k}": p.grad.numpy() for k, p in params.items()}
    opt = optimizer_state_dict(state)  # gathers the moments under the split
    state.gather_()
    arrays.update({f"after/{k}": v.numpy() for k, v in model.state_dict().items()})
    for i, k in enumerate(params):
        for key in ("exp_avg", "exp_avg_sq"):
            arrays[f"{key}/{k}"] = opt["state"][i][key].numpy()
    np.savez(out, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), **arrays)


def preempt_mode(out, config_path, logs):
    from voicesplit_tpu_torch.train.trainer import Trainer

    config = load_config_from_str(open(config_path).read())
    tr = Trainer(config, log_dir=logs, enable_tb=False, prefetch_depth=0,
                 async_checkpoint=False, device="cpu")
    if rank == 0:
        tr.request_preemption()  # rank 1 can stop only through the agreement
    try:
        res = tr.fit(max_steps=20, validate_at_epoch_start=False)
    finally:
        tr.close()
    with open(out, "w") as f:
        json.dump({"step": res.get("step"), "preempted": bool(res.get("preempted"))}, f)


{"step": step_mode, "preempt": preempt_mode}[mode](*args)
torch.distributed.destroy_process_group()
print(f"RANK {rank} DONE", flush=True)
