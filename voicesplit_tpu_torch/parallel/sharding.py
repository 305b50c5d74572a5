"""Batch placement and the replicated training state (counterpart of the
data-parallel half of `voicesplit_tpu/parallel/sharding.py`).

Data parallelism: parameters, BatchNorm statistics and optimizer state are
replicated on every rank, and each rank's batch is its own rows of the
global batch (the loaders shard by ``shard_id=rank, num_shards=world``).
The JAX package assembles a global array from the per-process shards; here a
rank's rows simply go to its own device, and the train step sums over ranks
(`parallel/mesh.py`).

The model-parallel half (the wide variant's gate split, `_MODEL_RULES` there)
is not yet ported: ``model_parallel=True`` raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.distributed as dist

from voicesplit_tpu_torch.data.prefetch import to_device
from voicesplit_tpu_torch.parallel.mesh import Mesh, comm_device, group_active, rank

REPLICATED = "replicated"
ROWS = "rows"  # a batch leaf's leading axis: each rank holds its own rows


def param_partition_spec(model: torch.nn.Module, model_parallel: bool) -> Dict[str, str]:
    """``{parameter name: placement}``; data parallelism replicates every
    parameter."""
    if model_parallel:
        raise NotImplementedError("model_parallel=True (the gate split) is not yet ported")
    return {k: REPLICATED for k, _ in model.named_parameters()}


def batch_sharding(mesh: Mesh, batch: Mapping[str, np.ndarray]) -> Dict[str, str]:
    """Leading-axis placement for every batch leaf."""
    return {k: ROWS for k in batch}


def put_batch(mesh: Mesh, batch: Mapping[str, np.ndarray],
              device: torch.device = torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """This rank's rows as tensors on its device: nothing crosses ranks."""
    return to_device(dict(batch), device)


def _state_tensors(state) -> list:
    """The replicated tensors of a `TrainState`: parameters, buffers (the
    BatchNorm running statistics) and the optimizer's per-parameter state."""
    out = [t for t in state.model.state_dict().values()]
    for per_param in state.optimizer.state.values():
        out += [v for v in per_param.values() if torch.is_tensor(v)]
    return out


def shard_train_state(state, mesh: Mesh, model_parallel: bool = False):
    """Replicate `state` over the ranks: rank 0's parameters, running
    statistics and optimizer state are broadcast to every rank, in place,
    then checked equal bit for bit (each rank's sum of the bits against
    rank 0's); the step counter must already agree.  Without a process
    group the state is returned as it is."""
    param_partition_spec(state.model, model_parallel or mesh.model > 1)  # raises for the gate split
    if not group_active():
        return state
    dev = comm_device()
    step = torch.tensor([state.step], dtype=torch.int64, device=dev)
    steps = [torch.empty_like(step) for _ in range(dist.get_world_size())]
    dist.all_gather(steps, step)
    if len({int(s) for s in steps}) != 1:
        raise ValueError(f"ranks start at different steps: {[int(s) for s in steps]}")
    tensors = _state_tensors(state)
    with torch.no_grad():
        for t in tensors:
            # Adam keeps its step counts on the CPU even for parameters on a card
            moved = t.to(dev)
            dist.broadcast(moved, src=0)
            if moved is not t:
                t.copy_(moved)
        bits = torch.stack([_checksum(t.to(dev)) for t in tensors])
        want = bits.clone()
        dist.broadcast(want, src=0)
    if not torch.equal(bits, want):
        raise RuntimeError(f"rank {rank()}: replicated state differs from rank 0's after broadcast")
    return state


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """The wrapping sum of a tensor's bytes read as int64 words (the sum of
    zero-padded int8 bytes when the size is not a multiple of 8)."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    pad = (-b.numel()) % 8
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int64).sum()
