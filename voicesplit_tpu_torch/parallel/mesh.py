"""Ranks, the process group and the sum over ranks (counterpart of
`voicesplit_tpu/parallel/mesh.py`).

The JAX package lays a ``(data, model)`` mesh over its devices and lets XLA
insert the collectives; here each process drives one device (a CUDA card or
the CPU) and the ranks of `torch.distributed`'s default group are the mesh.
Data parallelism is global-batch: every rank holds the same parameters, feeds
its own rows, and the train step sums over ranks what the one-device step
sums over the batch:

- the train-mode BatchNorm statistics and their backward sums
  (`ops/bn_act.py`, `ops/conv_fused.py`), so every rank normalizes with the
  whole global batch's mean and variance, as flax's BatchNorm does under
  ``jit`` over a data-sharded batch;
- the gradients and the loss (`train/steps.py`).

Each goes through `sum_over_ranks_`: one packed fp32 buffer a call, summed by
the collective (no float atomics), and nothing at all when no process group
is initialized.  In a world of one the sum is the buffer itself, so a step
gives the bits of the step without a group.

A mesh with a model axis (``model > 1``, the gate split of
`parallel/sharding.py`) lays rank ``r`` at ``(r // model, r % model)``, as
the JAX package's ``reshape(data, model)`` of its devices does, and gives each
rank two sub-groups: its **data group** (the ranks of its model index, one a
data row) and its **model group** (the ranks of its data row).  The ranks of a
model group hold the same rows, so the sums above run over the data group
only: over the world they would count each row ``model`` times.
`make_mesh` makes the groups (every rank must call it, in the same order) and
makes the data group the one that `sum_over_ranks_` sums over by default;
without a model axis that is the whole world.

`initialize_distributed` starts the group: gloo for ranks on the CPU, NCCL
for ranks on a CUDA card.  Nothing tells a process of its cluster, so the
caller names the coordinator (``host:port``), the world size and the rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from voicesplit_tpu_torch.device import DeviceLike, resolve_device


def group_active() -> bool:
    """True once a default process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if group_active() else 1


def rank() -> int:
    return dist.get_rank() if group_active() else 0


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, else the CPU."""
    if group_active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# the data group of the mesh made last (`make_mesh`); None is the whole world
_data_group: Any = None


def sum_over_ranks_(buf: torch.Tensor, group: Any = None) -> int:
    """Sums `buf` (one contiguous tensor) in place over the ranks of `group`
    (by default the data group of the mesh made last: the whole world unless
    that mesh has a model axis) and returns the group's size; with no process
    group it leaves `buf` alone and returns 1."""
    if not group_active():
        return 1
    group = _data_group if group is None else group
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return dist.get_world_size(group)


@dataclass(frozen=True)
class Mesh:
    """``data`` × ``model`` ranks; `ranks` in row-major order.  Under a
    process group with ``model > 1``, `data_group` and `model_group` are this
    rank's sub-groups (else None: the world, and no model group)."""

    data: int
    model: int
    ranks: Tuple[int, ...]
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def coords(self, r: int) -> Tuple[int, int]:
        """``(data index, model index)`` of rank `r`."""
        i = self.ranks.index(r)
        return i // self.model, i % self.model


def make_mesh(data: Optional[int] = None, model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh of shape ``(data, model)`` over `ranks` (default: every rank of
    the process group, or the one process); ``data=None`` takes all the
    ranks that `model` leaves.  Under a process group a mesh over every rank
    becomes the one whose data group the sums of a train step run over; with
    ``model > 1`` it makes its sub-groups, so every rank must call it."""
    global _data_group
    ranks = tuple(range(world_size()) if ranks is None else ranks)
    n = len(ranks)
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    if not (group_active() and ranks == tuple(range(world_size()))):
        return Mesh(data, model, ranks)
    data_group = model_group = None
    if model > 1:
        d_me, m_me = divmod(rank(), model)
        # every rank makes every group, in one order
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == m_me:
                data_group = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == d_me:
                model_group = g
    _data_group = data_group
    return Mesh(data, model, ranks, data_group, model_group)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """Start the default process group; returns whether it did.

    A no-op for one process unless a coordinator is named: ``num_processes``
    of 1 with a coordinator starts a world of one, whose collectives run but
    sum nothing.  The backend follows `device` (the CUDA card unless the CPU
    is named): NCCL on a card, gloo on the CPU.  Call it before anything
    touches the device."""
    n = num_processes or 1
    if n == 1 and not coordinator_address:
        return False
    if not coordinator_address or process_id is None:
        raise ValueError("several processes need coordinator_address and process_id")
    if not 0 <= process_id < n:
        raise ValueError(f"process_id {process_id} not in [0, {n})")
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":  # one card a process
        torch.cuda.set_device(dev.index if dev.index is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=n, rank=process_id)
    global _data_group
    _data_group = None  # a new world: no mesh yet
    return True


def local_batch_size(global_batch: int, mesh: Optional[Mesh] = None) -> int:
    """Per-process batch for process-sharded feeding: the global batch over
    the mesh's data axis (the ranks of a model group share their rows), or
    over every process without a mesh."""
    n = mesh.data if mesh is not None else max(1, world_size())
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} data rows")
    return global_batch // n
