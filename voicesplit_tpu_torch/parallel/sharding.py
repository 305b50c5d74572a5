"""Batch placement and the training state over the mesh (counterpart of
`voicesplit_tpu/parallel/sharding.py`).

**Data parallelism**: parameters, BatchNorm statistics and optimizer state are
replicated on every rank, and each rank's batch is its own rows of the
global batch (the loaders shard by data index, ``rank // model`` of
``data``).  The JAX package assembles a global array from the per-process
shards; here a rank's rows simply go to its own device, and the train step
sums over the data group (`parallel/mesh.py`).

**The gate split** (``model_parallel``, the wide variant's `_MODEL_RULES`):
the JAX package shards the LSTM gate columns, the conv output channels and
``fc1``'s input rows over the ``model`` axis and lets GSPMD split the
computation Megatron-style.  The port cannot split the computation so:
neither LSTM kernel takes a slice of W_hh's gate columns, a split recurrence
would all-gather h at each of its 301 steps, and the conv kernels take no
fewer than 64 output channels (`ops/conv_cuda.py::_check_kernel_takes`; the
chain's, multiples of 64), so the 64 of a layer split two ways would leave
each rank a width they refuse.  So the
port shards the **state** and replicates the **compute**, which keeps every
kernel launched and every number exact:

- each rank owns its slice of every `_MODEL_RULES` parameter and Adam's two
  moments of that slice (`ModelShards`);
- before the forward, each rank all-gathers its model group's slices into
  the module's full parameters (its working copy);
- each rank computes the step on its data row's batch, which every rank of
  its model group shares, as JAX's ``P("data")`` batch is replicated over
  ``model``;
- after the backward, the loss and gradients are averaged over the data
  group, the global norm and the clipping take the full gradient, and each
  rank keeps its slice of each split gradient and steps Adam on its slices.

A dimension of size n that the model axis does not divide is split as GSPMD
splits it: ``ceil(n / K)`` a shard, the last one shorter (or empty) and
padded inside the collective.  The exchange of the slices is an argument:
`GroupShardExchange` over the model group's ranks (one shard a rank), or
`InProcessShardExchange`, all K shards in one process (NCCL runs one rank a
device, so one card checks the split this way).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from voicesplit_tpu_torch.data.prefetch import to_device
from voicesplit_tpu_torch.parallel.mesh import Mesh, comm_device, group_active, rank

REPLICATED = "replicated"
ROWS = "rows"  # a batch leaf's leading axis: each rank holds its own rows

# the JAX package's `_MODEL_RULES` in the port's names and layouts: the
# dimension each parameter splits on over the model axis
_MODEL_RULES = [
    (r"lstm\.(fwd|bwd)_w_ih", 1),  # [in, 4H]: the gates
    (r"lstm\.(fwd|bwd)_w_hh", 1),  # [H, 4H]
    (r"lstm\.(fwd|bwd)_b", 0),  # [4H]
    (r"conv\d+\.conv\.weight", 0),  # OIHW: the output channels
    (r"conv\d+\.conv\.bias", 0),
    (r"conv\d+\.bn\.(scale|bias)", 0),
    (r"fc1\.weight", 1),  # [fc1, 2H]: the LSTM's features (JAX's kernel rows)
]

Placement = Union[int, str]


def param_partition_spec(model: nn.Module, model_parallel: bool) -> Dict[str, Placement]:
    """``{parameter name: placement}``: the dimension a parameter splits on
    over the model axis, or ``"replicated"``.  Data parallelism replicates
    every parameter; the gate split splits those of `_MODEL_RULES` (``fc1``'s
    bias, ``fc2`` and the BatchNorm running statistics stay replicated)."""
    def placement(name: str) -> Placement:
        if model_parallel:
            for pattern, dim in _MODEL_RULES:
                if re.fullmatch(pattern, name):
                    return dim
        return REPLICATED

    return {k: placement(k) for k, _ in model.named_parameters()}


def batch_sharding(mesh: Mesh, batch: Mapping[str, np.ndarray]) -> Dict[str, str]:
    """Leading-axis placement for every batch leaf."""
    return {k: ROWS for k in batch}


def put_batch(mesh: Mesh, batch: Mapping[str, np.ndarray],
              device: torch.device = torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """This rank's rows as tensors on its device: nothing crosses ranks."""
    return to_device(dict(batch), device)


def shard_bounds(size: int, index: int, n_shards: int) -> Tuple[int, int]:
    """``[start, stop)`` of shard `index` of `n_shards` over `size`, as GSPMD
    lays it: ``ceil(size / n_shards)`` a shard, the last ones shorter or
    empty."""
    chunk = -(-size // n_shards)
    start = min(size, index * chunk)
    return start, min(size, start + chunk)


def shard_of(t: torch.Tensor, dim: int, index: int, n_shards: int) -> torch.Tensor:
    """Shard `index` of `t` along `dim` (a view)."""
    start, stop = shard_bounds(t.shape[dim], index, n_shards)
    return t.narrow(dim, start, stop - start)


class GroupShardExchange:
    """The ranks of the mesh's model group as the shards, one a rank (shard
    index = model index)."""

    def __init__(self, mesh: Mesh):
        self.n_shards = mesh.model
        self.shards = (mesh.coords(rank())[1],)
        self.group = mesh.model_group

    def all_gather(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's flat buffer (all of one size), in shard order."""
        (buf,) = bufs
        out = [torch.empty_like(buf) for _ in range(self.n_shards)]
        dist.all_gather(out, buf, group=self.group)
        return out


class InProcessShardExchange:
    """All `n_shards` shards in this process, in order: the gate split of K
    ranks held by one (for one card, and for checks)."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.shards = tuple(range(n_shards))

    def all_gather(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return list(bufs)


class ModelShards:
    """This process's slices of the split parameters of `model` (one list a
    parameter, one `nn.Parameter` a shard it owns, in `exchange.shards`
    order) and the gathers and slicings of the gate split.  The module's own
    parameters are the gathered working copy; `stale` says that the slices
    moved since the last gather."""

    def __init__(self, model: nn.Module, spec: Mapping[str, Placement], exchange):
        self.exchange = exchange
        self.n_shards = exchange.n_shards
        self.params = dict(model.named_parameters())
        self.dims = {k: d for k, d in spec.items() if d != REPLICATED}
        self.owned: Dict[str, List[nn.Parameter]] = {
            k: [nn.Parameter(shard_of(self.params[k].detach(), d, s, self.n_shards).clone())
                for s in exchange.shards]
            for k, d in self.dims.items()
        }
        self.stale = False

    def _gather_into(self, parts: Mapping[str, Sequence[torch.Tensor]],
                     dims: Mapping[str, int], out: Mapping[str, torch.Tensor]) -> None:
        """Every shard's slices into the full tensors `out`: each owned
        shard's slices, zero-padded to the shard length where short and
        flattened into one buffer, go through one all-gather; each shard's
        part of a buffer is copied into its place in `out`."""
        bufs = []
        for pos in range(len(self.exchange.shards)):
            flat = []
            for k, d in dims.items():
                t = parts[k][pos]
                short = -(-out[k].shape[d] // self.n_shards) - t.shape[d]
                if short:
                    pad = list(t.shape)
                    pad[d] = short
                    t = torch.cat([t, t.new_zeros(pad)], d)
                flat.append(t.reshape(-1))
            bufs.append(torch.cat(flat))
        everyone = self.exchange.all_gather(bufs)
        offset = 0
        for k, d in dims.items():
            shape = list(out[k].shape)
            shape[d] = -(-shape[d] // self.n_shards)
            n = int(np.prod(shape))
            for s, buf in enumerate(everyone):
                start, stop = shard_bounds(out[k].shape[d], s, self.n_shards)
                if stop > start:
                    out[k].narrow(d, start, stop - start).copy_(
                        buf[offset:offset + n].view(shape).narrow(d, 0, stop - start))
            offset += n

    @torch.no_grad()
    def gather_(self) -> None:
        """The full parameters from every shard's slices, into the module
        (a collective over the model group when the slices moved since the
        last gather; every rank of the group must call it)."""
        if not self.stale:
            return
        self._gather_into({k: [p.detach() for p in ps] for k, ps in self.owned.items()},
                          self.dims, self.params)
        self.stale = False

    @torch.no_grad()
    def scatter_grads_(self) -> None:
        """Each owned slice's gradient cut from its full parameter's gradient,
        which is then dropped."""
        for k, d in self.dims.items():
            p = self.params[k]
            for s, shard in zip(self.exchange.shards, self.owned[k]):
                shard.grad = shard_of(p.grad, d, s, self.n_shards).clone(
                    memory_format=torch.contiguous_format)
            p.grad = None

    @torch.no_grad()
    def load_from_model_(self) -> None:
        """The owned slices from the module's (full) parameters."""
        for k, d in self.dims.items():
            for s, shard in zip(self.exchange.shards, self.owned[k]):
                shard.copy_(shard_of(self.params[k], d, s, self.n_shards))
        self.stale = False

    # -- the optimizer over the slices --------------------------------------

    def shard_optimizer(self, full: torch.optim.Optimizer) -> torch.optim.Optimizer:
        """An optimizer of `full`'s class, groups and settings over the owned
        slices (each split parameter replaced by its slices) and the
        replicated parameters, its state `full`'s sliced likewise (the
        update count unchanged), in `full`'s order."""
        name_of = {id(p): k for k, p in self.params.items()}
        groups, self.layout = [], []
        for g in full.param_groups:
            names = [name_of[id(p)] for p in g["params"]]
            self.layout.append(names)
            params = [q for k in names for q in self.owned.get(k, [self.params[k]])]
            groups.append({**{k: v for k, v in g.items() if k != "params"}, "params": params})
        opt = type(full)(groups)  # every group carries all of its settings
        opt.defaults = dict(full.defaults)
        for p, st in full.state.items():
            k = name_of[id(p)]
            if k not in self.dims:
                opt.state[p] = st
                continue
            for s, shard in zip(self.exchange.shards, self.owned[k]):
                opt.state[shard] = self._slice_state(k, st, s)
        return opt

    def _slice_state(self, name: str, st: dict, shard: Optional[int]) -> dict:
        """One parameter's optimizer state, its tensors of the parameter's
        rank (the moments) cut to `shard` (None: whole).  Every tensor is a
        copy of the shard's own: Adam counts its steps in place."""
        def cut(v):
            if not torch.is_tensor(v):
                return v
            if shard is not None and v.dim() == self.params[name].dim():
                return shard_of(v, self.dims[name], shard, self.n_shards).clone()
            return v.clone()

        return {sk: cut(v) for sk, v in st.items()}

    def _ids(self) -> Dict[str, Tuple[int, List[int]]]:
        """Each parameter's index in the one-process optimizer and its
        indices in the optimizer over the slices."""
        out, i, j = {}, 0, 0
        for names in self.layout:
            for k in names:
                n = len(self.owned.get(k, [None]))
                out[k] = (j, list(range(i, i + n)))
                i, j = i + n, j + 1
        return out

    def full_optimizer_state_dict(self, opt: torch.optim.Optimizer) -> dict:
        """`opt`'s state dict in the layout of the one-process optimizer over
        the module's parameters, and in its order: the moments of every
        split parameter gathered from every shard (a collective over the
        model group)."""
        sd = opt.state_dict()
        ids = self._ids()
        name_of = {i: k for k, (_, sharded) in ids.items() for i in sharded}
        order = list(dict.fromkeys(name_of[i] for i in sd["state"]))
        parts, dims = {}, {}
        for k in order:
            if k not in self.dims:
                continue
            sts = [sd["state"][i] for i in ids[k][1]]
            for sk, v in sts[0].items():
                if torch.is_tensor(v) and v.dim() == self.params[k].dim():
                    parts[f"{k}/{sk}"] = [st[sk] for st in sts]
                    dims[f"{k}/{sk}"] = self.dims[k]
        full = {key: torch.empty(self.params[key.split("/")[0]].shape, dtype=ps[0].dtype,
                                 device=ps[0].device) for key, ps in parts.items()}
        if parts:
            self._gather_into(parts, dims, full)
        state = {}
        for k in order:
            j, sharded = ids[k]
            first = sd["state"][sharded[0]]
            if k in self.dims:  # gathered moments; a copy of the rest (the step count)
                first = {sk: full.get(f"{k}/{sk}", v.clone() if torch.is_tensor(v) else v)
                         for sk, v in first.items()}
            state[j] = first
        groups = [{**{gk: v for gk, v in g.items() if gk != "params"},
                   "params": [ids[k][0] for k in names]}
                  for names, g in zip(self.layout, sd["param_groups"])]
        return {"state": state, "param_groups": groups}

    def load_full_optimizer_state_dict(self, opt: torch.optim.Optimizer, full_sd: dict) -> None:
        """Load a one-process optimizer state dict (a checkpoint's, or
        `full_optimizer_state_dict`'s) into `opt`, each split parameter's
        state sliced to the owned shards, in the loaded order."""
        ids = self._ids()
        name_of = {j: k for k, (j, _) in ids.items()}
        state = {}
        for j, st in full_sd["state"].items():
            k = name_of[j]
            shards = self.exchange.shards if k in self.dims else (None,)
            for i, s in zip(ids[k][1], shards):
                state[i] = self._slice_state(k, st, s)
        groups = [{**{gk: v for gk, v in g.items() if gk != "params"},
                   "params": [i for k in names for i in ids[k][1]]}
                  for names, g in zip(self.layout, full_sd["param_groups"])]
        opt.load_state_dict({"state": state, "param_groups": groups})

    def bytes(self, opt: torch.optim.Optimizer) -> dict:
        """Bytes of each shard this process holds (its slices and their
        optimizer state), of the replicated parameters and their optimizer
        state, and of the split parameters' gathered working copy."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        def state_of(ps):
            return [v for p in ps for v in opt.state.get(p, {}).values() if torch.is_tensor(v)]

        shards = []
        for pos in range(len(self.exchange.shards)):
            mine = [ps[pos] for ps in self.owned.values()]
            shards.append({"params": nbytes(mine), "optimizer_state": nbytes(state_of(mine))})
        replicated = [p for k, p in self.params.items() if k not in self.dims]
        return {
            "shards": shards,
            "replicated_params": nbytes(replicated),
            "replicated_optimizer_state": nbytes(state_of(replicated)),
            "working_copy": nbytes(self.params[k] for k in self.dims),
        }


def _state_tensors(state) -> list:
    """The replicated tensors of a `TrainState`: parameters, buffers (the
    BatchNorm running statistics) and the optimizer's per-parameter state."""
    out = [t for t in state.model.state_dict().values()]
    for per_param in state.optimizer.state.values():
        out += [v for v in per_param.values() if torch.is_tensor(v)]
    return out


def shard_train_state(state, mesh: Mesh, model_parallel: bool = False, exchange=None):
    """Place `state` on the mesh, in place: rank 0's parameters, running
    statistics and optimizer state are broadcast to every rank, then checked
    equal bit for bit (each rank's sum of the bits against rank 0's); the step
    counter must already agree.  Without a process group nothing is sent.

    With the gate split (``model_parallel`` or a mesh with ``model > 1``)
    each rank then keeps its slices of the split parameters (`ModelShards`,
    ``state.shards``) and the optimizer is rebuilt over them with its state
    sliced.  `exchange` holds the slices' shards: the model group's ranks by
    default, or an `InProcessShardExchange` of K shards in one process."""
    if group_active():
        _broadcast_state(state)
    if not (model_parallel or mesh.model > 1):
        return state
    if exchange is None:
        if mesh.model_group is None:
            raise ValueError(
                f"the gate split over a {mesh.data}x{mesh.model} mesh needs its ranks' process "
                "group (or an InProcessShardExchange)")
        exchange = GroupShardExchange(mesh)
    shards = ModelShards(state.model, param_partition_spec(state.model, True), exchange)
    state.optimizer = shards.shard_optimizer(state.optimizer)
    state.shards = shards
    return state


def _broadcast_state(state) -> None:
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


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """The wrapping sum of a tensor's bytes read as int64 words (the sum of
    zero-padded int8 bytes when the size is not a multiple of 8)."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    pad = (-b.numel()) % 8
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int64).sum()
