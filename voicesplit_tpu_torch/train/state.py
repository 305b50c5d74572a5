"""Train state and optimizer (counterpart of `voicesplit_tpu/train/state.py`).

The JAX package builds an optax chain; here the same update is
``torch.optim.Adam`` (or ``AdamW`` with two parameter groups when
``weight_decay`` is set) plus two pieces written out as optax computes
them, since PyTorch's own differ:

- the cosine schedule, ``lr·((1−α)·½(1+cos(π·min(n,N)/N)) + α)`` at update
  count n, starting from 0 (``optax.cosine_decay_schedule``);
- clipping by the global norm, scaling by ``max/‖g‖`` only when
  ``‖g‖ ≥ max`` (``optax.clip_by_global_norm``;
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional

import torch
from torch import nn

from voicesplit_tpu_torch.config import Config

# optax.adam / adamw defaults
BETAS = (0.9, 0.999)
EPS = 1e-8


@dataclass
class TrainState:
    """What a train step updates: the update count, the model (parameters
    and BatchNorm running statistics) and the optimizer (Adam moments).
    Under the gate split (`parallel.shard_train_state` with
    ``model_parallel``) `shards` holds this process's slices of the split
    parameters (`parallel.sharding.ModelShards`), which the optimizer steps,
    and the model's parameters are their gathered working copy."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    shards: Optional[Any] = None

    def gather_(self) -> None:
        """Bring the model's parameters up to date from the slices (a
        collective over the model group under the gate split; every rank of
        it must call it); nothing without the split."""
        if self.shards is not None:
            self.shards.gather_()


def decays(name: str) -> bool:
    """True for weight matrices (conv and dense kernels, LSTM weights); False
    for biases, BatchNorm scales and LSTM gate biases — the JAX package's
    ``_decay_mask`` rule, on the last part of the parameter's name."""
    leaf = name.rsplit(".", 1)[-1]
    return not (leaf.endswith("bias") or leaf == "scale" or leaf == "b" or leaf.endswith("_b"))


def make_optimizer(config: Config, model: nn.Module) -> torch.optim.Optimizer:
    """Adam over `model`'s parameters at the config's peak learning rate
    (the schedule is applied by the train step); AdamW with decay on the
    weight matrices only when ``weight_decay`` is set."""
    tc = config.train_config
    if tc.optimizer.lower() != "adam":
        raise ValueError(
            f"unsupported optimizer {tc.optimizer!r} (the reference supports adam only)"
        )
    named = list(model.named_parameters())
    if tc.weight_decay:
        groups = [
            {"params": [p for n, p in named if decays(n)], "weight_decay": tc.weight_decay},
            {"params": [p for n, p in named if not decays(n)], "weight_decay": 0.0},
        ]
        return torch.optim.AdamW(groups, lr=tc.learning_rate, betas=BETAS, eps=EPS)
    return make_adam([p for _, p in named], tc.learning_rate)


def make_adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)`` over `params`: its defaults; torch's update
    ``lr/(1−β1^n) · m / (sqrt(v)/sqrt(1−β2^n) + eps)`` is optax's
    ``lr · m̂ / (sqrt(v̂) + eps)``."""
    return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS)


def learning_rate(config: Config, count: int) -> float:
    """The learning rate of update number `count` (0 for the first)."""
    tc = config.train_config
    if not tc.lr_decay_steps:
        return tc.learning_rate
    n = min(count, tc.lr_decay_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * n / tc.lr_decay_steps))
    return tc.learning_rate * ((1.0 - tc.lr_decay_alpha) * cosine + tc.lr_decay_alpha)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all `tensors` (fp32), in two fused
    launches: the norm of each tensor, then the norm of those."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """``g ← g · max_norm / norm`` in place for every g, where ``norm ≥ max_norm``."""
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    """A fresh state: update count 0, `model` and `optimizer` as they are."""
    return TrainState(step=0, model=model, optimizer=optimizer)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
