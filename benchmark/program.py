"""The system under test: the PyTorch and CUDA port, `voicesplit_tpu_torch`.

The only module of the benchmark that imports the program.  It builds the
program's objects from a configuration dictionary and the state that the
benchmark made, through the program's own entry points:

- training: `models/masknet.py::make_masknet` in train mode,
  `train/state.py::make_optimizer` and `create_train_state`, and
  `train/steps.py::make_train_step`, the step that `Trainer.fit` runs;
- serving: the eval-mode model and `cli/separate.py::separate_batch`, the
  CLI's separation call.

Every switch of the program that a cell sets (`VOICESPLIT_FUSED_CHAIN`,
`VOICESPLIT_PALLAS_CONV`, ...) is in the environment before this module is
imported.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

from voicesplit_tpu_torch.cli.separate import separate_batch
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.train.state import create_train_state, make_optimizer
from voicesplit_tpu_torch.train.steps import make_train_step


def _model(config: dict, state: Dict[str, torch.Tensor], device):
    cfg = load_config_from_str(json.dumps(config))
    model = make_masknet(cfg, device=device)
    model.load_state_dict(state)
    return cfg, model


class Trainer:
    """One train step object, with its model and Adam state; `step(batch)`
    is the call that both the first steps and the window drive."""

    def __init__(self, config: dict, state: Dict[str, torch.Tensor], device):
        cfg, self.model = _model(config, state, device)
        self.model.train()
        ap = make_audio_processor(cfg, device=device)
        self.optimizer = make_optimizer(cfg, self.model)
        self.state = create_train_state(self.model, self.optimizer)
        self._step = make_train_step(cfg, self.model, ap, self.optimizer)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self._step(self.state, batch)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The model's parameters and BatchNorm running statistics."""
        return dict(self.model.state_dict())

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Adam's first moment of every parameter, by name."""
        st = self.optimizer.state
        return {n: st[p]["exp_avg"] for n, p in self.model.named_parameters() if p in st}


class Separator:
    """The eval-mode model; `__call__(mixed, emb)` is the CLI's call."""

    def __init__(self, config: dict, state: Dict[str, torch.Tensor], device):
        cfg, self.model = _model(config, state, device)
        self.ap = make_audio_processor(cfg, device=device)

    def __call__(self, mixed: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        return separate_batch(self.model, self.ap, mixed, emb)
