"""Training: optimizer and state, train/eval steps, EMA (counterpart of
`voicesplit_tpu/train`).  The `Trainer` is in `train.trainer`, checkpoints in
`train.checkpoint`; they are imported from there, since they pull in the
data and evaluation modules."""

from voicesplit_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    learning_rate,
    make_optimizer,
    param_count,
)
from voicesplit_tpu_torch.train.steps import (
    make_ema_update,
    make_eval_step,
    make_multi_train_step,
    make_train_step,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "learning_rate",
    "make_ema_update",
    "make_eval_step",
    "make_multi_train_step",
    "make_optimizer",
    "make_train_step",
    "param_count",
]
