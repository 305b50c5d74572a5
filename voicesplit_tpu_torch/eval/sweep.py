"""Checkpoint sweeps with best-checkpoint selection (counterpart of
`voicesplit_tpu/eval/sweep.py`).

Capability of reference `test_all_checkpoints.py:31-130` (full eval of
every checkpoint, tracking best-SDR and best-loss, copying
``best_checkpoint``, saving the SDR curve) and
`test_fast_all_checkpoints.py` (batched SI-SNR-only fast sweep), minus the
reference's `best_sdr`-NameError bug (`test_fast_all_checkpoints.py:121`,
not replicated).  It reads the port's ``checkpoint_<step>.pt`` files; the
copies it writes (``[fast_]best_checkpoint.pt``,
``[fast_]best_loss_checkpoint.pt``) lie outside that pattern, so a second
sweep of the same directory does not evaluate them.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np
from torch import nn

from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.data.dataset import BatchIterator
from voicesplit_tpu_torch.eval.validation import validate
from voicesplit_tpu_torch.train.checkpoint import (
    list_checkpoints,
    load_checkpoint,
    load_model_variables,
)


def sweep_checkpoints(
    checkpoint_dir: str,
    config: Config,
    model: nn.Module,
    eval_step,
    loader: BatchIterator,
    fast: bool = False,
    max_items: Optional[int] = None,
    out_dir: Optional[str] = None,
    sdr_backend: str = "auto",
) -> Dict:
    """Evaluate every checkpoint in `checkpoint_dir` with `eval_step`
    (`train.make_eval_step` over `model`, into which each checkpoint's
    weights and running statistics are loaded in turn).

    `fast=True` skips the SDR projection (SI-SNR only: the reference's
    "fast" sweep).  Copies ``best_checkpoint.pt`` (by SDR, or by SI-SNR in
    fast mode) and ``best_loss_checkpoint.pt`` (``fast_`` before each name
    in fast mode) into `out_dir` (default: `checkpoint_dir`), and saves the
    metric curve ``[step, metric]`` as ``[fast_]sdr_curve.npy``.  When every
    checkpoint scores NaN (a diverged run) it says so and copies nothing.
    """
    out_dir = out_dir or checkpoint_dir
    paths = list_checkpoints(checkpoint_dir)
    if not paths:
        raise FileNotFoundError(f"no checkpoints in {checkpoint_dir}")
    results: List[Dict] = []
    best_metric, best_path = -np.inf, None
    best_loss, best_loss_path = np.inf, None
    for path in paths:
        model.load_state_dict(load_model_variables(config, path))
        m = validate(
            eval_step, loader, max_items=max_items, compute_sdr=not fast, log_sample=False,
            sdr_backend=sdr_backend,
        )
        m["path"] = path
        m["step"] = int(load_checkpoint(path)["step"])
        results.append(m)
        key = m["si_snr"] if fast else m.get("sdr", m["si_snr"])
        if key > best_metric:
            best_metric, best_path = key, path
        if m["loss"] < best_loss:
            best_loss, best_loss_path = m["loss"], path

    prefix = "fast_" if fast else ""
    if best_path is None:
        # every checkpoint's metric was NaN (diverged run): report it
        # instead of failing on a copy of nothing after the whole sweep ran
        print(" ! sweep: all checkpoints scored NaN; no best checkpoint copied")
        return {
            "results": results,
            "best_path": None,
            "best_metric": float("nan"),
            "best_loss_path": best_loss_path,
            "best_loss": float(best_loss),
        }
    shutil.copyfile(best_path, os.path.join(out_dir, f"{prefix}best_checkpoint.pt"))
    if best_loss_path:
        shutil.copyfile(best_loss_path, os.path.join(out_dir, f"{prefix}best_loss_checkpoint.pt"))
    curve = np.array([[r["step"], r.get("sdr", r["si_snr"])] for r in results], dtype=np.float64)
    np.save(os.path.join(out_dir, f"{prefix}sdr_curve.npy"), curve)
    return {
        "results": results,
        "best_path": best_path,
        "best_metric": float(best_metric),
        "best_loss_path": best_loss_path,
        "best_loss": float(best_loss),
    }
