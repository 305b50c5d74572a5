"""The numbers that decide `correct`, each from the program's readings and
the reference's.

Training (the first three steps of the window's own step object), by the
worst leaf, each leaf's gap measured against the larger of the
reference's norm of that leaf and of the median leaf:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step, over 1 − β1): |‖program's‖ − ‖reference's‖|;
- ``change_gap``: |‖program's change‖ − ‖reference's change‖| over the
  three steps, BatchNorm running statistics included.

Parameters whose reference gradient is under a thousandth of the median
leaf's (conv biases ahead of a train-mode BatchNorm, which move under Adam
by round-off alone) are left out of both by that rule.  No cell of
``BENCHMARK.json`` trains yet (PERF.md says why); a training cell brings
its limits for these numbers in ``limits/<cell>.json``.

Serving: ``wave_gap``: for each checked row (a waveform of the window's
sampled calls), ‖program − reference‖ / ‖reference‖ over the same for the
reference computed in the configurations' bf16 (the error that the stated
precision itself makes on that row); the largest over the rows.  The
models' sensitivity to rounding differs from seed to seed by up to 5x, and
the ratio takes it out (PERF.md).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Set

import numpy as np

QUIET_GRAD = 1e-3


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Optional[Set[str]] = None) -> Dict[str, float]:
    """Each leaf's |program norm − reference norm| over the larger of the
    reference's norm of the leaf and of the median leaf."""
    keys = sorted(reference if leaves is None else leaves)
    median = statistics.median(reference[k] for k in keys)
    return {k: abs(program[k] - reference[k]) / max(reference[k], median) for k in keys}


def quiet_leaves(ref_grad: Dict[str, float]) -> Set[str]:
    median = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v < QUIET_GRAD * median}


def grad_gaps(program: Dict, reference: Dict) -> Dict[str, float]:
    """Per leaf, ‖program − reference‖ over the larger of the reference's
    norm of the leaf and of the median leaf (tensors by name), for a look
    at where a gap comes from."""
    import torch

    keys = sorted(reference)
    ref = torch.stack([torch.linalg.vector_norm(reference[k].float()) for k in keys])
    diff = torch.stack([torch.linalg.vector_norm(
        program[k].to(reference[k].device).float() - reference[k].float()) for k in keys])
    return dict(zip(keys, (diff / torch.clamp(ref, min=ref.median())).tolist()))


def grad_norms(grad: Dict) -> Dict[str, float]:
    import torch

    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in grad.items()}


def train_gaps(program: dict, reference: dict) -> Dict[str, Dict[str, float]]:
    """Each counted leaf's gap of norms, of the first gradient (``grad``)
    and of the change (``change``).  `program` and `reference`: ``losses``
    (a float a step), ``grad`` (tensors by leaf) and ``change`` (norms by
    leaf)."""
    ref_grad = grad_norms(reference["grad"])
    quiet = quiet_leaves(ref_grad)
    return {"grad": leaf_gaps(grad_norms(program["grad"]), ref_grad, set(ref_grad) - quiet),
            "change": leaf_gaps(program["change"], reference["change"],
                                set(reference["change"]) - quiet)}


def train_readings(program: dict, reference: dict) -> Dict[str, float]:
    gaps = train_gaps(program, reference)
    return {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(program["losses"], reference["losses"])),
        "grad_gap": max(gaps["grad"].values()),
        "change_gap": max(gaps["change"].values()),
    }


def row_gaps(program: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Rows of ``[N, L]``: each row's ‖program − reference‖ / ‖reference‖."""
    p, r = program.astype(np.float64), reference.astype(np.float64)
    return np.linalg.norm(p - r, axis=-1) / np.linalg.norm(r, axis=-1)


def wave_gap(program: np.ndarray, reference: np.ndarray, unit: np.ndarray) -> float:
    """The largest over the rows of the program's gap to the fp32 reference
    in units of the bf16 reference's gap to it on the same row."""
    return float(np.max(row_gaps(program, reference)
                        / np.maximum(row_gaps(unit, reference), 1e-7)))


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """Each number beside its limit; a missing or non-finite number fails."""
    return [{"name": k, "value": readings.get(k, float("nan")), "limit": limits[k],
             "ok": bool(np.isfinite(readings.get(k, float("nan")))
                        and readings[k] <= limits[k])}
            for k in sorted(limits)]
