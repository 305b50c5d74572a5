"""A cell cut to a size that the CPU runs in seconds, for the tests: the
same files, the same run loops and limits, a short clip, narrow DSP and
LSTM, and few iterations.  A cell that ``BENCHMARK.json`` does not list
(the training cells, PERF.md says why) is read by its files, with the
limits given here."""

from __future__ import annotations

import copy
from typing import Optional

import harness

# for the training cells' run loop and check at the tiny size in fp32, where
# the program and the reference agree to rounding (test_train_step_agrees_in_fp32)
TRAIN_TEST_LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.05, "change_gap": 0.05}


def tiny_cell(name: str, batch: int = 2, compute_dtype: str = "bfloat16",
              limits: Optional[dict] = None) -> harness.Cell:
    try:
        cell = harness.Cell(name)
    except KeyError:
        cell = harness.Cell.unlisted(name)
    if limits is not None:
        cell.limits = dict(limits)
    harness.set_environment(cell)
    c = copy.deepcopy(cell.config)
    c["audio"]["voicefilter"].update(n_fft=64, hop_length=16, win_length=32, num_freq=33)
    c["model"].update(emb_dim=16, lstm_dim=16, fc1_dim=24, fc2_dim=33)
    c["train_config"]["compute_dtype"] = compute_dtype
    cell.config = c
    cell.traffic = dict(cell.traffic, clip_s=0.03, batch=batch, batches=4, trace_steps=2,
                        trace_calls=3, trace_skip=1, warmup_calls=1, warmup_steps=1,
                        keep_every=1)
    return cell
