"""Profiling and speed-of-light accounting on the card (counterpart of
`voicesplit_tpu/utils/profiling.py`).

The program's spans (`span`), a `torch.profiler` exporter (`trace`), a
synchronized timing harness with warm-up, and the analytic FLOP / byte
count of the mask network's train step, so that measured step times can be
set against the hardware bound.

`span(name)` marks a layer boundary of the serving call and the train step
(``voicesplit.separate_batch``, ``voicesplit.wav2spec``, ...).  While
`torch.profiler` records, it is a `record_function` range: a
``user_annotation`` event of the Chrome trace on the profiler's one clock,
beside the card's kernels; otherwise it costs one check of a flag.

Peaks are the NVIDIA H100 SXM's (NVIDIA's data sheet; dense, no sparsity):
3.35 TB/s of HBM3, 989 TFLOP/s in bf16 on the tensor cores and 67 TFLOP/s in
fp32 outside them, at the 700 W power limit (a card set lower runs slower
under load).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

# NVIDIA H100 SXM data sheet: dense peaks, no sparsity
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS}

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("voicesplit.<layer>"):`` — a `torch.profiler.record_function`
    range while the profiler records, outside `torch.compile` and
    `torch.export` tracing; otherwise a shared null context.  The profiler's
    flag is read on each call: an unguarded range costs microseconds even
    with no profiler."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(
    fn: Callable,
    *args,
    n_warmup: int = 2,
    n_iters: int = 10,
    sync: Optional[Callable] = None,
    **kwargs,
) -> Dict[str, float]:
    """Median / best / mean wall time of `fn(*args)`, each call followed by
    `sync(result)` (default: `torch.cuda.synchronize` once the card is in
    use), after `n_warmup` calls."""
    sync = sync or (lambda res: _synchronize())
    for _ in range(n_warmup):
        sync(fn(*args, **kwargs))
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {
        "median_s": float(np.median(times)),
        "best_s": float(np.min(times)),
        "mean_s": float(np.mean(times)),
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir):`` — a `torch.profiler` trace of the host and, with
    a card, its kernels, written to ``dir/trace.json`` (Chrome trace format,
    for Perfetto or ``chrome://tracing``).  The program's spans (`span`)
    appear in it on the same timeline as the operators and kernels they
    enclose."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class StepCost:
    flops: float
    hbm_bytes: float

    def speed_of_light_s(
        self,
        flops_per_s: float = BF16_FLOPS,
        bytes_per_s: float = HBM_BYTES_PER_S,
    ) -> float:
        return max(self.flops / flops_per_s, self.hbm_bytes / bytes_per_s)

    def mfu(self, measured_s: float, flops_per_s: float = BF16_FLOPS) -> float:
        return self.flops / (measured_s * flops_per_s)


def masknet_train_step_cost(
    batch: int,
    frames: int,
    num_freq: int = 601,
    conv_channels: int = 64,
    conv_out: int = 8,
    lstm_dim: int = 400,
    fc1: int = 600,
    emb: int = 256,
    n_fft: int = 1200,
    bytes_per_el: int = 2,
) -> StepCost:
    """Analytic FLOP / byte count of one forward + backward mask-net step
    (the 3x-forward rule), the JAX module's formula: the 5 dilated 5x5
    convs and the BiLSTM input projection dominate; the STFT / iSTFT basis
    matmuls are included."""
    B, T, F, C = batch, frames, num_freq, conv_channels
    conv_flops = 0.0
    # cnn1 1x7 (in 1), cnn2 7x1, cnn3-7 5x5, cnn8 1x1 -> 8
    conv_flops += 2 * B * T * F * 7 * 1 * C  # cnn1
    conv_flops += 2 * B * T * F * 7 * C * C  # cnn2
    conv_flops += 5 * (2 * B * T * F * 25 * C * C)  # cnn3-7
    conv_flops += 2 * B * T * F * C * conv_out  # cnn8
    lstm_in = conv_out * F + emb
    lstm_flops = 2 * (  # two directions
        2 * B * T * lstm_in * 4 * lstm_dim + 2 * B * T * lstm_dim * 4 * lstm_dim
    )
    fc_flops = 2 * B * T * (2 * lstm_dim) * fc1 + 2 * B * T * fc1 * F
    dsp_flops = 4 * (2 * B * T * n_fft * (2 * F))  # 2 STFT + 2 iSTFT matmuls
    fwd = conv_flops + lstm_flops + fc_flops + dsp_flops
    flops = 3.0 * fwd  # forward + backward ~ 3 forwards

    # device-memory traffic: activations written forward, read backward
    act_els = B * T * F * (C * 8 + conv_out + 4)  # conv stack + masks / specs
    act_els += B * T * (2 * lstm_dim + fc1 + 8 * lstm_dim)
    hbm = 3 * act_els * bytes_per_el
    return StepCost(flops=flops, hbm_bytes=hbm)
