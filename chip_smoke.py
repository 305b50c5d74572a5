#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's serving and training paths
(NVIDIA H100).

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases, each printing one JSON line:

1. device   — the card's name and power limit (``nvidia-smi``).
2. build    — compiles every `voicesplit_tpu_torch/csrc/*.cu` with nvcc for
   sm_90a into ``build/`` (one nvcc per source, all at once) and prints
   ``ptxas -v`` (registers, shared memory, spills) and each kernel's grid.
3. kernels  — at H=400, T=301 holds each kernel against its plain PyTorch
   version on the card, in bf16 and fp32 operands: ``lstm_fwd`` (B=1,
   random h0/c0; hs, cs, gates, final (h, c)), ``bilstm_fwd`` (B=8),
   ``lstm_bwd`` (B=2, random dhs, dhf, dcf; dxp, dW_hh, dh0, dc0) and
   ``bilstm_bwd`` (B=8; dxp, both dW_hh).  Then times kernel, plain version
   and a cuDNN ``torch.nn.LSTM`` yardstick (its forward, or its
   ``.backward()`` alone after a forward; both also cover the input
   projection, which the kernels leave to a matmul).
4. separate — builds the full-width `configs/voicesplit.json` model (bf16)
   with weights made from ``--seed``, zeroes the launch counters, runs
   `separate_batch` at B=1 and at B=8 on 3 s synthetic mixtures, reads the
   counters, and checks the output (48000 finite samples, mask in [0, 1],
   agreement with the same model run through the plain LSTM versions on
   the card, and an unnormalized STFT→iSTFT round trip of the mixture).
   Prints the steady-state latency per batch (median and p75 of 40 calls)
   and audio-seconds per second.
5. train    — the same model and config (si_snr loss, Adam; learning rate
   1e-3, see TRAIN_LR) in train mode, weights from ``--seed``, synthetic 3 s batches at B=2 (the config's
   batch; BiLSTM via ``lstm_fwd``/``lstm_bwd`` twice) and B=8 (one
   ``bilstm_fwd``/``bilstm_bwd``).  For each: zeroes the launch counters,
   runs one `make_train_step` step, reads the counters (exactly the
   kernels' launches per step), checks a finite loss, grad_norm > 0 and
   that every parameter and BatchNorm running statistic moved; then runs
   the same step from the same weights through the plain LSTM versions on
   the card and compares loss, grad_norm and the LSTM weights' gradients;
   then prints the step time (p50, p75 of 20 synchronized steps after 3
   warm ones), audio-seconds per second of training, the losses (which
   must fall on the fixed batch) and gradient norms of those steps and
   the peak device memory.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit line
and, last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is non-zero and no result line is printed.  It also exits
non-zero without a card, or without the rest of the repository beside it.
``--profile DIR`` additionally writes a ``torch.profiler`` kernel table and
trace of the serving runs and the train steps into DIR and reports the
device's idle share under the profiler and the device time by kind of
kernel.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_FRAMES, HIDDEN, IN_FEATURES = 301, 400, 8 * 601 + 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 CUDA cores
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# bf16: a different summation order can flip one bf16 rounding of h (or, in
# the backward, of dgates), which then carries through the recurrence; fp32
# (TF32 off) differs by order only.  The backward's errors are taken
# relative to each output's largest magnitude (gradients grow over the
# reverse walk), the forward's are absolute (|h|, |c|, gates <~ 1).
SEPARATE_TOL = 5e-2  # mask and peak-relative waveform error, kernel vs plain LSTM (bf16)
ROUNDTRIP_MIN_SNR_DB = 60.0
LATENCY_CALLS = 40  # p75 is then the highest percentile with ten calls beyond it
TRAIN_WARM, TRAIN_STEPS = 3, 20
# learning rate of the train phase: the JAX package's own training test's
# (tests/test_train.py).  At the config's 1e-2 the sigmoid mask of the
# random-weight model saturates after Adam's first step (measured on the
# card: grad norm 27 at the first step, 4e-6 by the fifth), so the loss
# could not show that training moves it.
TRAIN_LR = 1e-3
# one train step through the kernels vs through the plain LSTM versions, bf16
# model: the forward's bf16 roundings that fall the other way (mask error
# ~5e-4 in serving) and the backward's move loss, grad_norm and gradients
TRAIN_TOL = {"loss_rel": 5e-3, "grad_norm_rel": 2e-2, "lstm_grad_peak_rel": 5e-2}
TRAIN_LAUNCHES = {  # kernel launches per train step, by batch
    2: {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 2, "bilstm_bwd": 0},
    8: {"lstm_fwd": 0, "bilstm_fwd": 1, "lstm_bwd": 0, "bilstm_bwd": 1},
}
REPLACES = {
    "lstm_fwd": "voicesplit_tpu/ops/lstm_pallas.py:71",
    "bilstm_fwd": "voicesplit_tpu/ops/lstm_pallas.py:251",
    "lstm_bwd": "voicesplit_tpu/ops/lstm_pallas.py:135",
    "bilstm_bwd": "voicesplit_tpu/ops/lstm_pallas.py:317",
}
SOURCES = {
    "lstm_fwd": "voicesplit_tpu_torch/csrc/lstm_fwd.cu",
    "bilstm_fwd": "voicesplit_tpu_torch/csrc/lstm_fwd.cu",
    "lstm_bwd": "voicesplit_tpu_torch/csrc/lstm_bwd.cu",
    "bilstm_bwd": "voicesplit_tpu_torch/csrc/lstm_bwd.cu",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time per call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def lstm_bound(directions: int, batch: int, dtype: str) -> dict:
    """Least time for the recurrence: each input byte read once, each output
    byte written once, and the recurrent products at the operand type's
    peak."""
    T, H, R = T_FRAMES, HIDDEN, directions * batch
    op_bytes = 2 if dtype == "bfloat16" else 4
    bytes_ = (
        T * R * 4 * H * op_bytes  # xp
        + directions * H * 4 * H * op_bytes  # W_hh
        + (2 * R * H * 4 if directions == 1 else 0)  # h0, c0
        + 2 * T * R * H * 4  # hs, cs
        + T * R * 4 * H * 4  # gates
    )
    flops = 2 * T * R * H * 4 * H
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {
        "bytes": bytes_,
        "flops": flops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def lstm_bwd_bound(directions: int, batch: int, dtype: str) -> dict:
    """The same for the backward: W_hh, gates, cs, hs, dhs (and h0, c0, dhf,
    dcf for one direction) read once, dxp, dW_hh (and dh0, dc0) written
    once, and both products (dh_prev and dW_hh) at the operand type's peak."""
    T, H, R = T_FRAMES, HIDDEN, directions * batch
    op_bytes = 2 if dtype == "bfloat16" else 4
    bytes_ = (
        directions * H * 4 * H * op_bytes  # W_hh
        + T * R * 4 * H * 4  # gates
        + 3 * T * R * H * 4  # cs, hs, dhs
        + (6 * R * H * 4 if directions == 1 else 0)  # h0, c0, dhf, dcf, dh0, dc0
        + T * R * 4 * H * op_bytes  # dxp
        + directions * H * 4 * H * 4  # dW_hh
    )
    flops = 2 * 2 * T * R * H * 4 * H
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {
        "bytes": bytes_,
        "flops": flops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    emit(
        "device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=line, torch=torch.__version__, cuda=torch.version.cuda,
        capability=list(torch.cuda.get_device_capability(0)),
    )
    return line


def phase_build(torch, lstm_cuda) -> None:
    t0 = time.perf_counter()
    lib, log = lstm_cuda.build()
    seconds = time.perf_counter() - t0
    grids = {
        f"{name}_{dt}": lstm_cuda.launch_config(d, b, HIDDEN, getattr(torch, dt), bwd)
        for name, d, b, bwd in (
            ("lstm_fwd", 1, 1, False), ("bilstm_fwd", 2, 8, False),
            ("lstm_bwd", 1, 2, True), ("bilstm_bwd", 2, 8, True),
        )
        for dt in ("bfloat16", "float32")
    }
    ptxas = [l.strip() for l in log.splitlines() if "ptxas" in l or "Used" in l or "spill" in l]
    emit("build", library=str(lib.relative_to(ROOT)), seconds=seconds, ptxas=ptxas, grids=grids)


def phase_kernels(torch, lstm_cuda, seed: int) -> dict:
    """Kernel vs plain version on the card, both operand types; times at the
    path's operand type (bf16)."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    T, H = T_FRAMES, HIDDEN
    s = H ** -0.5
    results = {}
    for name, directions, batch in (("lstm_fwd", 1, 1), ("bilstm_fwd", 2, 8)):
        R = directions * batch
        xp32 = torch.randn(T, R, 4 * H, generator=g)
        ws32 = [torch.empty(H, 4 * H).uniform_(-s, s, generator=g) for _ in range(directions)]
        h0 = torch.randn(R, H, generator=g).to(dev)
        c0 = torch.randn(R, H, generator=g).to(dev)
        entry = {}
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            xp = xp32.to(dev, dtype)
            ws = [w.to(dev, dtype) for w in ws32]
            if directions == 1:
                args = (xp, ws[0], h0, c0)
                kernel, plain = lstm_cuda.lstm_fwd, lstm_cuda.lstm_fwd_ref
            else:
                args = (xp, ws[0], ws[1])
                kernel, plain = lstm_cuda.bilstm_fwd, lstm_cuda.bilstm_fwd_ref
            with torch.inference_mode():
                got = kernel(*args)
                want = plain(*args)
                torch.cuda.synchronize()
            errs = {
                k: (a - b).abs().max().item()
                for k, a, b in zip(("hs", "cs", "gates"), got, want)
            }
            if directions == 1:
                errs["h_final"] = (got[0][-1] - want[0][-1]).abs().max().item()
                errs["c_final"] = (got[1][-1] - want[1][-1]).abs().max().item()
            finite = all(torch.isfinite(a).all().item() for a in got)
            err = max(errs.values())
            entry[dt] = {"max_abs_err": err, "errors": errs, "tol": TOL[dt]}
            check(finite, f"{name} {dt}: non-finite output")
            check(err <= TOL[dt], f"{name} {dt}: max abs err {err} > {TOL[dt]}")
            with torch.inference_mode():
                entry[dt]["ms"] = time_ms(torch, lambda: kernel(*args), iters=20)
                entry[dt]["plain_ms"] = time_ms(torch, lambda: plain(*args), iters=3, warmup=1)
        # yardstick: cuDNN LSTM over the model's LSTM input (incl. projection)
        lstm = torch.nn.LSTM(IN_FEATURES, H, batch_first=True, bidirectional=directions == 2)
        # bf16 weights are compacted on every call (torch's flatten_parameters
        # takes only fp16/fp32/fp64), which this yardstick includes
        lstm = lstm.to(dev, torch.bfloat16)
        x = torch.randn(batch, T, IN_FEATURES, generator=g).to(dev, torch.bfloat16)
        with torch.inference_mode():
            library_ms = time_ms(torch, lambda: lstm(x), iters=20)
        results[name] = {"bf16": entry["bfloat16"], "fp32": entry["float32"],
                         "library_ms": library_ms, **lstm_bound(directions, batch, "bfloat16")}
        emit("kernels", kernel=name, batch=batch, T=T, H=H,
             bound_fp32=lstm_bound(directions, batch, "float32"), **results[name])
    return results


def phase_bwd_kernels(torch, lstm_cuda, seed: int) -> dict:
    """Backward kernels vs their plain versions on the card, both operand
    types, on the forward's outputs for random inputs and random
    cotangents; times at the training path's operand type (bf16)."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    T, H = T_FRAMES, HIDDEN
    s = H ** -0.5
    results = {}
    for name, directions, batch in (("lstm_bwd", 1, 2), ("bilstm_bwd", 2, 8)):
        R = directions * batch
        xp32 = torch.randn(T, R, 4 * H, generator=g)
        ws32 = [torch.empty(H, 4 * H).uniform_(-s, s, generator=g) for _ in range(directions)]
        states = [torch.randn(R, H, generator=g).to(dev) for _ in range(4)]  # h0 c0 dhf dcf
        dhs = torch.randn(T, R, H, generator=g).to(dev)
        entry = {}
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            xp = xp32.to(dev, dtype)
            ws = [w.to(dev, dtype) for w in ws32]
            with torch.inference_mode():
                if directions == 1:
                    hs, cs, gates = lstm_cuda.lstm_fwd_ref(xp, ws[0], *states[:2])
                    args = (ws[0], gates, cs, hs, *states[:2], dhs, *states[2:], dtype)
                    outs = ("dxp", "dwhh", "dh0", "dc0")
                    kernel, plain = lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_ref
                else:
                    hs, cs, gates = lstm_cuda.bilstm_fwd_ref(xp, ws[0], ws[1])
                    args = (ws[0], ws[1], gates, cs, hs, dhs, dtype)
                    outs = ("dxp", "dwhh_f", "dwhh_b")
                    kernel, plain = lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_ref
                got = kernel(*args)
                want = plain(*args)
                torch.cuda.synchronize()
            errs, rel = {}, {}
            for k, a, b in zip(outs, got, want):
                errs[k] = (a.float() - b.float()).abs().max().item()
                rel[k] = errs[k] / b.float().abs().max().item()
            finite = all(torch.isfinite(a).all().item() for a in got)
            err = max(rel.values())
            entry[dt] = {"max_abs_err": max(errs.values()), "max_peak_rel_err": err,
                         "errors": errs, "peak_rel_errors": rel, "tol_peak_rel": TOL[dt]}
            check(finite, f"{name} {dt}: non-finite output")
            check(err <= TOL[dt], f"{name} {dt}: peak-relative err {err} > {TOL[dt]}")
            with torch.inference_mode():
                entry[dt]["ms"] = time_ms(torch, lambda: kernel(*args), iters=20)
                entry[dt]["plain_ms"] = time_ms(torch, lambda: plain(*args), iters=3, warmup=1)
        # yardstick: .backward() alone of a cuDNN LSTM over the model's LSTM
        # input (it also computes the input projection's gradients)
        lstm = torch.nn.LSTM(IN_FEATURES, H, batch_first=True, bidirectional=directions == 2)
        lstm = lstm.to(dev, torch.bfloat16)
        x = torch.randn(batch, T, IN_FEATURES, generator=g).to(dev, torch.bfloat16)
        x.requires_grad_(True)
        out, _ = lstm(x)
        cot = torch.randn_like(out)
        library_ms = time_ms(torch, lambda: out.backward(cot, retain_graph=True), iters=20)
        results[name] = {"bf16": entry["bfloat16"], "fp32": entry["float32"],
                         "library_ms": library_ms, **lstm_bwd_bound(directions, batch, "bfloat16")}
        emit("kernels", kernel=name, batch=batch, T=T, H=H,
             bound_fp32=lstm_bwd_bound(directions, batch, "float32"), **results[name])
    return results


def synthetic_batch(seed: int, batch: int, n: int, sr: int, emb_dim: int):
    """Two harmonic 'voices' plus noise per item, and unit-norm d-vectors."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    wav = np.zeros((batch, n), np.float64)
    for b in range(batch):
        for _ in range(2):
            f0 = rng.uniform(90.0, 260.0)
            env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2.0, 6.0) * t + rng.uniform(0, 6.3))
            for k in range(1, 8):
                wav[b] += env * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3)) / k
        wav[b] += 0.01 * rng.standard_normal(n)
    wav *= 0.3 / np.abs(wav).max(axis=1, keepdims=True)
    emb = rng.standard_normal((batch, emb_dim))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return wav.astype(np.float32), emb.astype(np.float32)


class _PlainLSTM:
    """Routes the kernel launches of `lstm_cuda` (forward and autograd
    backward) to the plain versions on the card while active."""

    NAMES = ("lstm_fwd", "bilstm_fwd", "lstm_bwd", "bilstm_bwd")

    def __init__(self, lstm_cuda):
        self.m = lstm_cuda

    def __enter__(self):
        self.saved = {n: getattr(self.m, f"_launch_{n}") for n in self.NAMES}
        for n in self.NAMES:
            setattr(self.m, f"_launch_{n}", getattr(self.m, f"{n}_ref"))

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.m, f"_launch_{n}", fn)


def phase_separate(torch, lstm_cuda, seed: int, profile_dir) -> dict:
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.dsp.stft import istft_magphase, stft_magphase
    from voicesplit_tpu_torch.models.masknet import make_masknet

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    ap = make_audio_processor(config)
    model = weights.init_random_(make_masknet(config), seed)
    n = int(config.audio.audio_len * ap.sample_rate)
    batches = {b: synthetic_batch(seed + b, b, n, ap.sample_rate, config.model.emb_dim)
               for b in (1, 8)}

    # the counted run of the main path
    torch.cuda.synchronize()
    lstm_cuda.reset_launch_counts()
    outs = {b: separate_batch(model, ap, *batches[b]) for b in (1, 8)}
    torch.cuda.synchronize()
    launches = dict(lstm_cuda.LAUNCHES)
    check(launches["lstm_fwd"] >= 2, f"lstm_fwd launches {launches['lstm_fwd']} < 2 (B=1)")
    check(launches["bilstm_fwd"] >= 1, f"bilstm_fwd launches {launches['bilstm_fwd']} < 1 (B=8)")

    report = {"launches": launches, "params": sum(p.numel() for p in model.parameters())}
    for b, out in outs.items():
        mixed, emb = (torch.as_tensor(a, device="cuda") for a in batches[b])
        check(tuple(out.shape) == (b, n), f"B={b}: output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"B={b}: non-finite output")
        with torch.inference_mode():
            spec, phase = ap.wav2spec_batch(mixed)
            mask = model(spec, emb)
            with _PlainLSTM(lstm_cuda):
                mask_plain = model(spec, emb)
                out_plain = separate_batch(model, ap, mixed, emb)
            mag, ph = stft_magphase(mixed, ap.n_fft, ap.hop_length, ap.win_length)
            roundtrip = istft_magphase(mag, ph, ap.n_fft, ap.hop_length, ap.win_length, length=n)
        check(float(mask.min()) >= 0.0 and float(mask.max()) <= 1.0, f"B={b}: mask outside [0, 1]")
        mask_err = (mask - mask_plain).abs().max().item()
        wav_err = ((out - out_plain).abs().max() / out_plain.abs().max()).item()
        rt_snr = (10 * torch.log10((mixed ** 2).sum() / ((roundtrip - mixed) ** 2).sum())).item()
        check(mask_err <= SEPARATE_TOL, f"B={b}: mask vs plain LSTM {mask_err} > {SEPARATE_TOL}")
        check(wav_err <= SEPARATE_TOL, f"B={b}: waveform vs plain LSTM {wav_err} > {SEPARATE_TOL}")
        check(rt_snr >= ROUNDTRIP_MIN_SNR_DB, f"B={b}: STFT round trip {rt_snr} dB")
        ms = time_ms(torch, lambda: separate_batch(model, ap, mixed, emb), iters=10)
        lat = []
        for _ in range(LATENCY_CALLS):
            t0 = time.perf_counter()
            separate_batch(model, ap, mixed, emb)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        p50, p75 = (float(np.percentile(lat, q)) for q in (50, 75))
        report[f"B{b}"] = {
            "samples": n, "mask_range": [float(mask.min()), float(mask.max())],
            "mask_err_vs_plain": mask_err, "wave_rel_err_vs_plain": wav_err,
            "roundtrip_snr_db": rt_snr, "device_ms_mean": ms, "calls": LATENCY_CALLS,
            "latency_ms_p50": p50, "latency_ms_p75": p75,
            "audio_s_per_s": b * config.audio.audio_len / (p50 / 1e3),
        }
        if profile_dir:
            report[f"B{b}"]["profile"] = profile(
                torch, profile_dir, f"separate_B{b}", lambda: separate_batch(model, ap, mixed, emb)
            )
    emit("separate", device=torch.cuda.get_device_name(0), **report)
    return launches


def train_batch(seed: int, batch: int, n: int, sr: int, emb_dim: int) -> dict:
    """Target = one synthetic voice, mixture = target + another voice."""
    target, emb = synthetic_batch(seed, batch, n, sr, emb_dim)
    other, _ = synthetic_batch(seed + 1000, batch, n, sr, emb_dim)
    return {"mixed_wav": target + other, "target_wav": target, "emb": emb,
            "wav_len": np.full((batch,), n, np.int32)}


def _snapshot(model, optimizer, state):
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            copy.deepcopy(optimizer.state_dict()), state.step)


def _restore(model, optimizer, state, snap) -> None:
    model.load_state_dict(snap[0])
    optimizer.load_state_dict(snap[1])
    state.step = snap[2]


def _lstm_grads(model) -> dict:
    return {k: p.grad.detach().float().clone() for k, p in model.lstm.named_parameters()}


def phase_train(torch, lstm_cuda, seed: int, profile_dir) -> dict:
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    config.train_config.learning_rate = TRAIN_LR
    ap = make_audio_processor(config)
    n = int(config.audio.audio_len * ap.sample_rate)
    report = {"config": "configs/voicesplit.json", "loss_name": config.loss.loss_name,
              "compute_dtype": config.train_config.compute_dtype, "learning_rate": TRAIN_LR,
              "tolerances": TRAIN_TOL}
    launches = {k: 0 for k in lstm_cuda.LAUNCHES}
    for b in (2, 8):
        model = weights.init_random_(make_masknet(config), seed)
        optimizer = make_optimizer(config, model)
        state = create_train_state(model, optimizer)
        step = make_train_step(config, model, ap, optimizer)
        batch = train_batch(seed + b, b, n, ap.sample_rate, config.model.emb_dim)
        before = _snapshot(model, optimizer, state)

        # the counted run of the training path: one step from fresh weights
        torch.cuda.synchronize()
        lstm_cuda.reset_launch_counts()
        mk = step(state, batch)
        torch.cuda.synchronize()
        counted = dict(lstm_cuda.LAUNCHES)
        for k, v in counted.items():
            launches[k] += v
        check(counted == TRAIN_LAUNCHES[b], f"B={b}: launches per step {counted}")
        loss0, gn0 = float(mk["loss"]), float(mk["grad_norm"])
        check(np.isfinite(loss0) and not bool(mk["loss_exploded"]), f"B={b}: loss {loss0}")
        check(gn0 > 0 and np.isfinite(gn0), f"B={b}: grad_norm {gn0}")
        unmoved = [k for k, v in model.state_dict().items() if torch.equal(v, before[0][k])]
        check(not unmoved, f"B={b}: unchanged after a step: {unmoved}")

        # the same step from the same weights through the plain versions
        gk = _lstm_grads(model)
        _restore(model, optimizer, state, before)
        with _PlainLSTM(lstm_cuda):
            mp = step(state, batch)
        gp = _lstm_grads(model)
        vs_plain = {
            "loss_rel": abs(loss0 - float(mp["loss"])) / abs(float(mp["loss"])),
            "grad_norm_rel": abs(gn0 - float(mp["grad_norm"])) / float(mp["grad_norm"]),
            "lstm_grad_peak_rel": {
                k: ((gk[k] - gp[k]).abs().max() / gp[k].abs().max()).item() for k in gk
            },
        }
        for k, tol in TRAIN_TOL.items():
            err = vs_plain[k]
            err = max(err.values()) if isinstance(err, dict) else err
            check(err <= tol, f"B={b}: kernels vs plain {k} {err} > {tol}")

        # steady state: synchronized steps
        for _ in range(TRAIN_WARM):
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics.append(step(state, batch))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        losses = [float(m["loss"]) for m in metrics]
        grad_norms = [float(m["grad_norm"]) for m in metrics]
        check(all(np.isfinite(losses)), f"B={b}: non-finite loss in {losses}")
        check(losses[-1] < loss0, f"B={b}: loss did not fall on a fixed batch: {loss0} -> {losses}")
        p50, p75 = (float(np.percentile(times, q)) for q in (50, 75))
        report[f"B{b}"] = {
            "launches_per_step": counted, "first_loss": loss0, "first_grad_norm": gn0,
            "kernels_vs_plain": vs_plain, "steps": TRAIN_STEPS,
            "step_ms_p50": p50, "step_ms_p75": p75,
            "audio_s_per_s": b * config.audio.audio_len / (p50 / 1e3),
            "losses": losses, "grad_norms": grad_norms,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        }
        if profile_dir:
            report[f"B{b}"]["profile"] = profile(
                torch, profile_dir, f"train_B{b}", lambda: step(state, batch)
            )
        del model, optimizer, state, step
        torch.cuda.empty_cache()
    emit("train", device=torch.cuda.get_device_name(0), **report)
    return launches


# kernel-name fragments → kind, for the device time split under --profile
KERNEL_KINDS = (
    ("lstm kernels", ("lstm_fwd_kernel", "lstm_bwd_kernel")),
    ("convs", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad")),
    ("matmuls", ("gemm", "cutlass", "nvjet", "splitk")),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("layout", ("nchw", "nhwc", "transpose", "permute", "copy")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, frags in KERNEL_KINDS:
        if any(f in low for f in frags):
            return kind
    return "elementwise and other"


def profile(torch, out_dir, tag, fn, runs: int = 5) -> dict:
    """Kernel time by name over `runs` calls (torch.profiler), written to
    out_dir; returns the device's busy share of the profiled wall time
    (profiler overhead lengthens the wall, so the idle share is an upper
    bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    (out / f"{tag}.txt").write_text(table)
    prof.export_chrome_trace(str(out / f"{tag}.json"))
    split: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = kernel_kind(e.name)
            split[kind] = split.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3 / runs
    kernel_ms = sum(split.values()) * runs
    return {"runs": runs, "wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "idle_share": 1.0 - kernel_ms / wall_ms, "ms_per_run_by_kind": split}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", type=str, default=None)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.device import set_fp32_precision
    from voicesplit_tpu_torch.ops import lstm_cuda

    set_fp32_precision()
    smi_line = phase_device(torch)
    phase_build(torch, lstm_cuda)
    kern = phase_kernels(torch, lstm_cuda, args.seed)
    kern.update(phase_bwd_kernels(torch, lstm_cuda, args.seed))
    by_path = {
        "separate": phase_separate(torch, lstm_cuda, args.seed, args.profile),
        "train": phase_train(torch, lstm_cuda, args.seed, args.profile),
    }
    # each kernel's launches come from the counted run of the path it serves
    home = {"lstm_fwd": "separate", "bilstm_fwd": "separate",
            "lstm_bwd": "train", "bilstm_bwd": "train"}
    kernels = [
        {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": by_path[home[name]][name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": r["bf16"]["max_abs_err"], "max_abs_err_fp32": r["fp32"]["max_abs_err"],
            "ms": r["bf16"]["ms"], "plain_ms": r["bf16"]["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        for name, r in kern.items()
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
