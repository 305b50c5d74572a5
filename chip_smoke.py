#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's serving path (NVIDIA H100).

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases, each printing one JSON line:

1. device   — the card's name and power limit (``nvidia-smi``).
2. build    — compiles `voicesplit_tpu_torch/csrc/lstm_fwd.cu` with nvcc for
   sm_90a into ``build/`` and prints ``ptxas -v`` (registers, shared memory,
   spills) and each kernel's launch grid.
3. kernels  — at H=400, T=301 holds ``lstm_fwd`` (B=1, random h0/c0) and
   ``bilstm_fwd`` (B=8) against their plain PyTorch versions on the card, in
   bf16 and fp32 operands (hs, cs, gates, and the final (h, c) of
   ``lstm_fwd``), then times kernel, plain version and ``torch.nn.LSTM``
   (cuDNN, a yardstick only: it also computes the input projection).
4. separate — builds the full-width `configs/voicesplit.json` model (bf16)
   with weights made from ``--seed``, zeroes the launch counters, runs
   `separate_batch` at B=1 and at B=8 on 3 s synthetic mixtures, reads the
   counters, and checks the output (48000 finite samples, mask in [0, 1],
   agreement with the same model run through the plain LSTM versions on
   the card, and an unnormalized STFT→iSTFT round trip of the mixture).
   Prints the steady-state latency per batch (median and p75 of 40 calls)
   and audio-seconds per second.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit line
and, last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is non-zero and no result line is printed.  It also exits
non-zero without a card, or without the rest of the repository beside it.
``--profile DIR`` additionally writes a ``torch.profiler`` kernel table and
trace of the B=1 and B=8 serving runs into DIR and reports the device's
idle share under the profiler.
"""

from __future__ import annotations

import argparse
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
# bf16: a different summation order can flip one bf16 rounding of h, which
# then carries through the recurrence; fp32 (TF32 off) differs by order only.
SEPARATE_TOL = 5e-2  # mask and peak-relative waveform error, kernel vs plain LSTM (bf16)
ROUNDTRIP_MIN_SNR_DB = 60.0
LATENCY_CALLS = 40  # p75 is then the highest percentile with ten calls beyond it


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
        f"{name}_{dt}": lstm_cuda.launch_config(d, b, HIDDEN, getattr(torch, dt))
        for name, d, b in (("lstm_fwd", 1, 1), ("bilstm_fwd", 2, 8))
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
    """Routes the model's LSTM calls to the plain versions while active."""

    def __init__(self, lstm_cuda):
        self.m = lstm_cuda

    def __enter__(self):
        self.saved = (self.m.lstm_fwd, self.m.bilstm_fwd)
        self.m.lstm_fwd, self.m.bilstm_fwd = self.m.lstm_fwd_ref, self.m.bilstm_fwd_ref

    def __exit__(self, *exc):
        self.m.lstm_fwd, self.m.bilstm_fwd = self.saved


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
    kernel_ms = sum(
        e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA
    ) / 1e3
    return {"runs": runs, "wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "idle_share": 1.0 - kernel_ms / wall_ms}


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
    launches = phase_separate(torch, lstm_cuda, args.seed, args.profile)
    replaces = {"lstm_fwd": "voicesplit_tpu/ops/lstm_pallas.py:71",
                "bilstm_fwd": "voicesplit_tpu/ops/lstm_pallas.py:251"}
    kernels = [
        {
            "name": name, "route": "cuda", "source": "voicesplit_tpu_torch/csrc/lstm_fwd.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["bf16"]["max_abs_err"], "max_abs_err_fp32": r["fp32"]["max_abs_err"],
            "ms": r["bf16"]["ms"], "plain_ms": r["bf16"]["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        for name, r in kern.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
