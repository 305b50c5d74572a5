#!/usr/bin/env python3
"""Checks and times the port's LSTM split walks (H=800) on the card, one tree at a time.

    python3 scripts/port_lstm_split_check.py [--root DIR] [--walks fwd,bwd]

Imports `voicesplit_tpu_torch` from DIR (default: this checkout) and builds
its kernels there, so that a variant of the kernels unpacked into a
git-ignored directory is checked by the same script.  Prints the build's
``ptxas`` lines about the split walks (registers, spills) and any C7520
("wgmma ... serialized") advisory, the launch each wrapper makes at H=800
(route, registers, spilled bytes, shared memory, clusters), then one JSON
line per case: the wrapper against its plain version on the same inputs
(forward: the largest absolute error of hs, cs and gates; backward: each
output's error relative to its peak), whether two launches give the same
bits, the routes the two launches took, and the mean time of 20 calls after
two warm ones (CUDA events).

- forward (``fwd``): ``lstm_fwd`` at B=1 (T=5, 2, 1, 301), B=2 (T=301) and
  B=3 (T=41); ``bilstm_fwd`` at 8 rows a direction (T=301), 9 and 16
  (T=41) and 24 (T=31: more clusters than the card holds at once, so the
  grid route); ``lstm_fwd`` in fp32 at B=2 (T=31, the grid route);
- backward (``bwd``): ``lstm_bwd`` at B=1 (T=3, 1, 301), B=2 (T=301), 3
  and 9 (T=41); ``bilstm_bwd`` at 8 rows a direction (T=301), 9 (T=41:
  the grid route) and 3 (T=5), on the plain forward's outputs and random
  cotangents.

bf16 unless said; inputs from a seeded generator.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

H_WIDE = 800
FWD_CASES = ((1, 1, 5), (1, 1, 2), (1, 1, 1), (1, 1, 301), (1, 2, 301), (1, 3, 41), (2, 8, 301),
             (2, 9, 41), (2, 16, 41), (2, 24, 31))
BWD_CASES = ((1, 1, 3), (1, 1, 1), (1, 2, 301), (1, 1, 301), (1, 3, 41), (1, 9, 41), (2, 8, 301),
             (2, 9, 41), (2, 3, 5))


def _timed(torch, fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def forward_case(torch, lstm_cuda, D: int, B: int, T: int, dt) -> dict:
    H = H_WIDE
    g = torch.Generator().manual_seed(B + T)
    R = D * B
    xp = torch.randn(T, R, 4 * H, generator=g).to("cuda", dt)
    s = H ** -0.5
    ws = [torch.empty(H, 4 * H).uniform_(-s, s, generator=g).to("cuda", dt) for _ in range(2)]
    if D == 1:
        h0, c0 = (torch.randn(R, H, generator=g).cuda() for _ in range(2))
        args, kernel, plain = (xp, ws[0], h0, c0), lstm_cuda.lstm_fwd, lstm_cuda.lstm_fwd_ref
    else:
        args, kernel, plain = (xp, ws[0], ws[1]), lstm_cuda.bilstm_fwd, lstm_cuda.bilstm_fwd_ref
    before = dict(lstm_cuda.ROUTES)
    with torch.inference_mode():
        got = kernel(*args)
        torch.cuda.synchronize()
        again, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        out = {"wrapper": "lstm_fwd" if D == 1 else "bilstm_fwd", "rows": B, "T": T, "dtype": str(dt),
               "errs": [(a - b).abs().max().item() for a, b in zip(got, want)],
               "same_bits_twice": all(torch.equal(a, b) for a, b in zip(got, again)),
               "finite": all(bool(torch.isfinite(a).all()) for a in got),
               "routes": {k: v - before[k] for k, v in lstm_cuda.ROUTES.items()}}
        out["ms"] = _timed(torch, lambda: kernel(*args))
    return out


def backward_case(torch, lstm_cuda, D: int, B: int, T: int, dt) -> dict:
    H = H_WIDE
    g = torch.Generator().manual_seed(B + T)
    R = D * B
    s = H ** -0.5
    xp = torch.randn(T, R, 4 * H, generator=g).to("cuda", dt)
    ws = [torch.empty(H, 4 * H).uniform_(-s, s, generator=g).to("cuda", dt) for _ in range(2)]
    states = [torch.randn(R, H, generator=g).cuda() for _ in range(4)]  # h0 c0 dhf dcf
    dhs = torch.randn(T, R, H, generator=g).cuda()
    with torch.inference_mode():
        if D == 1:
            hs, cs, gates = lstm_cuda.lstm_fwd_ref(xp, ws[0], *states[:2])
            args = (ws[0], gates, cs, hs, *states[:2], dhs, *states[2:], dt)
            kernel, plain = lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_ref
        else:
            hs, cs, gates = lstm_cuda.bilstm_fwd_ref(xp, ws[0], ws[1])
            args = (ws[0], ws[1], gates, cs, hs, dhs, dt)
            kernel, plain = lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_ref
        before = dict(lstm_cuda.ROUTES_BWD)
        got = kernel(*args)
        torch.cuda.synchronize()
        again, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        out = {"wrapper": "lstm_bwd" if D == 1 else "bilstm_bwd", "rows": B, "T": T, "dtype": str(dt),
               "peak_rel_errs": [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                                 for a, b in zip(got, want)],
               "same_bits_twice": all(torch.equal(a, b) for a, b in zip(got, again)),
               "finite": all(bool(torch.isfinite(a).all()) for a in got),
               "routes": {k: v - before[k] for k, v in lstm_cuda.ROUTES_BWD.items()}}
        out["ms"] = _timed(torch, lambda: kernel(*args))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--walks", default="fwd,bwd")
    args = parser.parse_args(argv)
    walks = set(args.walks.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("port_lstm_split_check: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.ops import _build, lstm_cuda

    t0 = time.perf_counter()
    _, log = _build.build()
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line
        if "C7520" in line or (name and "split" in name and ("Used" in line or "spill" in line)):
            print(line.strip()[:300], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    bf16 = torch.bfloat16
    for walk, backward, cases in (("fwd", False, FWD_CASES), ("bwd", True, BWD_CASES)):
        if walk not in walks:
            continue
        for D, B in sorted({(d, b) for d, b, _ in cases}):
            cfg = lstm_cuda.launch_config(D, B, H_WIDE, bf16, backward=backward)
            print(json.dumps({"launch_config": walk, **cfg, "directions": D, "rows_a_direction": B}), flush=True)
        run = backward_case if backward else forward_case
        for D, B, T in cases:
            print(json.dumps(run(torch, lstm_cuda, D, B, T, bf16)), flush=True)
        if not backward:
            print(json.dumps(forward_case(torch, lstm_cuda, 1, 2, 31, torch.float32)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
