#!/usr/bin/env python3
"""Hashes the dW_hh kernel's outputs of a tree on the card, so that two trees
can be checked for the same bits.

    python3 scripts/port_dwhh_bits.py [--root DIR] [--tag NAME]

Imports `voicesplit_tpu_torch` from DIR (default: this checkout) and builds
its kernels there, then runs ``lstm_cuda.lstm_dwhh`` on inputs made from a
fixed seed at the shapes the port's paths give it: bf16 at H=400 (one
direction of 2 rows, two of 8 and of 24) and at H=800 (one of 2, two of 8),
T=301, and fp32 at the GE2E encoder's [80, 96], H=768.  Prints one JSON line
with the SHA-256 of each output's bytes and the card's name and power limit;
run it on two trees in one call and compare the lines.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

# (operand type, frames, rows a direction, directions, hidden units)
SHAPES = (("bfloat16", 301, 2, 1, 400), ("bfloat16", 301, 8, 2, 400), ("bfloat16", 301, 24, 2, 400),
          ("bfloat16", 301, 2, 1, 800), ("bfloat16", 301, 8, 2, 800), ("float32", 80, 96, 1, 768))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--tag", default="")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("port_dwhh_bits: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.ops import lstm_cuda

    if not Path(lstm_cuda.__file__).resolve().is_relative_to(root):
        print(f"port_dwhh_bits: imported {lstm_cuda.__file__}, not from {root}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    hashes = {}
    for dt, T, B, D, H in SHAPES:
        g = torch.Generator().manual_seed(T * 1000 + B * 10 + D + H)
        dtype = getattr(torch, dt)
        hs = torch.randn(T, D * B, H, generator=g).cuda()
        h0 = torch.randn(D * B, H, generator=g).cuda() if D == 1 else None
        dg = torch.randn(T, D * B, 4 * H, generator=g).to("cuda", dtype)
        with torch.inference_mode():
            out = lstm_cuda.lstm_dwhh(hs, h0, dg, D, dtype)
        torch.cuda.synchronize()
        hashes[f"{dt}_T{T}_B{B}_D{D}_H{H}"] = [
            hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest() for o in out]
    print(json.dumps({"tag": args.tag, "root": str(root), "nvidia_smi": smi, "sha256": hashes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
