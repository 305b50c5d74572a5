#!/usr/bin/env python3
"""Hashes the conv kernels' outputs of a tree on the card, so that two trees
can be checked for the same bits.

    python3 scripts/port_conv_bits.py [--root DIR] [--tag NAME]

Imports `voicesplit_tpu_torch` from DIR (default: this checkout) and builds
its kernels there, then runs every conv kernel wrapper at 64 channels in and
out on inputs made from a fixed seed: ``conv_dilated_fwd`` (as forward and,
with flipped weights, as data gradient), ``conv_dilated_wgrad``,
``conv_bn_act_fwd`` (with the chain's mish prologue, none on the (7,1)
layer), ``conv_dgrad``, ``conv_wgrad`` (mish prologue) and
``conv_wgrad_prologue``, in bf16 at the training path's ``[2, 301, 601,
64]`` for conv2 … conv7's six layer kinds and the wide config's (5,5) layer
at time dilation 32, and in fp32 at ``[1, 40, 150, 64]`` for the (7,1) and
(5,5) dilation-1 layers.  Prints one JSON line with the SHA-256 of each
output's bytes and the card's name and power limit; run it on two trees in
one call and compare the lines.  The bits follow the card's SM count (the
kernels' grids are one wave of resident blocks); `tests/test_torch_gpu.py`
holds a stored copy taken on an H100 SXM (132 SMs).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

LAYERS = {"7x1": ((7, 1), 1), "5x5-d1": ((5, 5), 1), "5x5-d2": ((5, 5), 2),
          "5x5-d4": ((5, 5), 4), "5x5-d8": ((5, 5), 8), "5x5-d16": ((5, 5), 16),
          "5x5-d32": ((5, 5), 32)}
# (operand type, activations [B, T, F, C], layers)
CASES = (("bfloat16", (2, 301, 601, 64), tuple(LAYERS)),
         ("float32", (1, 40, 150, 64), ("7x1", "5x5-d1")))


def conv_bits(torch, cc, cf) -> dict:
    """SHA-256 of every conv kernel's outputs at 64 channels, by case."""
    def sha(t):
        return hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()

    hashes = {}
    for dt_name, shape, layers in CASES:
        dtype = getattr(torch, dt_name)
        C = shape[-1]
        for layer in layers:
            (kt, kf), dt = LAYERS[layer]
            g = torch.Generator().manual_seed(1000 * kt + 10 * dt + kf)
            x = torch.randn(shape, generator=g).to("cuda", dtype)
            d = torch.randn(shape, generator=g).to("cuda", dtype)
            w = (torch.randn(kt, kf, C, C, generator=g) * (kt * kf * C) ** -0.5).to("cuda", dtype)
            bias = (0.1 * torch.randn(C, generator=g)).cuda()
            scal = cf._scal_table(0.2 * torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5,
                                  torch.rand(C, generator=g) + 0.5, 0.1 * torch.randn(C, generator=g)).cuda()
            act, on = (None, False) if layer == "7x1" else ("mish", True)
            wf = cc.flip_weight(w)
            with torch.inference_mode():
                outs = {
                    "conv_dilated_fwd": (cc.conv_dilated_fwd(x, w, dt),),
                    "conv_dilated_fwd_data_gradient": (cc.conv_dilated_fwd(d, wf, dt),),
                    "conv_dilated_wgrad": (cc.conv_dilated_wgrad(x, d, kt, kf, dt),),
                    "conv_bn_act_fwd": cf.conv_bn_act_fwd(x, w, bias, scal, dt, act, on),
                    "conv_dgrad": cf.conv_dgrad(d, wf, dt),
                    "conv_wgrad": (cf.conv_wgrad(x, d, scal, kt, kf, dt, "mish", True),),
                    "conv_wgrad_prologue": (cf.conv_wgrad_prologue(x, scal, "mish"),),
                }
            torch.cuda.synchronize()
            for name, out in outs.items():
                hashes[f"{name}/{layer}/{dt_name}"] = [sha(o) for o in out]
            del x, d, w, wf, outs
        torch.cuda.empty_cache()
    return hashes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--tag", default="")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("port_conv_bits: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.ops import conv_cuda as cc
    from voicesplit_tpu_torch.ops import conv_fused as cf

    if not Path(cc.__file__).resolve().is_relative_to(root):
        print(f"port_conv_bits: imported {cc.__file__}, not from {root}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"tag": args.tag, "root": str(root), "nvidia_smi": smi,
                      "sha256": conv_bits(torch, cc, cf)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
