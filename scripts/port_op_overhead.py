#!/usr/bin/env python3
"""Times the host cost of the kernels' launch path on the card, for one tree.

    python3 scripts/port_op_overhead.py [--root DIR] --tag T [--calls 40] [--seed 0]

Imports `voicesplit_tpu_torch` from ``--root`` (default: this repository),
so that one card can time two trees in turns (parent, change, change, parent,
one process each).  At full width (`configs/voicesplit.json`, bf16, random
weights from ``--seed``) it times

- ``serve_B1``: `cli.separate.separate_batch` on a 3 s clip at B=1;
- ``chunk_B1``: `StreamingSeparator.process_chunk` of the causal streaming
  model at B=1, chunks of 50 frames, the state carried;
- ``lstm_fwd_call``: one `ops.lstm_cuda.lstm_fwd` wrapper call at
  ``[50, 1, 1600]`` (a chunk's recurrence).

For each: the p50 and p75 of ``--calls`` calls each ended by a synchronize
(the call's time) and the p50 of the host time until the call returns (its
enqueue time, which the launch path's Python adds to).  Prints one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _times(torch, fn, calls: int, warmup: int = 5) -> dict:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total, enqueue = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        total.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
    return {"p50_ms": float(np.percentile(total, 50)), "p75_ms": float(np.percentile(total, 75)),
            "enqueue_p50_ms": float(np.percentile(enqueue, 50))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=str, default=str(ROOT))
    parser.add_argument("--tag", type=str, required=True)
    parser.add_argument("--calls", type=int, default=40)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("port_op_overhead: no CUDA device", file=sys.stderr)
        return 1
    import voicesplit_tpu_torch
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.ops import lstm_cuda
    from voicesplit_tpu_torch.streaming import StreamingSeparator

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    ap = make_audio_processor(config)
    model = weights.init_random_(make_masknet(config), args.seed)
    rng = np.random.default_rng(args.seed)
    n = int(config.audio.audio_len * ap.sample_rate)
    mixed = torch.as_tensor(0.1 * rng.standard_normal((1, n)), dtype=torch.float32, device="cuda")
    emb = torch.as_tensor(rng.standard_normal((1, config.model.emb_dim)), dtype=torch.float32,
                          device="cuda")
    out = {"tag": args.tag, "package": str(Path(voicesplit_tpu_torch.__file__).parent)}
    out["serve_B1"] = _times(torch, lambda: separate_batch(model, ap, mixed, emb), args.calls)

    config.model.causal = True
    smodel = weights.init_random_(make_masknet(config, streaming=True), args.seed + 1)
    sep = StreamingSeparator(config, smodel, 50)
    chunk = torch.as_tensor(0.1 * rng.standard_normal((1, sep.chunk_samples)), dtype=torch.float32,
                            device="cuda")
    state = [sep.init_state(1)]

    def step():
        state[0], _ = sep.process_chunk(state[0], chunk, emb)

    out["chunk_B1"] = _times(torch, step, args.calls)

    H = smodel.lstm.hidden
    xp = torch.randn(50, 1, 4 * H, device="cuda").to(torch.bfloat16)
    w = (0.05 * torch.randn(H, 4 * H, device="cuda")).to(torch.bfloat16)
    z = torch.zeros(1, H, device="cuda")
    with torch.inference_mode():
        out["lstm_fwd_call"] = _times(torch, lambda: lstm_cuda.lstm_fwd(xp, w, z, z), 4 * args.calls)
    out["launches"] = dict(lstm_cuda.LAUNCHES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["device"] = smi.stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
