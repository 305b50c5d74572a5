#!/usr/bin/env python3
"""Times the streaming engine's chunk step at full width on the card.

    python3 scripts/port_stream_times.py [--seed 0] [--chunks 48] [--rounds 4] [--host_profile]

Builds `chip_smoke.py`'s streams (STREAM_CASES: the causal model at B=1 and
B=8, the symmetric one at B=1 with ``VOICESPLIT_PALLAS_CONV=1`` and without;
`configs/voicesplit.json`, bf16, random weights from ``--seed``, chunks of
STREAM_CHUNK frames).  Each round times ``--chunks`` chunks of every stream
in turn, the state carried from chunk to chunk, the streams' order rotated
by one every round.  For each chunk it reads the host clock when
`process_chunk` returns (the enqueue time) and after a synchronize (the
chunk time).  Once a stream, under torch.profiler, it counts the kernels a
chunk launches and sums their device time.  Prints one JSON line a stream
and round, and a last line with each stream's medians over the rounds.
``--host_profile`` then runs ``--chunks`` chunks of each stream under
cProfile and prints the 12 functions with the most own host time a chunk
(cProfile's overhead lengthens every Python call: it ranks, it does not
time).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repository root, after the path)


def _device_per_chunk(torch, fn, runs: int = 10) -> dict:
    """Kernels a call launches and their device milliseconds (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"kernels_per_chunk": len(kernels) / runs,
            "device_ms_per_chunk": sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / runs}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--chunks", type=int, default=48)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--host_profile", action="store_true")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("port_stream_times: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.device import set_fp32_precision

    set_fp32_precision()
    cs.phase_device(torch)  # the card's name and power limit
    streams = {}
    for name, (causal, B, switch) in cs.STREAM_CASES.items():
        config = cs._stream_config(causal)
        with cs._Env("VOICESPLIT_PALLAS_CONV", switch):
            sep = cs._streamer(config, args.seed)
        n = int(config.audio.audio_len * sep.ap.sample_rate)
        wav, emb = cs.synthetic_batch(args.seed + B, B, n, sep.ap.sample_rate, config.model.emb_dim)
        streams[name] = {"sep": sep, "wav": wav, "emb": emb, "switch": switch,
                         "state": sep.init_state(B)}

    def chunk(s, i):
        cs_ = s["sep"].chunk_samples
        piece = s["wav"][:, (i * cs_) % (s["wav"].shape[1] - cs_):][:, :cs_]
        s["state"], out = s["sep"].process_chunk(s["state"], piece, s["emb"])
        return out

    names = list(streams)
    for name in names:  # warm each stream, then count its launches
        s = streams[name]
        with cs._Env("VOICESPLIT_PALLAS_CONV", s["switch"]):
            for i in range(4):
                chunk(s, i)
            s["device"] = _device_per_chunk(torch, lambda: chunk(s, 0))
    rows: dict = {name: [] for name in names}
    for r in range(args.rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            s = streams[name]
            enq, total = [], []
            with cs._Env("VOICESPLIT_PALLAS_CONV", s["switch"]):
                torch.cuda.synchronize()
                for i in range(args.chunks):
                    t0 = time.perf_counter()
                    chunk(s, i)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    enq.append((t1 - t0) * 1e3)
                    total.append((t2 - t0) * 1e3)
            row = {"stream": name, "round": r, "chunks": args.chunks,
                   "chunk_ms_p50": float(np.percentile(total, 50)),
                   "chunk_ms_p75": float(np.percentile(total, 75)),
                   "enqueue_ms_p50": float(np.percentile(enq, 50)), **s["device"]}
            rows[name].append(row)
            print(json.dumps(row), flush=True)
    summary = {name: {"chunk_ms_p50_median": float(np.median([x["chunk_ms_p50"] for x in rs])),
                      "chunk_ms_p50_range": [min(x["chunk_ms_p50"] for x in rs),
                                             max(x["chunk_ms_p50"] for x in rs)],
                      "enqueue_ms_p50_median": float(np.median([x["enqueue_ms_p50"] for x in rs])),
                      **streams[name]["device"]}
               for name, rs in rows.items()}
    if args.host_profile:
        import cProfile
        import pstats

        for name in names:
            s = streams[name]
            prof = cProfile.Profile()
            with cs._Env("VOICESPLIT_PALLAS_CONV", s["switch"]):
                prof.enable()
                for i in range(args.chunks):
                    chunk(s, i)
                torch.cuda.synchronize()
                prof.disable()
            stats = pstats.Stats(prof).stats  # {(file, line, fn): (cc, nc, tt, ct, callers)}
            top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
            print(json.dumps({"stream": name, "host_profile_ms_per_chunk": [
                {"function": f"{Path(k[0]).name}:{k[1]}:{k[2]}", "calls_per_chunk": v[1] / args.chunks,
                 "own_ms_per_chunk": v[2] * 1e3 / args.chunks} for k, v in top]}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
