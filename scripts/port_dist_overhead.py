#!/usr/bin/env python3
"""Times what an NCCL process group of one rank adds to the port's train step on the card.

    python3 scripts/port_dist_overhead.py [--seed 0] [--rounds 3] [--steps 10] [--calls 200]

For `configs/voicesplit.json` at B=2 (bf16, si_snr; `chip_smoke.py`'s
weights, batch and learning rate) on the unfused path and on the fused
chain, in rounds: `--steps` synchronized steps with no group, then as many
under a world of one started by `parallel.initialize_distributed` in each
variant of NCCL's environment:

- ``default``: as a user gets it;
- ``no_flight_recorder``: ``TORCH_NCCL_TRACE_BUFFER_SIZE=0``;
- ``no_flight_recorder_no_watchdog_checks``: that and
  ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``.

Under each variant it also times the host's cost of one
`parallel.mesh.sum_over_ranks_` on a ``[2, 64]`` fp32 tensor on the card
(`--calls` calls, then a synchronize).  Prints one JSON line a route (each
variant's step p50 / p75 against the no-group steps', and µs a call) and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repository root, after the path)

VARIANTS = {
    "default": {},
    "no_flight_recorder": {"TORCH_NCCL_TRACE_BUFFER_SIZE": "0"},
    "no_flight_recorder_no_watchdog_checks": {"TORCH_NCCL_TRACE_BUFFER_SIZE": "0",
                                              "TORCH_NCCL_ASYNC_ERROR_HANDLING": "0"},
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--calls", type=int, default=200)
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("port_dist_overhead: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.parallel.mesh import initialize_distributed, sum_over_ranks_

    smi = cs.phase_device(torch)
    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    config.train_config.learning_rate = cs.TRAIN_LR
    b = config.train_config.batch_size
    summary = {}
    for route in cs.VOICEFILTER_ROUTES:
        with cs._route_env(route):
            _, _, state, step, batch = cs._fresh_step(config, args.seed, b)
            for _ in range(cs.TRAIN_WARM):
                step(state, batch)
            steps = {"no_group": [], **{v: [] for v in VARIANTS}}
            call_us = {v: [] for v in VARIANTS}
            buf = torch.ones(2, 64, device="cuda")
            for rnd in range(args.rounds):
                order = list(VARIANTS) if rnd % 2 == 0 else list(VARIANTS)[::-1]
                for name in order:
                    steps["no_group"] += cs._step_times(torch, step, state, batch, args.steps)
                    saved = {k: os.environ.get(k) for k in VARIANTS[name]}
                    os.environ.update(VARIANTS[name])
                    try:
                        initialize_distributed(f"localhost:{cs._free_port()}", 1, 0)
                        step(state, batch)  # the group's first collectives set it up
                        torch.cuda.synchronize()
                        steps[name] += cs._step_times(torch, step, state, batch, args.steps)
                        t0 = time.perf_counter()
                        for _ in range(args.calls):
                            sum_over_ranks_(buf)
                        torch.cuda.synchronize()
                        call_us[name].append((time.perf_counter() - t0) * 1e6 / args.calls)
                        dist.destroy_process_group()
                    finally:
                        for k, v in saved.items():
                            if v is None:
                                os.environ.pop(k, None)
                            else:
                                os.environ[k] = v
            line = {"route": route, "batch": b, "rounds": args.rounds, "steps": args.steps,
                    "step_ms_p50_p75": {k: [float(np.percentile(v, q)) for q in (50, 75)]
                                        for k, v in steps.items()},
                    "sum_over_ranks_us_per_call": {k: float(np.median(v)) for k, v in call_us.items()},
                    "variants": VARIANTS}
            summary[route] = line
            print(json.dumps(line), flush=True)
            del state, step
            torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
