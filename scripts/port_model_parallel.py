#!/usr/bin/env python3
"""The gate split over two processes on two cards (NCCL), against the
unsharded step on one.

    python3 scripts/port_model_parallel.py [--seed 0] [--steps 3] [--timed 8]

`configs/voicesplit_wide.json` at full width (bf16, B=2, 3 s clips, library
convs; `chip_smoke.py`'s weights, batch and learning rate).  This process
first trains the unsharded state for `--steps` steps on card 0 and times
`--timed` more; then it starts two ranks, one a card, each joining an NCCL
group through `parallel.initialize_distributed` and splitting the state over
a 1 x 2 mesh (`shard_train_state`: each rank owns half of every split
parameter and of its Adam moments, the slices all-gathered over NCCL before
each step).  The ranks take the same steps on the same batch; rank 0's
losses, parameters, running statistics and moments must equal the unsharded
run's bit for bit.  Prints one JSON line (both runs' step p50 / p75, each
rank's bytes, the launches a step) and the cards' name and power limit.
Needs two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repository root, after the path)


def _setup(torch, seed: int):
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor

    config = load_config(str(ROOT / cs.WIDE_CONFIG))
    config.train_config.learning_rate = cs.TRAIN_LR
    ap = make_audio_processor(config)
    n = int(config.audio.audio_len * ap.sample_rate)
    b = config.train_config.batch_size
    return config, ap, cs.train_batch(seed + b, b, n, ap.sample_rate, config.model.emb_dim)


def _run(torch, config, ap, batch, seed: int, steps: int, timed: int, mesh=None) -> dict:
    """`steps` counted steps (with `mesh`, the state split over it), then
    `timed` timed ones; the losses, launches and the state's bits."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.ops import conv_cuda, conv_fused, lstm_cuda
    from voicesplit_tpu_torch.parallel import shard_train_state
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    modules = (lstm_cuda, conv_fused, conv_cuda)
    model = weights.init_random_(make_masknet(config), seed)
    state = create_train_state(model, make_optimizer(config, model))
    if mesh is not None:
        state = shard_train_state(state, mesh)
    step = make_train_step(config, model, ap, state.optimizer)
    losses, launches = [], []
    for _ in range(steps):
        cs._reset_counts(torch, *modules)
        losses.append(float(step(state, batch)["loss"]))
        counted = cs._counts(torch, *modules)
        launches.append(cs._check_routes(lstm_cuda, counted, "model parallel", cs.WIDE_ROUTES))
    bits = cs._state_bits(torch, state)  # a collective under the split
    times = cs._step_times(torch, step, state, batch, timed)
    out = {"losses": losses, "launches_per_step": {k: v for k, v in launches[0].items() if v},
           "same_launches_every_step": all(c == launches[0] for c in launches),
           "step_ms_p50": float(np.percentile(times, 50)),
           "step_ms_p75": float(np.percentile(times, 75)),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "bits": bits}
    if state.shards is not None:
        out["bytes"] = state.shards.bytes(state.optimizer)
    return out


def _rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    from voicesplit_tpu_torch.device import set_fp32_precision
    from voicesplit_tpu_torch.parallel import initialize_distributed, make_mesh

    set_fp32_precision()
    torch.backends.cudnn.deterministic = True
    initialize_distributed(f"localhost:{args.port}", 2, args.rank, device=f"cuda:{args.rank}")
    try:
        mesh = make_mesh(model=2)
        config, ap, batch = _setup(torch, args.seed)
        res = _run(torch, config, ap, batch, args.seed, args.steps, args.timed, mesh)
        if args.rank == 0:
            torch.save(res, args.out)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--timed", type=int, default=8)
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--out", type=str, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("port_model_parallel: needs two CUDA devices", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.device import set_fp32_precision

    set_fp32_precision()
    torch.backends.cudnn.deterministic = True
    smi = cs.phase_device(torch)
    config, ap, batch = _setup(torch, args.seed)
    ref = _run(torch, config, ap, batch, args.seed, args.steps, args.timed)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="voicesplit_mp_") as tmp:
        out = os.path.join(tmp, "rank0.pt")
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--port", str(port),
                                   "--out", out, "--seed", str(args.seed), "--steps",
                                   str(args.steps), "--timed", str(args.timed)], cwd=str(ROOT))
                 for r in range(2)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        cs.check(codes == [0, 0], f"ranks exited {codes}")
        split = torch.load(out, weights_only=False)
    differ = cs._bits_differ(torch, split.pop("bits"), ref.pop("bits"))
    same = split["losses"] == ref["losses"] and not differ
    print(json.dumps({"config": cs.WIDE_CONFIG, "mesh": "1x2, NCCL, one card a rank",
                      "same_bits_as_unsharded": same, "differ": differ[:8],
                      "unsharded": ref, "split_rank0": split}))
    print(smi)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
