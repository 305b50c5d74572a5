#!/usr/bin/env python3
"""Times the port's training CLI on its two data paths at full width on the card.

    python3 scripts/port_data_path_times.py [--seed 0] [--steps 16] [--repeats 2]

Writes `chip_smoke.py`'s synthetic speaker-per-directory corpus and its
preprocessed triplets (`cli.preprocess` on the card) into a temporary
directory, then runs `cli.train.main` at `configs/voicesplit.json` (bf16,
B=2, library convs, summaries every step, no checkpoint) four ways: over
the triplets through the native loader or ``--online --emb_mode spectral``,
each with the regularizers off and on (dropout and SpecAugment at
`chip_smoke.py`'s ONLINE_DROPOUT and ONLINE_SPEC_AUG).  Each way runs
`--repeats` times, the order of the four reversed on every other round.
Prints one JSON line a run (step p50 and p75 between summaries, `fit()`'s
wall seconds by activity, its data-wait share) and a last line with each
way's median p50 and median data-wait share.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repository root, after the path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("port_data_path_times: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.cli.train import main as train_main

    smi = cs.phase_device(torch)  # the card's name and power limit
    sa_time, sa_freq = cs.ONLINE_SPEC_AUG
    regularizers = {"off": {}, "on": {"dropout": cs.ONLINE_DROPOUT, "spec_aug_time": sa_time,
                                      "spec_aug_freq": sa_freq}}
    results: dict = {}
    with tempfile.TemporaryDirectory(prefix="voicesplit_data_path_") as name:
        tmp = Path(name)
        mixed, _ = cs._preprocessed(tmp, args.seed)
        corpus = cs._speaker_corpus(tmp, args.seed)
        ways = []
        for data in ("triplets", "online"):
            for reg, fields in regularizers.items():
                config_path, _ = cs._corpus_config(
                    tmp, args.seed, corpus if data == "online" else mixed / "train",
                    mixed / "test", f"{data}_{reg}.json", checkpoint_interval=10**6, **fields)
                ways.append((f"{data}, regularizers {reg}", config_path, data == "online"))
        for r in range(args.repeats):
            for way, config_path, online in (ways if r % 2 == 0 else ways[::-1]):
                log = tmp / f"run_{len(results.get(way, []))}_{way.replace(', ', '_').replace(' ', '_')}"
                argv = ["-c", config_path, "--logs_path", str(log), "--max_steps", str(args.steps)]
                if online:
                    argv += ["--online", "--emb_mode", "spectral"]
                with cs._route_env("unfused"):
                    result = train_main(argv)
                cs.check(result.get("step") == args.steps and np.isfinite(result["loss"]),
                         f"{way}: {result}")
                p50, p75 = cs._step_ms(log)
                wall = result["wall_seconds"]
                run = {"way": way, "round": r, "step_ms_p50": p50, "step_ms_p75": p75,
                       "wall_seconds": wall, "data_wait_share_of_fit": wall["data"] / wall["fit"],
                       "train_loader": result["train_loader"]}
                results.setdefault(way, []).append(run)
                print(json.dumps(run), flush=True)
    print(smi)
    print(json.dumps({"medians": {
        way: {"step_ms_p50": float(np.median([x["step_ms_p50"] for x in runs])),
              "data_wait_share_of_fit": float(np.median([x["data_wait_share_of_fit"] for x in runs]))}
        for way, runs in results.items()}, "steps": args.steps, "repeats": args.repeats,
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
