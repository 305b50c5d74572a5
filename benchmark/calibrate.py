"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 1] [--control 1]
        [--witness 1]

A cell that ``BENCHMARK.json`` does not list is named
``<config>.<traffic>``.  For each seed, in one process: the cell's set-up
and a short window at its own load through the harness's run loops, then
the numbers that decide ``correct`` for

- ``program``: the program against the reference (the lower reading is
  their largest over a dozen seeds or more);
- ``fp8`` (with ``--control 1``): the control, the reference computed in
  fp8 put in the program's place (the upper reading is its smallest);
- ``bf16`` (with ``--control 1``): the reference computed in the
  configurations' bf16, for comparison;
- ``half_batch`` (training cells, with ``--control 1``): the reference fed
  only the first half of each batch, the mean taken over it, put in the
  program's place: the planted fault "half of the batch left out";
- ``program_fp32`` and ``program_library`` (training cells, with
  ``--witness 1``): the program again from the same seed, once with the
  configuration's compute dtype set to float32 and once in bf16 with the
  fused conv chain off (the library route), for a look at where a gap of
  the program comes from.

Beside them (``<side>_details``), for a look at where a number comes
from: the loss gap of each step and the worst leaf of the gradient and of
the change with its gap, or each checked row's waveform gap.  One JSON
line a seed on standard output.  Needs a card, as the runs do.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import checks  # noqa: E402
import harness  # noqa: E402


def details(program: dict, reference: dict) -> dict:
    """Each step's loss gap; per counted leaf the gradient's gap of norms
    (``grad``), its norm of the difference (``grad_diff``) and the change's
    gap of norms (``change``), and the worst leaf of each."""
    gaps = checks.train_gaps(program, reference)
    diff = checks.grad_gaps(program["grad"], reference["grad"])
    gaps["grad_diff"] = {k: v for k, v in diff.items() if k in gaps["grad"]}
    out = {"loss_gaps": [abs(p - r) / abs(r) for p, r in
                         zip(program["losses"], reference["losses"])]}
    for key, g in gaps.items():
        worst = max(g, key=g.get)
        out[f"{key}_worst_leaf"] = [worst, g[worst]]
        out[f"{key}_gaps"] = {k: round(v, 5) for k, v in g.items()}
    out["quiet_leaves"] = sorted(set(reference["grad"]) - set(gaps["grad"]))
    return out


def row_gaps(program: dict, reference: dict) -> list:
    """The waveform gap of each checked row."""
    return [checks.wave_gap(p[None], r[None]) for p, r in zip(program["waves"], reference["waves"])]


def witnesses(cell, seed: int, seconds: float, program) -> dict:
    """The program's readings from the same seed on two other paths: the
    configuration's compute dtype set to float32, and bf16 with the fused
    conv chain off.  The program reads the switch at each call."""
    import torch

    out = {}
    fp32 = copy.copy(cell)
    fp32.config = copy.deepcopy(cell.config)
    fp32.config["train_config"]["compute_dtype"] = "float32"
    saved = os.environ["VOICESPLIT_FUSED_CHAIN"]
    for name, c, chain in (("program_fp32", fp32, saved), ("program_library", cell, "0")):
        os.environ["VOICESPLIT_FUSED_CHAIN"] = chain
        run = harness.drive_train(c, seed, seconds, False, "cuda", time.perf_counter(), program)
        out[name] = run.readings
        del run
        torch.cuda.empty_cache()
    os.environ["VOICESPLIT_FUSED_CHAIN"] = saved
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--control", type=int, default=1)
    parser.add_argument("--witness", type=int, default=0)
    args = parser.parse_args(argv)
    try:
        cell = harness.Cell(args.workload)
    except KeyError:  # a cell not listed yet: <config>.<traffic>
        cell = harness.Cell.unlisted(args.workload)
    harness.set_environment(cell)

    import torch

    import program

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 3
    drive = harness.drive_train if cell.train else harness.drive_serve
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = drive(cell, seed, args.seconds, False, "cuda", t0, program)
        setup_s = run.setup_s
        torch.cuda.empty_cache()
        ref = harness.reference_readings(cell, seed, run, "cuda")
        unit = None if cell.train else harness.reference_readings(cell, seed, run, "cuda", "bf16")
        line = {"cell": cell.name, "seed": seed, "setup_s": setup_s,
                "attempted": run.attempted, "window_s": run.window_s}
        sides = {"program": run.readings}
        if args.control:
            for name in ("bf16", "fp8"):
                sides[name] = harness.reference_readings(cell, seed, run, "cuda", name)
            if cell.train:
                sides["half_batch"] = harness.reference_readings(
                    cell, seed, run, "cuda", rows=slice(0, cell.batch // 2))
        if args.witness and cell.train:
            sides.update(witnesses(cell, seed, args.seconds, program))
        for name, side in sides.items():
            line[name] = harness.readings_against(cell, side, ref, unit)
            line[name + "_details"] = details(side, ref) if cell.train else row_gaps(side, ref)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run, sides
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
