"""The benchmark of `voicesplit_tpu_torch`, the PyTorch and CUDA port, on
NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
its result as the last line of standard output, one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a profiled span of the window, and the
``breakdown``.  Every number that decides ``correct`` is printed beside its
limit, on the last lines of standard error and under ``checks``, the last
key of the result.  Without a card, or with fewer cards than the cell
asks for, it exits with 3 and prints no result; with a module of JAX or of
the JAX package loaded once the window has closed, with 4.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Benchmark of voicesplit_tpu_torch")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.set_environment(cell)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)  # one process with few threads: steadier host timings
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
