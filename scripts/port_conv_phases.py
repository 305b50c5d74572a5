#!/usr/bin/env python3
"""Cycles a step of the wide-tile conv kernels on the card, by phase.

    python3 scripts/port_conv_phases.py [--root DIR] [--tag NAME]

Copies DIR's `voicesplit_tpu_torch` (default: this checkout's) to
``DIR/build/phases/`` (git-ignored), patches ``clock64()`` counters into the
copy's `csrc/conv_fwd_wide.cu` and `csrc/conv_wgrad_wide.cu`, builds it there
and runs CASES: ``conv_dilated_fwd`` and ``conv_dilated_wgrad`` on ``[2, 301,
601, Cin]`` bf16 (``Cout`` out) at 128 -> 128 ((5,5) d1 and (7,1)) and 256
-> 256 ((5,5) d1), and the shapes slower than the route before the wide
tiles: the forward at 128 -> 64 (the n64 tile; beside it 64 -> 128, the
same products on the n128 tile) on (5,5) d1, the weight gradient at 64 ->
128 and 192 -> 192 on (7,1).  Thread 0
and thread 128 (one of each warpgroup) of every block add the cycles
between marks into phases, and the means over those threads print as one
JSON line a kernel and shape, in total and per step (a forward sub-step:
one (time tap, frequency tap) weight slice; a weight-gradient item):

- forward: ``loads+misc`` (the copies' issue after the barrier, the loop),
  ``wait_data`` (the slice's, and at a unit's start the rows', mbarriers),
  ``mma_issue`` (the products' issue, which waits on the tensor cores'
  queue), ``wgmma_wait`` (the previous sub-step's products), ``barrier``,
  ``end_wait`` and ``epilogue+``;
- weight gradient: ``loads+misc``, ``wait_data``, ``decode+flush`` (the
  segment's tiles written at a segment change), ``mma_issue``,
  ``wgmma_wait``, ``barrier``.

The counters add instructions, so the total runs a little slower than the
kernel alone (`scripts/port_conv_times.py`).  The patch matches the source
text of this PR's kernels; a tree whose kernels differ raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

HEAD = """namespace {
__device__ unsigned long long g_phase[1024][10];
}
extern "C" int %s(unsigned long long* out, int n) {
  return cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 10 * n);
}
namespace {

using bf16 = __nv_bfloat16;
#define TICK(k) do { if (threadIdx.x == 0 || threadIdx.x == 128) { \\
  const unsigned long long _c = clock64(); _tp[k] += _c - _tl; _tl = _c; } } while (0)"""

TAIL = """
  TICK(7);
  if (threadIdx.x == 0 || threadIdx.x == 128) {
    unsigned long long* o = g_phase[blockIdx.x %% 512 * 2 + (threadIdx.x >> 7)];
    for (int k = 0; k < 7; ++k) o[k] = _tp[k];
    o[6] += _tp[7];
    o[7] = clock64() - _t0;
    o[8] = n;
    o[9] = %s;
  }"""

STEP = "  unsigned long long _tp[8] = {0, 0, 0, 0, 0, 0, 0, 0}, _tl = clock64(), _t0 = _tl;\n"

FWD = [
    ("  const int subs = kt * KF;  // sub-steps of a unit\n",
     "  const int subs = kt * KF;  // sub-steps of a unit\n" + STEP),
    ("          // this sub-step's slice (and, at a unit's start, the unit's rows) landed\n", "          TICK(0);\n"),
    ("          mbar_wait(bar_w + (sig % W) * 8, (sig / W) & 1);\n",
     "          mbar_wait(bar_w + (sig % W) * 8, (sig / W) & 1);\n          TICK(1);\n"),
    ("          wgmma_wait<1>();\n          __syncthreads();\n          if (sig + D < total) load_slice();",
     "          TICK(2);\n          wgmma_wait<1>();\n          TICK(3);\n          __syncthreads();\n          TICK(4);\n"
     "          if (sig + D < total) load_slice();"),
    ("    wgmma_wait<0>();\n\n    // epilogue", "    TICK(0);\n    wgmma_wait<0>();\n    TICK(5);\n\n    // epilogue"),
]
WGRAD = [
    ("  const int row_elems = w.seg_tiles * kC * N;  // a partial row\n",
     "  const int row_elems = w.seg_tiles * kC * N;  // a partial row\n" + STEP),
    ("    mbar_wait(smem_addr(bars + k % wide::kStages), (k / wide::kStages) & 1);  // item k has landed\n",
     "    TICK(0);\n    mbar_wait(smem_addr(bars + k % wide::kStages), (k / wide::kStages) & 1);  // item k has landed\n"
     "    TICK(1);\n"),
    ("    // A = y^T of each tile", "    TICK(5);\n    // A = y^T of each tile"),
    ("    // item k - 1's products are done everywhere: its stage takes item k + 2\n    // while item k's run\n"
     "    wgmma_wait<1>();\n    __syncthreads();\n",
     "    TICK(2);\n    wgmma_wait<1>();\n    TICK(3);\n    __syncthreads();\n    TICK(4);\n"),
]
# (kernels, Cin, Cout, (kt, kf)), each at time dilation 1
CASES = (
    (("fwd", "wgrad"), 128, 128, (5, 5)), (("fwd", "wgrad"), 128, 128, (7, 1)), (("fwd", "wgrad"), 256, 256, (5, 5)),
    (("fwd",), 128, 64, (5, 5)), (("fwd",), 64, 128, (5, 5)), (("wgrad",), 64, 128, (7, 1)),
    (("wgrad",), 192, 192, (7, 1)),
)
NAMES = {
    "conv_fwd_phases": ["loads+misc", "wait_data", "mma_issue", "wgmma_wait", "barrier", "end_wait",
                        "epilogue+", "total", "items", "steps"],
    "conv_wgrad_phases": ["loads+misc", "wait_data", "mma_issue", "wgmma_wait", "barrier", "decode+flush",
                          "end+", "total", "items", "steps"],
}


def patch(src: Path, symbol: str, reps, body_end_anchor: str, steps: str) -> None:
    s = src.read_text()
    for old, new in [("namespace {\n\nusing bf16 = __nv_bfloat16;", HEAD % symbol), *reps]:
        if s.count(old) != 1:
            raise SystemExit(f"port_conv_phases: {src.name} does not hold {old[:60]!r} once")
        s = s.replace(old, new)
    end = s.rindex("\n}\n", 0, s.index(body_end_anchor))  # the kernel body's closing brace
    src.write_text(s[:end] + TAIL % steps + s[end:])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--tag", default="")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    copy = root / "build" / "phases"
    shutil.rmtree(copy, ignore_errors=True)
    copy.mkdir(parents=True)
    shutil.copytree(root / "voicesplit_tpu_torch", copy / "voicesplit_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = copy / "voicesplit_tpu_torch" / "csrc"
    patch(csrc / "conv_fwd_wide.cu", "conv_fwd_phases", FWD,
          "template <int KF, int N>\n__global__ void __launch_bounds__(kThreads, 1)\nconv_dilated_fwd_wide_kernel",
          "sig")
    patch(csrc / "conv_wgrad_wide.cu", "conv_wgrad_phases", WGRAD, "// The segments' description", "n")
    sys.path.insert(0, str(copy))

    import torch

    if not torch.cuda.is_available():
        print("port_conv_phases: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.ops import _build
    from voicesplit_tpu_torch.ops import conv_cuda as cc

    if not Path(cc.__file__).resolve().is_relative_to(copy):
        print(f"port_conv_phases: imported {cc.__file__}, not the patched copy", file=sys.stderr)
        return 1
    lib = _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()

    def read(symbol: str) -> dict:
        buf = (ctypes.c_ulonglong * (1024 * 10))()
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        _build.raise_on(fn(ctypes.addressof(buf), 1024), symbol)
        rows = [[buf[r * 10 + k] for k in range(10)] for r in range(1024)]
        rows = [r for r in rows if r[7] > 0]
        mean = [sum(r[k] for r in rows) / len(rows) for k in range(10)]
        names = NAMES[symbol]
        return {"cycles": {n: round(m) for n, m in zip(names, mean)},
                "per_step": {n: round(m / mean[9]) for n, m in zip(names[:8], mean[:8])}}

    g = torch.Generator().manual_seed(0)
    out = {}
    for kernels, cin, cout, (kt, kf) in CASES:
        x = torch.randn(2, 301, 601, cin, generator=g).to("cuda", torch.bfloat16)
        d = torch.randn(2, 301, 601, cout, generator=g).to("cuda", torch.bfloat16)
        w = (torch.randn(kt, kf, cin, cout, generator=g) * (kt * kf * cin) ** -0.5).to("cuda", torch.bfloat16)
        width = str(cin) if cin == cout else f"{cin}-{cout}"
        with torch.inference_mode():
            if "fwd" in kernels:
                for _ in range(3):
                    cc.conv_dilated_fwd(x, w, 1)
                torch.cuda.synchronize()
                out[f"conv_dilated_fwd/{width}/{kt}x{kf}"] = read("conv_fwd_phases")
            if "wgrad" in kernels:
                for _ in range(3):
                    cc.conv_dilated_wgrad(x, d, kt, kf, 1)
                torch.cuda.synchronize()
                out[f"conv_dilated_wgrad/{width}/{kt}x{kf}"] = read("conv_wgrad_phases")
        del x, d, w
        torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "root": str(root), "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "phases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
