#!/usr/bin/env python3
"""Where a step of the port's forward LSTM walk spends its cycles, on the card.

    python3 scripts/port_lstm_phases.py [--root DIR] [--work DIR] [--tag NAME]

Copies DIR's `voicesplit_tpu_torch` (default: this checkout's) into WORK
(default: ``compare/phases-<tag>``, git-ignored), adds ``clock64()``
counters to the copy's `csrc/lstm_fwd.cu` (thread 0 and thread 352, the
first warp and the last, of block 0; the steps after the first) and a C
entry that reads them, builds the copy and runs ``lstm_fwd`` at B=1 and B=2
and ``bilstm_fwd`` at B=8 and B=24 (T=301, H=400, bf16 and fp32).  Prints
one JSON line per case: its time (CUDA events, the mean of 10 calls, with
the counters in: a little above the kernel's own) and the mean cycles a
step of

- ``wait``: waiting for h[t-1] on the mbarrier;
- ``product``: the step's product, up to this thread's last partial (bf16;
  fp32 counts it under ``sync``);
- ``sync``: the __syncthreads that completes the product;
- ``cell``: the cell update and the __syncthreads after it;
- ``send``: sending h[t] and loading the next step's xp.

The counters are patched into the copy at fixed places of the walk's source
(the script stops if one is not found), so they time the tree as it is;
the checkout itself is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

T_FRAMES, HIDDEN = 301, 400
CASES = (("lstm_fwd", 1, 1), ("lstm_fwd", 1, 2), ("bilstm_fwd", 2, 8), ("bilstm_fwd", 2, 24))
PHASES = ("wait", "product", "sync", "cell", "send")

# (text of the walk, text that replaces it)
PATCHES = (
    ("namespace cg = cooperative_groups;\n\nnamespace {",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_phases[8];\n\nnamespace {"),
    ("  uint32_t parity = 0;  // bit x: parity of slot x's phase to wait for\n"
     "  for (int t = 0; Uk > 0 && t < T_; ++t) {",
     "  uint32_t parity = 0;  // bit x: parity of slot x's phase to wait for\n"
     "  unsigned long long pa[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long tA, tB, tC, tD, tS, tP = 0;\n"
     "  for (int t = 0; Uk > 0 && t < T_; ++t) {\n"
     "    tA = clock64();"),
    ("    const T* hin = recv + in_slot * slot;",
     "    tB = clock64();\n    tP = tB;\n    const T* hin = recv + in_slot * slot;"),
    ("    } else {\n      // 2: pre[r][q] = sum_k",
     "      tP = clock64();\n    } else {\n      // 2: pre[r][q] = sum_k"),
    ("    __syncthreads();  // the product complete",
     "    __syncthreads();  // the product complete\n    tC = clock64();"),
    ("    __syncthreads();  // the stage is complete; every read of the product and of slot in_slot is done",
     "    __syncthreads();  // the stage is complete; every read of the product and of slot in_slot is done\n"
     "    tD = clock64();"),
    ("    if (t + 1 < T_) prefetch(t + 1);  // loads while h travels\n",
     "    if (t + 1 < T_) prefetch(t + 1);  // loads while h travels\n"
     "    tS = clock64();\n"
     "    if (t > 0) { pa[0] += tB - tA; pa[1] += tP - tB; pa[2] += tC - tP; pa[3] += tD - tC;"
     " pa[4] += tS - tD; pa[5] += 1; }\n"),
    ("  cluster.sync();  // no block leaves while a peer may still write to it",
     "  if (blockIdx.x == 0 && tid == 0) for (int i = 0; i < 5; ++i) g_phases[i] = pa[i] / (pa[5] ? pa[5] : 1);\n"
     "  if (blockIdx.x == 0 && tid == 352) for (int i = 0; i < 3; ++i) g_phases[5 + i] = pa[i] / (pa[5] ? pa[5] : 1);\n"
     "  cluster.sync();  // no block leaves while a peer may still write to it"),
)
READER = """
extern "C" int lstm_fwd_phases(unsigned long long* host) {
  return cudaMemcpyFromSymbol(host, g_phases, sizeof(unsigned long long) * 8);
}
"""


def patch(src: Path) -> None:
    text = src.read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise SystemExit(f"port_lstm_phases: {src} does not hold the walk this script patches:\n{old}")
        text = text.replace(old, new)
    src.write_text(text + READER)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    repo = Path(__file__).resolve().parents[1]
    parser.add_argument("--root", default=str(repo))
    parser.add_argument("--tag", default="this")
    parser.add_argument("--work", default=None)
    args = parser.parse_args(argv)
    work = Path(args.work or repo / "compare" / f"phases-{args.tag}").resolve()
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(Path(args.root).resolve() / "voicesplit_tpu_torch", work / "voicesplit_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    patch(work / "voicesplit_tpu_torch" / "csrc" / "lstm_fwd.cu")
    sys.path.insert(0, str(work))

    import torch

    if not torch.cuda.is_available():
        print("port_lstm_phases: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.ops import lstm_cuda

    lib = lstm_cuda._library()
    lib.lstm_fwd_phases.argtypes = [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    buf = (ctypes.c_ulonglong * 8)()
    T, H = T_FRAMES, HIDDEN
    g = torch.Generator().manual_seed(0)
    for name, D, B in CASES:
        for dt in (torch.bfloat16, torch.float32):
            R = D * B
            xp = torch.randn(T, R, 4 * H, generator=g).to("cuda", dt)
            ws = [(torch.rand(H, 4 * H, generator=g) * 0.1 - 0.05).to("cuda", dt) for _ in range(2)]
            h0 = torch.zeros(R, H, device="cuda")
            c0 = torch.zeros_like(h0)
            if D == 1:
                run = lambda: lstm_cuda.lstm_fwd(xp, ws[0], h0, c0)  # noqa: E731
            else:
                run = lambda: lstm_cuda.bilstm_fwd(xp, ws[0], ws[1])  # noqa: E731
            with torch.inference_mode():
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    run()
                end.record()
                end.synchronize()
            lstm_cuda._raise_on(lib.lstm_fwd_phases(ctypes.addressof(buf)), "lstm_fwd_phases")
            cycles = list(buf)
            print(json.dumps({
                "tag": args.tag, "root": str(Path(args.root).resolve()), "nvidia_smi": smi,
                "kernel": name, "batch": B, "dtype": str(dt).removeprefix("torch."),
                "ms_with_counters": start.elapsed_time(end) / 10,
                "cycles_a_step_thread0": dict(zip(PHASES, cycles[:5])),
                "cycles_a_step_thread352": dict(zip(PHASES[:3], cycles[5:8])),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
