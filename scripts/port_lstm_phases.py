#!/usr/bin/env python3
"""Where a step of the port's forward LSTM walks spends its cycles, on the card.

    python3 scripts/port_lstm_phases.py [--root DIR] [--work DIR] [--tag NAME]
        [--walks cluster,split,split_bwd,grid,grid_bwd]

Copies DIR's `voicesplit_tpu_torch` (default: this checkout's) into WORK
(default: ``compare/phases-<tag>``, git-ignored), adds ``clock64()``
counters to the copy's `csrc/lstm_fwd.cu` (and, where the tree has the
backward's split walk, `csrc/lstm_bwd.cu`) and C entries that read them,
builds the copy and runs each walk (the steps after the first; CUDA events
around 10 calls with the counters in, a little above the kernel's own time).
Prints one JSON line per case with the mean cycles a step of each phase.

The cluster walk (``lstm_fwd_kernel``; ``lstm_fwd`` at B=1 and B=2,
``bilstm_fwd`` at B=8 and B=24; T=301, H=400, bf16 and fp32), thread 0 and
thread 352 (the first warp and the last) of block 0:

- ``wait``: waiting for h[t-1] on the mbarrier;
- ``product``: the step's product, up to this thread's last partial (bf16;
  fp32 counts it under ``sync``);
- ``sync``: the __syncthreads that completes the product;
- ``cell``: the cell update and the __syncthreads after it;
- ``send``: sending h[t] and loading the next step's xp.

The split walk (``lstm_fwd_split_kernel``, where the tree has it;
``lstm_fwd`` at B=1 and B=2, ``bilstm_fwd`` at B=8; T=301, H=800, bf16),
thread 0 of block 0 (the first cluster of the pair), thread 352 of block 0
(the warp that publishes h to the other cluster) and thread 0 of block 16
(the second cluster):

- ``wait``: waiting for this cluster's h[t-1] on the mbarrier;
- ``product_local``: the product's k-steps issued before the other
  cluster's h is needed;
- ``counter``: thread 0 spinning on the other cluster's counter and issuing
  the bulk copy of its h (the other threads pass at once);
- ``copy``: waiting for that copy on the mbarrier;
- ``product``: the rest of the product, up to the accumulators' wait;
- ``partials``: the warpgroups' partials into shared memory and the
  __syncthreads that completes them;
- ``cell``: the cell update and the __syncthreads after it;
- ``send``: sending h[t] (thread 0: to this cluster's owners by st.async;
  thread 352: to the pair's global slot, then the counter) and loading the
  next step's xp.

The backward's split walk (``lstm_bwd_split_kernel``, where the tree has
it; ``lstm_bwd`` at B=2, ``bilstm_bwd`` at B=8; T=301, H=800, bf16, on the
plain forward's outputs), thread 0 and thread 256 (the first warp that
writes to the global slot) of block 0 and thread 0 of block 16:

- ``receive``: waiting for step s+1's partials: this cluster's on the
  mbarrier, the other cluster's counter and bulk copy;
- ``dgates``: adding each unit's partials and computing its dgates;
- ``sync``: the __syncthreads before the product;
- ``product``: issuing the product and waiting for it;
- ``stage``: the partials into shared memory and the __syncthreads after;
- ``send``: sending them (warps 0-7 by st.async, 8-11 to the global slot,
  then the counter) and loading the next step's inputs.

The grid routes (``lstm_fwd_grid_kernel``: ``lstm_fwd`` at [80, 96], [80,
32] and [80, 16], H=768, fp32, the GE2E encoder's shapes, and at B=1,
T=301, H=800, fp32; ``lstm_bwd_grid_kernel``: ``lstm_bwd`` at [80, 96],
H=768, fp32, and at B=2, T=301, H=800, fp32, ``bilstm_bwd`` at B=24, T=301,
H=800, bf16; on the plain forward's outputs), thread 0 and thread 255 of
block 0, cycles a step of:

- ``stage``: staging the step's row operand (h[t-1], or dgates[t+1]) into
  shared memory, with the waits and barriers that complete it (after the
  redesign: issuing the copies, and waiting for those the product has not
  hidden);
- ``product``: the product over the staged rows and, before the redesign,
  the barriers after it;
- ``cell``: the cell update (forward) or the dgates of the block's units
  (backward), after the redesign with the warps' partials and their
  barriers;
- ``barrier``: the grid-wide barrier that ends the step.

The counters are patched into the copy at fixed places of each walk's
source (the script stops if one is not found), so they time the tree as it
is; the checkout itself is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

T_FRAMES = 301
CLUSTER_CASES = (("lstm_fwd", 1, 1), ("lstm_fwd", 1, 2), ("bilstm_fwd", 2, 8), ("bilstm_fwd", 2, 24))
SPLIT_CASES = (("lstm_fwd", 1, 1), ("lstm_fwd", 1, 2), ("bilstm_fwd", 2, 8))
PHASES = ("wait", "product", "sync", "cell", "send")
SPLIT_PHASES = ("wait", "product_local", "counter", "copy", "product", "partials", "cell", "send")
BWD_CASES = (("lstm_bwd", 1, 2), ("bilstm_bwd", 2, 8))
BWD_PHASES = ("receive", "dgates", "sync", "product", "stage", "send")
BWD_GLOBALS = ("namespace cg = cooperative_groups;\n\nnamespace {",
               "namespace cg = cooperative_groups;\n__device__ unsigned long long g_bwd_split[24];\n\nnamespace {")
BWD_REGION = ("lstm_bwd_split_kernel(const __nv_bfloat16* __restrict__ w0", "// The grid route")
BWD_PATCHES = (
    ("  for (int s = m >= 0 ? T_ - 1 : -1; s >= 0; --s) {\n    const float* in = s < T_ - 1 ? receive(s + 1) : nullptr;",
     "  unsigned long long pa[7] = {0, 0, 0, 0, 0, 0, 0};\n  long long t0, t1, t2, t3, t4, t5, t6;\n"
     "  for (int s = m >= 0 ? T_ - 1 : -1; s >= 0; --s) {\n    t0 = clock64();\n"
     "    const float* in = s < T_ - 1 ? receive(s + 1) : nullptr;\n    t1 = clock64();"),
    ("    fence_proxy_async();  // dgb written here; wgmma reads it through the async proxy\n"
     "    __syncthreads();      // dgates[s] complete; every read of the slot is done",
     "    t2 = clock64();\n    fence_proxy_async();  // dgb written here; wgmma reads it through the async proxy\n"
     "    __syncthreads();      // dgates[s] complete; every read of the slot is done\n    t3 = clock64();"),
    ("    wgmma_commit();\n    wgmma_wait<0>();\n", "    wgmma_commit();\n    wgmma_wait<0>();\n    t4 = clock64();\n"),
    ("    __syncthreads();  // the partials staged\n", "    __syncthreads();  // the partials staged\n    t5 = clock64();\n"),
    ("    // 5: the next step's inputs load while the partials travel\n    if (s > 0) prefetch(s - 1);\n",
     "    // 5: the next step's inputs load while the partials travel\n    if (s > 0) prefetch(s - 1);\n"
     "    t6 = clock64();\n"
     "    if (s < T_ - 1 && s > 0) { pa[0] += t1 - t0; pa[1] += t2 - t1; pa[2] += t3 - t2; pa[3] += t4 - t3;"
     " pa[4] += t5 - t4; pa[5] += t6 - t5; pa[6] += 1; }\n"),
    ("  cluster.sync();  // no block leaves while a peer may still write to it\n}",
     "  {\n    const int at = blockIdx.x == 0 && tid == 0 ? 0 : blockIdx.x == 0 && tid == 256 ? 8"
     " : blockIdx.x == kCluster && tid == 0 ? 16 : -1;\n"
     "    if (at >= 0) for (int i = 0; i < 6; ++i) g_bwd_split[at + i] = pa[i] / (pa[6] ? pa[6] : 1);\n  }\n"
     "  cluster.sync();  // no block leaves while a peer may still write to it\n}"),
)
BWD_READER = """
extern "C" int lstm_bwd_split_phases(unsigned long long* host) {
  return cudaMemcpyFromSymbol(host, g_bwd_split, sizeof(unsigned long long) * 24);
}
"""

GLOBALS = ("namespace cg = cooperative_groups;\n\nnamespace {",
           "namespace cg = cooperative_groups;\n__device__ unsigned long long g_phases[8];\n"
           "__device__ unsigned long long g_split[24];\n\nnamespace {")
# The cluster walk's region of the source, and (text of the walk, text that
# replaces it) within it
CLUSTER_REGION = ("lstm_fwd_kernel(const T* __restrict__ xp", "// The split walk")
PATCHES = (
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
# the split walk's
SPLIT_REGION = ("lstm_fwd_split_kernel(const __nv_bfloat16* __restrict__ xp", "// The grid route")
SPLIT_PATCHES = (
    ("  uint32_t parity = 0;  // bit x: parity of barrier x's phase to wait for\n"
     "  for (int t = 0; m >= 0 && t < T_; ++t) {",
     "  uint32_t parity = 0;  // bit x: parity of barrier x's phase to wait for\n"
     "  unsigned long long pa[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long tA, tB, tE0, tE1, tE2, tW, tC, tD, tS;\n"
     "  for (int t = 0; m >= 0 && t < T_; ++t) {\n"
     "    tA = clock64();"),
    ("    T* hin = recv + in_slot * slot;",
     "    tB = clock64();\n    tE0 = tE1 = tE2 = tB;\n    T* hin = recv + in_slot * slot;"),
    ("      const int rb = 2 + in_slot;\n", "      const int rb = 2 + in_slot;\n      tE0 = clock64();\n"),
    ("      bar_wait_asm(bars + rb, ",
     "      tE1 = clock64();\n      bar_wait_asm(bars + rb, "),
    ("      parity ^= uint32_t(go) << rb;\n",
     "      parity ^= uint32_t(go) << rb;\n      tE2 = clock64();\n"),
    ("    wgmma_wait<0>();\n", "    wgmma_wait<0>();\n    tW = clock64();\n"),
    ("    __syncthreads();  // the product complete",
     "    __syncthreads();  // the product complete\n    tC = clock64();"),
    ("    __syncthreads();  // the stage is complete; every read of the product and of slot in_slot is done",
     "    __syncthreads();  // the stage is complete; every read of the product and of slot in_slot is done\n"
     "    tD = clock64();"),
    ("    if (t + 1 < T_) prefetch(t + 1);  // loads while h travels\n",
     "    if (t + 1 < T_) prefetch(t + 1);  // loads while h travels\n"
     "    tS = clock64();\n"
     "    if (t > 0) { pa[0] += tB - tA; pa[1] += tE0 - tB; pa[2] += tE1 - tE0; pa[3] += tE2 - tE1;"
     " pa[4] += tW - tE2; pa[5] += tC - tW; pa[6] += tD - tC; pa[7] += tS - tD; pa[8] += 1; }\n"),
    ("  cluster.sync();  // no block leaves while a peer may still write to it",
     "  {\n    const int at = blockIdx.x == 0 && tid == 0 ? 0 : blockIdx.x == 0 && tid == 352 ? 8"
     " : blockIdx.x == kCluster && tid == 0 ? 16 : -1;\n"
     "    if (at >= 0) for (int i = 0; i < 8; ++i) g_split[at + i] = pa[i] / (pa[8] ? pa[8] : 1);\n  }\n"
     "  cluster.sync();  // no block leaves while a peer may still write to it"),
)
READER = """
extern "C" int lstm_fwd_phases(unsigned long long* host) {
  return cudaMemcpyFromSymbol(host, g_phases, sizeof(unsigned long long) * 8);
}
extern "C" int lstm_fwd_split_phases(unsigned long long* host) {
  return cudaMemcpyFromSymbol(host, g_split, sizeof(unsigned long long) * 24);
}
"""


# the grid routes' cases: (directions, rows a direction, H, T, operand type):
# the GE2E encoder's (H=768), then fp32 at H=800 and two directions of 24
# rows in bf16 at H=800 (the split walk's clusters not all resident)
GRID_CASES = ((1, 96, 768, 80, "float32"), (1, 32, 768, 80, "float32"), (1, 16, 768, 80, "float32"),
              (1, 1, 800, 301, "float32"))
GRID_BWD_CASES = ((1, 96, 768, 80, "float32"), (1, 2, 800, 301, "float32"), (2, 24, 800, 301, "bfloat16"))
GRID_PHASES = ("stage", "product", "cell", "barrier")
GRID_READER = """
extern "C" int {name}_phases(unsigned long long* host) {{
  return cudaMemcpyFromSymbol(host, g_{name}, sizeof(unsigned long long) * 8);
}}
"""
# the end of a grid kernel's step: the barrier, then the counters of thread
# 0 (slots 0-3) and thread 255 (slots 4-7) of block 0 into g_<name>
_GRID_STORE = ("    gp[3] += clock64() - td_;\n    gp[4] += 1;\n  }}\n"
               "  if (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == 255)) {{\n"
               "    const int at_ = threadIdx.x == 0 ? 0 : 4;\n"
               "    for (int i = 0; i < 4; ++i) g_{name}[at_ + i] = gp[i] / (gp[4] ? gp[4] : 1);\n  }}\n")
# the grid routes before their redesign (the port's first designs): h[t-1]
# or dgates[t+1] staged by plain loads in row chunks, each chunk staged,
# then multiplied
GRID_FIRST = {
    "lstm_fwd_grid": (("lstm_fwd_grid_kernel(const T* __restrict__ xp", "// Launches"), (
        ("  const int group = tid / kLanes, lane = tid % kLanes;\n  for (int t = 0; t < T_; ++t) {\n",
         "  const int group = tid / kLanes, lane = tid % kLanes;\n  unsigned long long gp[5] = {0, 0, 0, 0, 0};\n"
         "  for (int t = 0; t < T_; ++t) {\n"),
        ("      for (int e = tid; e < rc * H; e += kThreads) {\n",
         "      long long ta_ = clock64();\n      for (int e = tid; e < rc * H; e += kThreads) {\n"),
        ("        h_s[e] = round_to<T>(h);\n      }\n      __syncthreads();\n",
         "        h_s[e] = round_to<T>(h);\n      }\n      __syncthreads();\n      long long tb_ = clock64();\n"
         "      gp[0] += tb_ - ta_;\n"),
        ("        if (active && lane == 0) pre_s[size_t(r0) * G + o] = acc;\n      }\n      __syncthreads();\n",
         "        if (active && lane == 0) pre_s[size_t(r0) * G + o] = acc;\n      }\n      __syncthreads();\n"
         "      gp[1] += clock64() - tb_;\n"),
        ("    for (int e = tid; e < R * U; e += kThreads) {\n      const int r = e / U, u = e % U, j = u0 + u;\n"
         "      if (j >= H) continue;\n      const size_t row = size_t(t) * R + r;\n      const T* x",
         "    long long tc_ = clock64();\n"
         "    for (int e = tid; e < R * U; e += kThreads) {\n      const int r = e / U, u = e % U, j = u0 + u;\n"
         "      if (j >= H) continue;\n      const size_t row = size_t(t) * R + r;\n      const T* x"),
        ("    grid.sync();  // the whole h[t] is visible before step t + 1 reads it\n  }\n",
         "    long long td_ = clock64();\n    grid.sync();  // the whole h[t] is visible before step t + 1 reads it\n"
         "    gp[2] += td_ - tc_;\n" + _GRID_STORE.format(name="lstm_fwd_grid")),
    )),
    "lstm_bwd_grid": (("lstm_bwd_grid_kernel(const T* __restrict__ w0", "// Launches"), (
        ("  // s is the step whose dgates are staged; t = s - 1 is the step computed\n",
         "  unsigned long long gp[5] = {0, 0, 0, 0, 0};\n  long long tc_ = 0;\n"
         "  // s is the step whose dgates are staged; t = s - 1 is the step computed\n"),
        ("        for (int e = tid; e < words; e += kThreads) dst[e] = __ldcg(src + e);\n        __syncthreads();\n",
         "        long long ta_ = clock64();\n"
         "        for (int e = tid; e < words; e += kThreads) dst[e] = __ldcg(src + e);\n        __syncthreads();\n"
         "        long long tb_ = clock64();\n        gp[0] += tb_ - ta_;\n"),
        ("        __syncthreads();  // before the next chunk overwrites dg_s\n",
         "        __syncthreads();  // before the next chunk overwrites dg_s\n        gp[1] += clock64() - tb_;\n"),
        ("    // step t = s - 1: own units' columns of dgates[t]\n",
         "    tc_ = clock64();\n    // step t = s - 1: own units' columns of dgates[t]\n"),
        ("    grid.sync();  // the whole dgates[t] is in dxp before any block stages it\n  }\n",
         "    long long td_ = clock64();\n"
         "    grid.sync();  // the whole dgates[t] is in dxp before any block stages it\n"
         "    gp[2] += td_ - tc_;\n" + _GRID_STORE.format(name="lstm_bwd_grid")),
    )),
}

# the redesigned grid routes: the row operand (h[t-1], dgates[t+1]) streamed
# in chunks of k by cp.async, a register-tiled product, the warps' partials
# added in the cell update (lstm_grid.cuh)
GRID_REDESIGN = {
    "lstm_fwd_grid": (("lstm_fwd_grid_kernel(const T* __restrict__ xp", "// Launches"), (
        ("  const int chunks = grid_chunks(H, KC);\n",
         "  const int chunks = grid_chunks(H, KC);\n  unsigned long long gp[5] = {0, 0, 0, 0, 0};\n"),
        ("          grid_stage<float, KC>(a_s, RB, src, H, rows, 0, H, vec, w0);\n          cp_async_commit();\n",
         "          long long ts_ = clock64();\n          grid_stage<float, KC>(a_s, RB, src, H, rows, 0, H, vec, w0);\n"
         "          cp_async_commit();\n          gp[0] += clock64() - ts_;\n"),
        ("            cp_async_wait<0>();\n",
         "            long long ta_ = clock64();\n            cp_async_wait<0>();\n"),
        ("              cp_async_commit();\n            }\n            const int nq",
         "              cp_async_commit();\n            }\n            long long tb_ = clock64();\n"
         "            gp[0] += tb_ - ta_;\n            const int nq"),
        ("            grid_product<LR, KC>(acc, a_s + (ch & 1) * RB * LDA, w + ch * KC, LDW, jn, nq);\n",
         "            grid_product<LR, KC>(acc, a_s + (ch & 1) * RB * LDA, w + ch * KC, LDW, jn, nq);\n"
         "            gp[1] += clock64() - tb_;\n"),
        ("          __syncthreads();  // every warp is done with the chunks, whose bytes take the partials\n",
         "          long long tc_ = clock64();\n"
         "          __syncthreads();  // every warp is done with the chunks, whose bytes take the partials\n"),
        ("          __syncthreads();  // the partials read before the next pass stages into their bytes\n",
         "          __syncthreads();  // the partials read before the next pass stages into their bytes\n"
         "          gp[2] += clock64() - tc_;\n"),
        ("    grid.sync();  // the whole h[t] is visible before step t + 1 reads it\n  }\n",
         "    long long td_ = clock64();\n    grid.sync();  // the whole h[t] is visible before step t + 1 reads it\n"
         + _GRID_STORE.format(name="lstm_fwd_grid")),
    )),
    "lstm_bwd_grid": (("lstm_bwd_grid_kernel(const T* __restrict__ w0", "// Launches"), (
        ("  const int chunks = grid_chunks(G4, KC);\n",
         "  const int chunks = grid_chunks(G4, KC);\n  unsigned long long gp[5] = {0, 0, 0, 0, 0};\n"
         "  long long tc_ = 0;\n"),
        ("            stage(0);\n",
         "            long long ts_ = clock64();\n            stage(0);\n            gp[0] += clock64() - ts_;\n"),
        ("              cp_async_wait<0>();\n",
         "              long long ta_ = clock64();\n              cp_async_wait<0>();\n"),
        ("              if (ch + 1 < chunks) stage(ch + 1);\n",
         "              if (ch + 1 < chunks) stage(ch + 1);\n              long long tb_ = clock64();\n"
         "              gp[0] += tb_ - ta_;\n"),
        ("              grid_product<LR, KC>(acc, a_s + (ch & 1) * RB * LDA, w, LDW, jn, nq);\n",
         "              grid_product<LR, KC>(acc, a_s + (ch & 1) * RB * LDA, w, LDW, jn, nq);\n"
         "              gp[1] += clock64() - tb_;\n"),
        ("            grid_partials<LR>(part, acc, RP, NCB, rows, jn);\n",
         "            tc_ = clock64();\n            grid_partials<LR>(part, acc, RP, NCB, rows, jn);\n"),
        ("            dx[3 * H + j] = from_float<T>(dout * o * (1.0f - o));\n          }\n",
         "            dx[3 * H + j] = from_float<T>(dout * o * (1.0f - o));\n          }\n"
         "          if (product) gp[2] += clock64() - tc_;\n"),
        ("    if (s > 0) grid.sync();  // the whole dgates[t] is in dxp before any block stages it\n  }\n",
         "    long long td_ = clock64();\n"
         "    if (s > 0) grid.sync();  // the whole dgates[t] is in dxp before any block stages it\n"
         + _GRID_STORE.format(name="lstm_bwd_grid")),
    )),
}


def patch_grid(src: Path, name: str) -> None:
    """Patches the counters into the grid route `name` of `src`, whichever
    of its designs the tree holds."""
    text = src.read_text()
    for designs in (GRID_FIRST, GRID_REDESIGN):
        region, patches = designs[name]
        if region[0] in text and all(text.count(old) >= 1 for old, _ in patches):
            break
    else:
        raise SystemExit(f"port_lstm_phases: {src} holds no grid route this script patches")
    anchor = "namespace cg = cooperative_groups;\n"
    text = text.replace(anchor, anchor + f"__device__ unsigned long long g_{name}[8];\n", 1)
    src.write_text(_patch_region(text, region, patches, src) + GRID_READER.format(name=name))


def _patch_region(text: str, region, patches, src: Path) -> str:
    start = text.find(region[0])
    end = text.find(region[1], start)
    if start < 0 or end < 0:
        raise SystemExit(f"port_lstm_phases: {src} does not hold the region {region}")
    part = text[start:end]
    for old, new in patches:
        if part.count(old) != 1:
            raise SystemExit(f"port_lstm_phases: {src} does not hold the walk this script patches:\n{old}")
        part = part.replace(old, new)
    return text[:start] + part + text[end:]


def patch(src: Path) -> bool:
    """Patches the counters into `src`; True if it holds the split walk."""
    text = src.read_text()
    if text.count(GLOBALS[0]) != 1:
        raise SystemExit(f"port_lstm_phases: {src} does not hold:\n{GLOBALS[0]}")
    text = text.replace(*GLOBALS)
    split = SPLIT_REGION[0] in text
    if split:
        text = _patch_region(text, SPLIT_REGION, SPLIT_PATCHES, src)
        text = _patch_region(text, CLUSTER_REGION, PATCHES, src)
        src.write_text(text + READER)
    else:  # a tree before the split walk: the cluster walk ends at the grid route
        text = _patch_region(text, (CLUSTER_REGION[0], SPLIT_REGION[1]), PATCHES, src)
        src.write_text(text + READER.split('extern "C" int lstm_fwd_split_phases')[0])
    return split


def patch_bwd(src: Path) -> bool:
    """Patches the counters into the backward's split walk of `src`; False
    if the tree has none."""
    text = src.read_text()
    if BWD_REGION[0] not in text:
        return False
    if text.count(BWD_GLOBALS[0]) != 1:
        raise SystemExit(f"port_lstm_phases: {src} does not hold:\n{BWD_GLOBALS[0]}")
    text = _patch_region(text.replace(*BWD_GLOBALS), BWD_REGION, BWD_PATCHES, src)
    src.write_text(text + BWD_READER)
    return True


def _timed(torch, run) -> float:
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
    return start.elapsed_time(end) / 10


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    repo = Path(__file__).resolve().parents[1]
    parser.add_argument("--root", default=str(repo))
    parser.add_argument("--tag", default="this")
    parser.add_argument("--work", default=None)
    parser.add_argument("--walks", default="cluster,split,split_bwd,grid,grid_bwd")
    args = parser.parse_args(argv)
    walks = set(args.walks.split(","))
    work = Path(args.work or repo / "compare" / f"phases-{args.tag}").resolve()
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(Path(args.root).resolve() / "voicesplit_tpu_torch", work / "voicesplit_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    has_split = patch(work / "voicesplit_tpu_torch" / "csrc" / "lstm_fwd.cu")
    has_bwd = patch_bwd(work / "voicesplit_tpu_torch" / "csrc" / "lstm_bwd.cu")
    patch_grid(work / "voicesplit_tpu_torch" / "csrc" / "lstm_fwd.cu", "lstm_fwd_grid")
    patch_grid(work / "voicesplit_tpu_torch" / "csrc" / "lstm_bwd.cu", "lstm_bwd_grid")
    sys.path.insert(0, str(work))

    import torch

    if not torch.cuda.is_available():
        print("port_lstm_phases: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.ops import lstm_cuda

    lib = lstm_cuda._library()
    lib.lstm_fwd_phases.argtypes = [ctypes.c_void_p]
    if has_split:
        lib.lstm_fwd_split_phases.argtypes = [ctypes.c_void_p]
    if has_bwd:
        lib.lstm_bwd_split_phases.argtypes = [ctypes.c_void_p]
    lib.lstm_fwd_grid_phases.argtypes = [ctypes.c_void_p]
    lib.lstm_bwd_grid_phases.argtypes = [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    g = torch.Generator().manual_seed(0)
    cases = [("cluster", *c, 400, dt) for c in CLUSTER_CASES for dt in (torch.bfloat16, torch.float32)
             if "cluster" in walks]
    if has_split and "split" in walks:
        cases += [("split", *c, 800, torch.bfloat16) for c in SPLIT_CASES]
    for walk, name, D, B, H, dt in cases:
        T, R = T_FRAMES, D * B
        xp = torch.randn(T, R, 4 * H, generator=g).to("cuda", dt)
        s = H ** -0.5
        ws = [torch.empty(H, 4 * H).uniform_(-s, s, generator=g).to("cuda", dt) for _ in range(2)]
        h0 = torch.zeros(R, H, device="cuda")
        c0 = torch.zeros_like(h0)
        if D == 1:
            run = lambda: lstm_cuda.lstm_fwd(xp, ws[0], h0, c0)  # noqa: E731
        else:
            run = lambda: lstm_cuda.bilstm_fwd(xp, ws[0], ws[1])  # noqa: E731
        routes = dict(lstm_cuda.ROUTES)
        ms = _timed(torch, run)
        took = [k for k, v in lstm_cuda.ROUTES.items() if v != routes[k]]
        out = {"tag": args.tag, "root": str(Path(args.root).resolve()), "nvidia_smi": smi,
               "walk": walk, "route": took, "kernel": name, "batch": B, "H": H,
               "dtype": str(dt).removeprefix("torch."), "ms_with_counters": ms}
        if walk == "cluster":
            buf = (ctypes.c_ulonglong * 8)()
            lstm_cuda._raise_on(lib.lstm_fwd_phases(ctypes.addressof(buf)), "lstm_fwd_phases")
            cycles = list(buf)
            out["cycles_a_step_thread0"] = dict(zip(PHASES, cycles[:5]))
            out["cycles_a_step_thread352"] = dict(zip(PHASES[:3], cycles[5:8]))
        else:
            buf = (ctypes.c_ulonglong * 24)()
            lstm_cuda._raise_on(lib.lstm_fwd_split_phases(ctypes.addressof(buf)), "lstm_fwd_split_phases")
            cycles = list(buf)
            for i, who in enumerate(("block0_thread0", "block0_thread352", "block16_thread0")):
                out[f"cycles_a_step_{who}"] = dict(zip(SPLIT_PHASES, cycles[8 * i:8 * i + 8]))
        print(json.dumps(out), flush=True)
    for name, D, B in BWD_CASES if has_bwd and "split_bwd" in walks else ():
        T, H, dt, R = T_FRAMES, 800, torch.bfloat16, D * B
        xp = torch.randn(T, R, 4 * H, generator=g).to("cuda", dt)
        ws = [torch.empty(H, 4 * H).uniform_(-H ** -0.5, H ** -0.5, generator=g).to("cuda", dt)
              for _ in range(2)]
        states = [torch.randn(R, H, generator=g).cuda() for _ in range(4)]  # h0 c0 dhf dcf
        dhs = torch.randn(T, R, H, generator=g).cuda()
        with torch.inference_mode():
            if D == 1:
                hs, cs, gates = lstm_cuda.lstm_fwd_ref(xp, ws[0], *states[:2])
                run = lambda: lstm_cuda.lstm_bwd(  # noqa: E731
                    ws[0], gates, cs, hs, *states[:2], dhs, *states[2:], dt)
            else:
                hs, cs, gates = lstm_cuda.bilstm_fwd_ref(xp, ws[0], ws[1])
                run = lambda: lstm_cuda.bilstm_bwd(ws[0], ws[1], gates, cs, hs, dhs, dt)  # noqa: E731
        routes = dict(lstm_cuda.ROUTES_BWD)
        ms = _timed(torch, run)
        buf = (ctypes.c_ulonglong * 24)()
        lstm_cuda._raise_on(lib.lstm_bwd_split_phases(ctypes.addressof(buf)), "lstm_bwd_split_phases")
        cycles = list(buf)
        out = {"tag": args.tag, "root": str(Path(args.root).resolve()), "nvidia_smi": smi,
               "walk": "split_bwd", "route": [k for k, v in lstm_cuda.ROUTES_BWD.items() if v != routes[k]],
               "kernel": name, "batch": B, "H": H, "dtype": "bfloat16", "ms_with_counters": ms}
        for i, who in enumerate(("block0_thread0", "block0_thread256", "block16_thread0")):
            out[f"cycles_a_step_{who}"] = dict(zip(BWD_PHASES, cycles[8 * i:8 * i + 6]))
        print(json.dumps(out), flush=True)
    grid_cases = [("grid", "lstm_fwd", *c) for c in GRID_CASES if "grid" in walks]
    grid_cases += [("grid_bwd", "lstm_bwd", *c) for c in GRID_BWD_CASES if "grid_bwd" in walks]
    for walk, name, D, B, H, T, dt in grid_cases:
        counts, R, dtype = lstm_cuda.ROUTES if walk == "grid" else lstm_cuda.ROUTES_BWD, D * B, getattr(torch, dt)
        s = H ** -0.5
        xp = (torch.randn(T, R, 4 * H, generator=g) * 0.5).to("cuda", dtype)
        ws = [torch.empty(H, 4 * H).uniform_(-s, s, generator=g).to("cuda", dtype) for _ in range(D)]
        h0, c0, dhf, dcf = (torch.randn(R, H, generator=g).cuda() for _ in range(4))
        dhs = torch.randn(T, R, H, generator=g).cuda()
        with torch.inference_mode():
            if D == 1:
                hs, cs, gates = lstm_cuda.lstm_fwd_ref(xp, ws[0], h0, c0)
            else:
                hs, cs, gates = lstm_cuda.bilstm_fwd_ref(xp, ws[0], ws[1])
        if walk == "grid":
            run = lambda: lstm_cuda.lstm_fwd(xp, ws[0], h0, c0)  # noqa: E731
        elif D == 1:
            run = lambda: lstm_cuda.lstm_bwd(  # noqa: E731
                ws[0], gates, cs, hs, h0, c0, dhs, dhf, dcf, dtype)
        else:
            run = lambda: lstm_cuda.bilstm_bwd(ws[0], ws[1], gates, cs, hs, dhs, dtype)  # noqa: E731
        routes = dict(counts)
        ms = _timed(torch, run)
        buf = (ctypes.c_ulonglong * 8)()
        lstm_cuda._raise_on(getattr(lib, f"{name}_grid_phases")(ctypes.addressof(buf)), f"{name}_grid_phases")
        cycles = list(buf)
        out = {"tag": args.tag, "root": str(Path(args.root).resolve()), "nvidia_smi": smi, "walk": walk,
               "route": [k for k, v in counts.items() if v != routes[k]], "kernel": name if D == 1 else "bi" + name,
               "T": T, "batch": B, "H": H, "dtype": dt, "ms_with_counters": ms,
               "cycles_a_step_thread0": dict(zip(GRID_PHASES, cycles[:4])),
               "cycles_a_step_thread255": dict(zip(GRID_PHASES, cycles[4:]))}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
