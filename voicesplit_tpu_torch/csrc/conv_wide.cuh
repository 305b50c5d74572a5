// The wide-tile routes of the conv kernels: bf16 operands with Cin or Cout
// other than 64 (conv_fwd_wide.cu: the forward / data-gradient body;
// conv_wgrad_wide.cu: the weight gradient).  This header holds their tile
// table, which the planners on both sides of the plain C interface use, and
// the entry points that conv_fwd.cu and conv_wgrad.cu call for those widths.
// ops/conv_cuda.py mirrors the table (fwd_tile, wgrad_tile) and chip_smoke.py
// holds the two to each other through conv_fwd_wide_tile / conv_wgrad_wide_tile.
//
// Everything here is host code with external linkage, so that the four
// translation units agree; the kernels themselves stay inside their .cu.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

struct EvalParams;  // conv_tile.cuh

namespace wide {

constexpr int kSlab = 64;               // input channels a k-slab (four k16 steps)
constexpr size_t kSmemLimit = 232448;   // shared memory a block may take (227 KB)
constexpr size_t kStaticSmem = 1024;    // kept for the kernels' static shared memory (mbarriers)
constexpr size_t kAlign = 1024;         // wgmma's 128-byte swizzle wants 1024-byte tiles
constexpr int kWarps = 8;               // 256 threads: two warpgroups
constexpr int kStages = 3;              // the weight gradient's cp.async ring

inline size_t round_up(size_t n, size_t m) { return (n + m - 1) / m * m; }

// ---- forward / data gradient -----------------------------------------------
//
// An item is `rows` (2) output rows x `tf` positions x all `n` output
// channels of one group; each warpgroup computes one row as `mt` m64 tiles
// of m64nNk16 products, mt * n / 2 fp32 accumulators a thread (128 at most).
// Output channels split into as few groups of at most 256 as there must be,
// each rounded up to a built width.  The input ring holds kt + 3 row tiles
// of (tf + kf - 1) positions x 64 channels; the weights come a (time tap,
// frequency tap, input slab) slice of 64 x n at a time, in a ring of
// `wbufs` slices (4, or fewer where 4 do not fit), wbufs - 1 ahead.

// the wgmma widths built (conv_fwd_wide.cu instantiates each)
inline int fwd_width(int channels) {
  return channels <= 64 ? 64 : channels <= 96 ? 96 : channels <= 128 ? 128 : channels <= 192 ? 192 : 256;
}

struct FwdTile {
  int n, groups, mt, rows, tf, ring, wbufs;
  size_t smem;  // dynamic shared memory bytes
};

// mode: 0 plain (conv_dilated_fwd), 1 dgrad (conv_dgrad), 2 chain
// (conv_bn_act_fwd), 3 eval (conv_bn_act_eval).  False when no tile fits
// (never for kt <= 7).
inline bool fwd_tile(int cout, int kt, int kf, int mode, FwdTile* t) {
  t->groups = (cout + 255) / 256;
  t->n = fwd_width((cout + t->groups - 1) / t->groups);
  t->mt = t->n <= 128 ? 2 : 1;
  t->rows = 2;
  t->tf = 64 * t->mt;
  t->ring = kt + 3;  // the item's rows + 1 + the next unit's first two
  const size_t ring = size_t(t->ring) * round_up(size_t(t->tf + kf - 1) * kSlab * 2, kAlign);
  const size_t slice = size_t(kSlab) * round_up(t->n, 64) * 2;
  // chain: each warp's sums and sums of squares of the group, and its
  // 512-byte stage of rounded outputs; dgrad: each warp's 64 column sums;
  // eval: [bias, inv, shift] of every output channel
  const size_t extra = mode == 2 ? size_t(kWarps) * (2 * t->n + 128) * sizeof(float)
                       : mode == 1 ? size_t(kWarps) * kSlab * sizeof(float)
                       : mode == 3 ? size_t(3) * cout * sizeof(float) : 0;
  for (int wb = 4; wb >= 2; --wb) {
    const size_t s = ring + wb * slice + extra + kAlign;
    if (s + kStaticSmem <= kSmemLimit) {
      t->wbufs = wb;
      t->smem = s;
      return true;
    }
  }
  return false;
}

struct FwdWideInfo {
  FwdTile tile;
  int blocks, resident, registers, local_bytes;
  long long scratch;  // fp32 partial elements (dgrad: a row per warp, chain: a row per block)
  int partial_rows;   // rows of `scratch` the launch's sums reduce
};

cudaError_t conv_fwd_wide_plan(int B, int T, int F, int cin, int cout, int kt, int kf, int dt, int mode,
                               FwdWideInfo* info);
// x [B, T, F, cin], w [kt, kf, cin, cout], out [B, T, F, cout], bf16; bias
// (chain) fp32 [cout]; partials fp32 (dgrad, chain): `info.scratch` elements;
// ep (eval, and only there): the layer's fp32 [cout] vectors and activation.
cudaError_t conv_fwd_wide_launch(int mode, const void* x, const void* w, const float* bias, void* out,
                                 float* partials, int B, int T, int F, int cin, int cout, int kt, int kf,
                                 int dt, cudaStream_t stream, FwdWideInfo* info, const EvalParams* ep = nullptr);

// ---- weight gradient ----------------------------------------------------------
//
// dW of one time tap is the list of (input slab, frequency tap) tiles, each
// 64 input channels x n output channels.  A segment is a run of that list:
// an item stages the segment's input slabs (`slabs` at most) and the
// cotangent's n channels of one group once, and the two warpgroups compute
// the segment's tiles from them, at most `tw` a warpgroup (n / 2 fp32
// accumulators a tile and thread).  Output channels split into groups of
// at most 128; the tile list into as few segments as the warpgroups' tiles
// and the ring's shared memory allow.

inline int wgrad_width(int channels) { return channels <= 64 ? 64 : channels <= 96 ? 96 : 128; }
// m64 x n tiles a warpgroup holds: 128 (n 64), 144 (96), 128 (128) fp32 a
// thread (three n128 tiles, 192, spill)
__host__ __device__ constexpr int wgrad_tiles_per_warpgroup(int n) { return n <= 64 ? 4 : n <= 96 ? 3 : 2; }

struct WgradTile {
  int n, groups, tw, segs, seg_tiles, slabs, tf;
  size_t stage, smem;  // bytes of one ring stage, dynamic shared memory
};

// the distinct input slabs of tiles [lo, hi) of a list of kf taps a slab
inline int slabs_of(int lo, int hi, int kf) { return (hi - 1) / kf - lo / kf + 1; }

inline bool wgrad_tile(int cin, int cout, int kf, WgradTile* t) {
  t->groups = (cout + 127) / 128;
  t->n = wgrad_width((cout + t->groups - 1) / t->groups);
  t->tw = wgrad_tiles_per_warpgroup(t->n);
  t->tf = 128;
  const size_t d_bytes = round_up(t->n, 64) * t->tf * 2;
  const size_t y_bytes = round_up(size_t(t->tf + kf - 1) * kSlab * 2, kAlign);  // a slab of y
  const int n_tiles = (cin + kSlab - 1) / kSlab * kf, cap = 2 * t->tw;
  for (int segs = (n_tiles + cap - 1) / cap; segs <= n_tiles; ++segs) {
    int slabs = 0, most = 0;
    for (int s = 0; s < segs; ++s) {
      const int lo = s * n_tiles / segs, hi = (s + 1) * n_tiles / segs;
      slabs = slabs > slabs_of(lo, hi, kf) ? slabs : slabs_of(lo, hi, kf);
      most = most > hi - lo ? most : hi - lo;
    }
    const size_t stage = round_up(d_bytes + slabs * y_bytes, kAlign);
    // (at most four slabs: warps 4-7 issue them)
    if (slabs <= 4 && kStages * stage + kAlign + kStaticSmem <= kSmemLimit) {
      t->segs = segs;
      t->seg_tiles = most;
      t->slabs = slabs;
      t->stage = stage;
      t->smem = kStages * stage + kAlign;
      return true;
    }
  }
  return false;
}

struct WgradWideInfo {
  WgradTile tile;
  int blocks, resident, registers, local_bytes;
  long long scratch;  // fp32 partial elements
};

cudaError_t conv_wgrad_wide_plan(int B, int T, int F, int cin, int cout, int kt, int kf, int dt,
                                 WgradWideInfo* info);
// y [B, T, F, cin], d [B, T, F, cout] bf16 -> dw fp32 [kt, kf, cin, cout]
cudaError_t conv_wgrad_wide_launch(const void* y, const void* d, void* dw, float* partials, int B, int T,
                                   int F, int cin, int cout, int kt, int kf, int dt, cudaStream_t stream);

}  // namespace wide
