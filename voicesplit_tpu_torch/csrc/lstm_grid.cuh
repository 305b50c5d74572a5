// What the LSTM grid routes share (lstm_fwd.cu: lstm_fwd_grid_kernel;
// lstm_bwd.cu: lstm_bwd_grid_kernel): the product of a step, rows x a few
// columns over a long K, on CUDA cores.
//
// The row operand A (h[t-1] in the forward, dgates[t+1] in the backward) is
// staged from L2 in chunks of KC consecutive k of the pass's rows, [RB][KC
// + 16 bytes] (k contiguous, as in device memory, so that each 16-byte
// cp.async is one piece of a row), two chunks in flight: the next one loads
// while the current one multiplies (a ring of three or four was no faster on
// the card).  KC is fixed for each tile shape at compile time: 64 for the
// passes of many rows, up to the whole of K for the passes of one or two,
// which would otherwise wait out one L2 latency a short chunk.  The column
// operand W (the block's columns of W_hh, forward; its rows of W_hh,
// backward) sits in shared memory k contiguous too, [columns][grid_ld(K)],
// or is staged with A chunk by chunk.  Each 128-bit load then carries 4
// consecutive k.
//
// A thread keeps a register tile of RI rows x CJ columns: lane (lr, lc) of
// a warp (LR lanes along the rows, LC = 32 / LR along the columns) owns rows
// lr + LR i and columns lc + LC j, and each warp multiplies every row and
// column over its own quads of 4 k: quads warp, warp + 8, ... of each chunk.
// LR = 1 (one or two rows a pass): each lane its own column, the rows'
// loads shared by the warp, so that W is read once a step.
// Per quad a thread loads CJ column vectors and RI row vectors and does
// 4 RI CJ FMAs (16 per load at RI = 12, CJ = 6).  The eight warps' partial
// sums then go to shared memory [warp][row][column] and are added in warp
// order by the step's cell update: a fixed order, so the same inputs give
// the same bits.
//
// Bank conflicts: A's row stride is 16 bytes past a multiple of 128 bytes,
// so the rows a warp reads at one k lie in distinct banks; W's row stride
// (grid_ld) is 4 elements past a multiple of 8, so the four gate columns of
// a unit (the forward's lanes along the columns) do too.
//
// Each .cu that includes this file is compiled on its own; everything here
// has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "conv_tile.cuh"  // kThreads, align16, cp.async

namespace {

constexpr int kGridWarps = kThreads / 32;     // warps of a grid block, each its own quads
constexpr int kGridUnits = 8;                 // units of a unit block: column slots of a lane

// Row stride, in elements, of an operand held k-contiguous for K values of k
// (and zeros up to a whole quad): 4 past a multiple of 8.
__host__ __device__ constexpr int grid_ld(int K) { return (K + 3) / 8 * 8 + 4; }

// Row stride, in elements, of a staged chunk of KC k of A: 16 bytes of
// padding.
template <typename TA> __host__ __device__ constexpr int grid_lda(int KC) { return KC + 16 / int(sizeof(TA)); }

// Chunks of KC k a pass of rows takes over K, and the chunk buffers it needs
// (two, or one where one chunk holds all of K).
__host__ __device__ constexpr int grid_chunks(int K, int KC) { return (K + KC - 1) / KC; }
__host__ __device__ constexpr int grid_buffers(int K, int KC) { return grid_chunks(K, KC) > 1 ? 2 : 1; }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// Chunk [k0, k0 + KC) of `rows` rows of an operand (row r at src + r ld;
// k past K, rows past `rows` and a null src as zeros) into dst
// [n][grid_lda(KC)], n rows in all.  vec: 16-byte cp.async, which needs K
// and ld multiples of 16 bytes' elements and src 16-byte aligned (the caller
// commits and waits); else plain loads through L2.  `fill` is any valid
// device address, read by none of the zero-filling copies.
template <typename TA, int KC>
__device__ __forceinline__ void grid_stage(TA* dst, int n, const TA* src, size_t ld, int rows, int k0, int K,
                                           bool vec, const void* fill) {
  constexpr int E = 16 / int(sizeof(TA));                 // elements a piece
  constexpr int P = KC / E, LDA = grid_lda<TA>(KC);       // pieces a row, row stride
  for (int e = threadIdx.x; e < n * P; e += blockDim.x) {
    const int r = e / P, k = k0 + (e % P) * E;
    TA* d = dst + r * LDA + (e % P) * E;
    const bool in = src != nullptr && r < rows;
    if (vec) {
      const bool any = in && k < K;
      cp_async16(d, any ? static_cast<const void*>(src + r * ld + k) : fill, any ? 16 : 0);
    } else {
#pragma unroll
      for (int x = 0; x < E; ++x) d[x] = in && k + x < K ? __ldcg(src + r * ld + k + x) : TA(0.0f);
    }
  }
}

// Column slots (of CJ) that lane lc of LC uses where `ncols` columns are in
// use: lc + LC j < ncols.
template <int LR>
__device__ __forceinline__ int grid_lane_columns(int ncols) {
  constexpr int LC = 32 / LR;
  return (ncols - int(threadIdx.x & 31) % LC + LC - 1) / LC;
}

// acc[i][j] += sum over this warp's quads q = warp, warp + kGridWarps, ...
// < nq of A[lr + LR i][4q + 0..3] W[lc + LC j][4q + 0..3], k in order within
// a quad.  a: the staged chunk of KC k; w: column 0's row at the chunk's
// first k, columns `ldw` elements apart; jn: this lane's column slots in
// use (grid_lane_columns; a warp-uniform count where the caller knows one).
// h is rounded to W's type before the product where A is fp32 and W bf16
// (the forward in bf16), as the Pallas kernel casts it.
template <int LR, int KC, int RI, int CJ, typename TA, typename TW>
__device__ __forceinline__ void grid_product(float (&acc)[RI][CJ], const TA* a, const TW* w, int ldw, int jn,
                                             int nq) {
  constexpr int LC = 32 / LR, lda = grid_lda<TA>(KC);
  constexpr bool kRound = sizeof(TA) == 4 && sizeof(TW) == 2;
  const int lane = threadIdx.x & 31, lc = lane % LC;
  const TA* ap = a + (lane / LC) * lda;
  const TW* wp = w + lc * ldw;
  for (int q = threadIdx.x >> 5; q < nq; q += kGridWarps) {
    float4 wv[CJ];
#pragma unroll
    for (int j = 0; j < CJ; ++j) wv[j] = j < jn ? load4(wp + j * LC * ldw + 4 * q) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float4 h = load4(ap + i * LR * lda + 4 * q);
      if constexpr (kRound) {
        h = make_float4(round_bf16(h.x), round_bf16(h.y), round_bf16(h.z), round_bf16(h.w));
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (j < jn) {
          acc[i][j] = fmaf(h.x, wv[j].x, acc[i][j]);
          acc[i][j] = fmaf(h.y, wv[j].y, acc[i][j]);
          acc[i][j] = fmaf(h.z, wv[j].z, acc[i][j]);
          acc[i][j] = fmaf(h.w, wv[j].w, acc[i][j]);
        }
      }
    }
  }
}

// This thread's tile into part [warp][RP][ldp]: row lr + LR i, column
// lc + LC j, for the rows < `rows` (<= RP) of the pass and this lane's jn
// column slots (as grid_product's).
template <int LR, int RI, int CJ>
__device__ __forceinline__ void grid_partials(float* part, const float (&acc)[RI][CJ], int RP, int ldp, int rows,
                                              int jn) {
  constexpr int LC = 32 / LR;
  const int lane = threadIdx.x & 31, lr = lane / LC;
  float* p = part + ((threadIdx.x >> 5) * RP + lr) * ldp + lane % LC;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      if (j < jn && lr + LR * i < rows) p[i * LR * ldp + j * LC] = acc[i][j];
    }
  }
}

// The warps' partials of (row r, column c), added in warp order.
__device__ __forceinline__ float grid_sum(const float* part, int RP, int ldp, int r, int c) {
  float s = part[r * ldp + c];
#pragma unroll
  for (int w = 1; w < kGridWarps; ++w) s += part[(w * RP + r) * ldp + c];
  return s;
}

}  // namespace
