// The forward / data-gradient conv body of conv_fwd.cu at other widths than
// 64 channels, bf16 (Cin or Cout != 64; fp32 keeps conv_fwd.cu's slab route
// on CUDA cores, the tests' instantiation): conv_dilated_fwd (also its data
// gradient, on flipped weights), conv_dgrad, conv_bn_act_fwd and
// conv_bn_act_eval, the same four modes as conv_fwd.cu's body and the same
// TPU kernels replaced (voicesplit_tpu/ops/conv_pallas.py _fwd_kernel :95,
// conv_fused.py _fwd_kernel :303 and _dgrad_kernel :411), the same
// arithmetic (every tap summed in fp32 and rounded once; the chain's bias
// added before the rounding and its statistics of the rounded output;
// conv_dgrad's column sums of its input; the eval mode's bias, BatchNorm
// and activation on the fp32 sum from a [bias, inv, shift] table staged in
// shared memory at the block's start), the same one wave of balanced runs and
// fixed-order partial sums: no float atomics, the same bits twice.
//
// What bounds it (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s): a (5,5)
// layer at [2, 301, 601, 128] is 296 GFLOP against 185 MB, bound by
// operations (0.30 ms); (7,1) at 128 channels too (0.083 ms).
//
// Why not conv_fwd.cu's 64-wide tile (its slab route): each m64n64k16
// product reads its 2 KB B tile from shared memory and the A ldmatrix
// another 2 KB, 32 clocks at 128 B a clock for 31 clocks of products, so
// it cannot pass about half of peak; and every item ran once per 64-wide
// output group, re-reading its input rows.  Here:
//
//   Products.  wgmma.m64nNk16 with N = the output group's width (a built
//   width of conv_wide.cuh, at most 256): an item covers all its output
//   channels at once, and an input row crosses from L2 once per input slab,
//   not once per (slab, group).  Output channels split into groups only
//   past 256.  Both operands come from shared memory: A = a ring row tile
//   (K-major: rows of 64 channels) starting at the frequency tap's row
//   shift j, 128 j bytes into the 128-byte swizzle pattern; the hardware
//   swizzles by address, so the descriptor of the shifted start reads it
//   right (a base offset of j read it wrong, card tests).  A from registers
//   (ldmatrix, as conv_fwd.cu) made each k16 step wait for the one before
//   to free its registers, and measured slower.
//
//   Items.  2 output rows (one a warpgroup) x TF positions x N channels:
//   TF = 128 (two m64 tiles a warpgroup) up to N = 128, TF = 64 (one) above,
//   so that the accumulators stay at 128 fp32 a thread at most (2 x 64 at
//   n128, 128 at n256).  Rows come residue-major in each (b, frequency
//   tile) column as in conv_fwd.cu; groups outermost.
//
//   Units and sub-steps.  An item walks its input channels in 64-wide slabs
//   (a unit each); a unit takes a sub-step per (time tap i, frequency tap
//   j), each the 64 x N weight slice W[i, j, slab] against the unit's rows:
//   4 k16 steps of MT products a warpgroup in one commit group (none where
//   the warpgroup's output or input row lies outside [0, T)).  A sub-step
//   waits for its data, issues its products, waits for the previous
//   sub-step's products (all of its own where it issued none), and after
//   one barrier (everyone's are done) refills what that sub-step read while
//   its own run.
//
//   Loads.  The Tensor Memory Accelerator (conv_tma.cuh): a box that
//   reaches outside the tensor is zeros, which is the halo, rows outside
//   [0, T) and channels past the count; each copy is counted on an mbarrier
//   and read after its phase.  Issued by lane 0 of a few warps, several at
//   once (cp.async from every thread kept all warps issuing copies while
//   the tensor cores ran dry, and measured slower).
//
//   Weights.  A ring of `wbufs` slices (4; fewer where 4 do not fit), each
//   loaded wbufs - 1 sub-steps ahead in 64-column atoms of 128-byte swizzled
//   rows (a k16 x N B operand through one descriptor whose leading byte
//   offset steps from atom to atom).  (A step's kf slices at once, as
//   conv_fwd.cu stages them, take 160 KB at n128 (5,5): double-buffered
//   beside the ring they do not fit.)
//
//   Input ring.  kt + 3 row tiles (TF + kf - 1 positions x 64 channels,
//   1024-byte aligned): the unit's kt + 1 rows and room for the next unit's
//   first two, loaded at its first sub-step; its row p >= 2 goes into the
//   slot of this unit's row p - 2 at the first sub-step of time tap p - 1,
//   whose barrier follows the last products that read that slot, so every
//   row of the next unit is in flight by this unit's last tap.
//
//   What holds it back (scripts/port_conv_phases.py; PERF.md): a
//   sub-step takes about half again its products' time at peak, much of it
//   waiting for a slice issued three sub-steps before; every block reads
//   one 16 KB slice (and a fifth of a 17 KB row) a sub-step for its 256
//   positions: ~2.6 TB/s from L2 over the card at 128 channels.  More
//   positions a slice need more accumulators than a block's registers
//   hold; sharing a slice between the two blocks of a cluster (TMA
//   multicast) is untried.
//
//   Sums.  conv_dgrad: the column sums of its input from the ring (ldmatrix)
//   at the centre tap (time and frequency) of each slab, in the items of
//   group 0 (each input element is the centre of one output row), added per
//   lane in fp32, over the warp through a 256-byte stage and into the warp's
//   own row of the partials in global memory; conv_bn_act_fwd: each warp's
//   rounded outputs pass through a 512-byte stage and lane l adds channel l
//   of each 32-channel quarter over 8 positions into the warp's sums and
//   sums of squares in shared memory; the block adds its warps in a fixed
//   order into its partial row when the run leaves a group.  conv_fwd.cu's
//   reduce_rows_kernel adds the rows in a fixed order, in double.

#include "conv_tile.cuh"
#include "conv_tma.cuh"
#include "conv_wgmma.cuh"
#include "conv_wide.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum WideMode : int { kWidePlain = 0, kWideDgrad = 1, kWideChain = 2, kWideEval = 3 };

template <int N> struct WideShape {
  static constexpr int MT = N <= 128 ? 2 : 1;            // m64 tiles a warpgroup
  static constexpr int TF = 64 * MT;                     // positions an item
  static constexpr int R = 2;                            // output rows an item: one a warpgroup
  static constexpr int NSM = (N + 63) / 64 * 64;         // weight slice columns in shared memory
};

struct WideWork {
  int T, F, kt, dt, cin, cout;
  int n_slab, n_ft, n_col, wbufs;  // n_col: items of one (b, frequency tile) column
  int items, per_grp;              // per_grp: items of one output group
  int blocks;
};

struct WideItem {
  int b, f0, r, q, og;  // output rows r + (2 q + u) dt for u < 2, positions [f0, f0 + TF), group og
};

template <int N>
__device__ __forceinline__ WideItem decode_wide(const WideWork& w, int item) {
  const int og = item / w.per_grp;
  item -= og * w.per_grp;
  const int per_b = w.n_ft * w.n_col;
  const int b = item / per_b;
  const int rem = item - b * per_b;
  const int ft = rem / w.n_col;
  int q = rem - ft * w.n_col, r = 0;
  for (int len = (w.T + w.dt - 1) / w.dt; q >= (len + 1) / 2; len = (w.T - r + w.dt - 1) / w.dt) {
    q -= (len + 1) / 2;  // the items of residue r
    ++r;
  }
  return {b, ft * WideShape<N>::TF, r, q, og};
}

// element (row, channel) of a [rows][64] tile whose 16-byte chunks are
// permuted by chunk ^ (row & 7): the 128-byte swizzle
__device__ __forceinline__ int swz(int row, int ch) {
  return row * kC + (((ch >> 3) ^ (row & 7)) << 3) + (ch & 7);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pick4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, int i) {
  return i == 0 ? a0 : i == 1 ? a1 : i == 2 ? a2 : a3;
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// grid (blocks); out [B, T, F, cout]; kWideDgrad: partials [blocks][8 warps][cin];
// kWideChain: bias [cout], partials [blocks][2 cout] (sums, sums of squares);
// kWideEval: ep, the layer's [cout] vectors
template <int KF, int MODE, int N>
__device__ __forceinline__ void conv_fwd_wide_body(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                                   const float* __restrict__ bias, bf16* __restrict__ out,
                                                   float* __restrict__ partials, const WideWork& w,
                                                   const EvalParams& ep) {
  constexpr bool DGRAD = MODE == kWideDgrad, CHAIN = MODE == kWideChain, EVAL = MODE == kWideEval;
  using Shape = WideShape<N>;
  constexpr int MT = Shape::MT, TF = Shape::TF, R = Shape::R, NSM = Shape::NSM;
  constexpr int kRow = (TF + KF - 1) * kC;   // elements of a ring tile's rows
  constexpr int kSlot = (kRow * 2 + int(wide::kAlign) - 1) / int(wide::kAlign) * int(wide::kAlign) / 2;
                                             // elements of a ring slot: 1024-byte aligned
  constexpr int kSlice = kC * NSM;           // elements of a weight slice
  constexpr int pad_f = (KF - 1) / 2;
  constexpr int kRowThread = 4 * 32;  // issues the ring rows (warp 4: the slices' atoms take warps 0-3)
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int g = blockIdx.x;
  const int it0 = int((long long)g * w.items / w.blocks);
  const int n = int((long long)(g + 1) * w.items / w.blocks - it0);
  const int kt = w.kt, centre = (kt - 1) / 2;
  const int S = R + kt - 1, Q = S + R;  // a unit's rows; ring slots
  const int n_slab = w.n_slab, W = w.wbufs, D = W - 1;  // slices in flight ahead
  const int subs = kt * KF;  // sub-steps of a unit
  const int per_item = n_slab * subs;
  const int total = per_item * n;  // sub-steps of the run (the planner keeps it in int)

  // [W][NSM / 64][64][64] weight slices, then the ring [Q][TF + KF - 1][64];
  // CHAIN: [warp][2 N] sums and sums of squares, then [warp][8][32] stages;
  // EVAL: [bias, inv, shift] of every output channel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const w_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + wide::kAlign - 1) & ~uintptr_t(wide::kAlign - 1));
  bf16* const ring = w_s + W * kSlice;
  float* const stat_s = reinterpret_cast<float*>(ring + Q * kSlot);
  const uint32_t w_s_addr = static_cast<uint32_t>(__cvta_generic_to_shared(w_s));
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  float* const stage = stat_s + wide::kWarps * 2 * N + warp * 128;
  float* const ds_stage = stat_s + warp * kC;  // DGRAD: the warp's 64 sums of a unit
  float* const dsum_row = partials + (size_t(g) * wide::kWarps + warp) * w.cin;  // DGRAD

  if constexpr (DGRAD) {
    for (int c = lane; c < w.cin; c += 32) dsum_row[c] = 0.0f;
    __syncwarp();
  }
  if constexpr (CHAIN) {  // groups the run does not meet add nothing
    for (int c = tid; c < 2 * w.cout; c += kThreads) partials[size_t(g) * 2 * w.cout + c] = 0.0f;
    for (int e = tid; e < wide::kWarps * 2 * N; e += kThreads) stat_s[e] = 0.0f;
  }
  if constexpr (EVAL) stage_eval(stat_s, ep, w.cout, tid, kThreads);  // read after the barrier below

  // mbarriers: one a weight slice buffer, one a ring slot; the fill of
  // slice (or ring row) number s is phase s / count of barrier s % count
  __shared__ __align__(8) uint64_t bars[4 + kMaxTaps + 3];
  const uint32_t bar_w = smem_addr(bars), bar_r = bar_w + 4 * 8;
  if (tid == 0) {
    for (int b = 0; b < W + Q; ++b) mbar_init(smem_addr(bars + (b < W ? b : 4 + b - W)));
    mbar_init_fence();
  }
  __syncthreads();

  auto row_of = [&](const WideItem& m, int p) { return m.r + (m.q * R + p - centre) * w.dt; };
  // ring row number `seq` = row p of a unit (item m, input slab cs): TF + KF
  // - 1 positions from f0 - pad_f, 64 channels from 64 cs, zero outside
  // [0, T) x [0, F) and past cin (thread kRowThread)
  auto load_row = [&](int seq, const WideItem& m, int p, int cs) {
    const uint32_t bar = bar_r + (seq % Q) * 8;
    mbar_expect(bar, (TF + KF - 1) * kC * 2);
    tma_load_4d(ring_s + (seq % Q) * (kSlot * 2), tm_x, cs * kC, m.f0 - pad_f, row_of(m, p), m.b, bar);
  };
  // The weight slices in run order, one a sub-step, from a cursor (the
  // next slice's item, input slab, time tap, frequency tap, buffer): W[i, j]
  // rows [64 cs, +64) (input channels), columns [og N, +N) (output
  // channels), zero past cin and cout, in 64-column atoms: every thread
  // walks the cursor, thread 0 arms the barrier and lane 0 of warp a issues
  // atom a, so that the copies leave from several warps at once
  int lk = 0, lcs = 0, li = 0, lj = 0, lbuf = 0, log_ = it0 / w.per_grp;
  auto load_slice = [&]() {
    const uint32_t bar = bar_w + lbuf * 8;
    if (tid == 0) mbar_expect(bar, NSM * kC * 2);
    if ((tid & 31) == 0 && warp < NSM / 64) {
      tma_load_3d(w_s_addr + lbuf * (kSlice * 2) + warp * (kC * kC * 2), tm_w, log_ * N + 64 * warp, lcs * kC,
                  li * KF + lj, bar);
    }
    lbuf = lbuf + 1 == W ? 0 : lbuf + 1;
    if (++lj < KF) return;
    lj = 0;
    if (++li < kt) return;
    li = 0;
    if (++lcs < n_slab) return;
    lcs = 0;
    log_ = (it0 + ++lk) / w.per_grp;
  };

  if (n > 0) {  // unit 0's rows and the first D slices
    if (tid == kRowThread) {
      const WideItem m0 = decode_wide<N>(w, it0);
      for (int p = 0; p < S; ++p) load_row(p, m0, p, 0);
    }
    for (int s = 0; s < D && s < total; ++s) load_slice();
  }

  float acc[MT][N / 8][4];

  int sig = 0;  // sub-steps so far
  for (int k = 0; k < n; ++k) {
    const WideItem it = decode_wide<N>(w, it0 + k);
    const WideItem nx = k + 1 < n ? decode_wide<N>(w, it0 + k + 1) : it;
    const int t_out = row_of(it, wg + centre);  // this warpgroup's output row
#pragma unroll
    for (int q = 0; q < MT; ++q) {
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) acc[q][nt][0] = acc[q][nt][1] = acc[q][nt][2] = acc[q][nt][3] = 0.0f;
    }

    for (int cs = 0; cs < n_slab; ++cs) {
      const int U = k * n_slab + cs;  // unit number: row p of unit U is ring row U S + p
      const bool next_unit = cs + 1 < n_slab || k + 1 < n;
      const WideItem mu = cs + 1 < n_slab ? it : nx;  // the next unit's item and slab (a copy:
                                                      // a reference would put both on the stack)
      const int ncs = cs + 1 < n_slab ? cs + 1 : 0;
      for (int i = 0; i < kt; ++i) {
        const int t_in = row_of(it, wg + i);
        const bool active = t_out < w.T && t_in >= 0 && t_in < w.T;  // uniform over the warpgroup
        for (int j = 0; j < KF; ++j, ++sig) {
          // this sub-step's slice (and, at a unit's start, the unit's rows) landed
          if (i == 0 && j == 0) {
            for (int p = 0; p < S; ++p) mbar_wait(bar_r + ((U * S + p) % Q) * 8, ((U * S + p) / Q) & 1);
          }
          mbar_wait(bar_w + (sig % W) * 8, (sig / W) & 1);
          if (active) {
            if constexpr (DGRAD) {
              if (i == centre && j == pad_f && it.og == 0) {
                // every input element is the centre of one output row: this
                // lane's channels 16 kk + 2 tig + {0, 1, 8, 9} over its rows of
                // each m64 tile, then over the 8 lanes of one tig into the
                // warp's stage, then added to the warp's row in global memory
                const int c_lo = cs * kC + lane, c_hi = c_lo + 32;
                const float old_lo = c_lo < w.cin ? dsum_row[c_lo] : 0.0f;
                const float old_hi = c_hi < w.cin ? dsum_row[c_hi] : 0.0f;
                const bf16* const arow = ring + ((U * S + wg + i) % Q) * kSlot;
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                  float ds[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                  for (int q = 0; q < MT; ++q) {
                    uint32_t af[4];
                    ldmatrix_x4(af, arow + swz(64 * q + 16 * (warp & 3) + (lane & 15) + j, kk * 16 + (lane >> 4) * 8));
                    const float2 r0 = unpack2(af[0]), r1 = unpack2(af[1]);
                    const float2 r2 = unpack2(af[2]), r3 = unpack2(af[3]);
                    ds[0] += r0.x + r1.x;
                    ds[1] += r0.y + r1.y;
                    ds[2] += r2.x + r3.x;
                    ds[3] += r2.y + r3.y;
                  }
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    float v = ds[e];
                    v += __shfl_xor_sync(0xffffffffu, v, 4);
                    v += __shfl_xor_sync(0xffffffffu, v, 8);
                    v += __shfl_xor_sync(0xffffffffu, v, 16);
                    if (lane < 4) ds_stage[16 * kk + 2 * lane + (e & 1) + 8 * (e >> 1)] = v;
                  }
                }
                __syncwarp();
                if (c_lo < w.cin) dsum_row[c_lo] = old_lo + ds_stage[lane];
                if (c_hi < w.cin) dsum_row[c_hi] = old_hi + ds_stage[32 + lane];
                __syncwarp();  // before the next unit's sums overwrite the stage
              }
            }
            // A: the row tile at the frequency tap's row shift j (K-major, the
            // 128-byte swizzle; a start 128 j bytes into the pattern, which
            // the hardware reads by address); B: the slice; one commit group
            // of 4 k16 steps x MT products
            const uint32_t a0 = ring_s + ((U * S + wg + i) % Q) * (kSlot * 2) + j * (kC * 2);
            const uint32_t b0 = w_s_addr + (sig % W) * (kSlice * 2);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t bd = b_desc_mn(b0 + kk * 16 * kC * 2, kC * kC * 2);
#pragma unroll
              for (int q = 0; q < MT; ++q) {
                WgmmaSS<N, 0>::run(acc[q], a_desc_k(a0 + q * 64 * kC * 2 + kk * 32), bd);
              }
            }
            wgmma_commit();
          } else {
            // an idle warpgroup commits nothing, so wait<1> below would not
            // cover its previous sub-step's products: wait for all of them
            // (a commit outside the branch makes ptxas serialize every
            // wgmma, C7520)
            wgmma_wait<0>();
          }
          // the previous sub-step's products are done everywhere, so its
          // slice and the rows it read last may be refilled while this
          // sub-step's run: the slice D ahead, and the next unit's row R + i
          // - 1 into the slot of this unit's row i - 1 (at its start, its
          // first R rows into slots of the unit before)
          wgmma_wait<1>();
          __syncthreads();
          if (sig + D < total) load_slice();
          if (tid == kRowThread && next_unit && j == 0) {
            if (i == 0) {
              for (int p = 0; p < R; ++p) load_row((U + 1) * S + p, mu, p, ncs);
            } else if (R + i - 1 < S) {
              load_row((U + 1) * S + R + i - 1, mu, R + i - 1, ncs);
            }
          }
        }
      }
    }
    wgmma_wait<0>();

    // epilogue: (CHAIN: + bias; EVAL: + bias, BatchNorm, activation) round
    // once, 16 bytes a lane
    if (t_out < w.T) {
      const int gr = lane >> 2, tig = lane & 3, quad = lane & ~3;
      bf16* const out_row = out + (size_t(it.b) * w.T + t_out) * w.F * w.cout;
#pragma unroll
      for (int q = 0; q < MT; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = it.f0 + 64 * q + 16 * (warp & 3) + gr + 8 * h;
#pragma unroll
          for (int hh = 0; hh < N / 32; ++hh) {  // 32 channels: n-tiles 4 hh .. 4 hh + 3
            uint32_t wd[4];
#pragma unroll
            for (int k4 = 0; k4 < 4; ++k4) {
              float v0 = acc[q][4 * hh + k4][2 * h], v1 = acc[q][4 * hh + k4][2 * h + 1];
              if constexpr (CHAIN) {
                const int co = it.og * N + 8 * (4 * hh + k4) + 2 * tig;
                if (co < w.cout) {
                  v0 += __ldg(bias + co);
                  v1 += __ldg(bias + co + 1);
                }
              }
              if constexpr (EVAL) {
                const int co = it.og * N + 8 * (4 * hh + k4) + 2 * tig;
                if (co < w.cout) eval_pair(v0, v1, stat_s, w.cout, co, ep.act);  // cout is a multiple of 8
              }
              wd[k4] = pack2(v0, v1);
            }
            // round rr: lane tig sends its pair of n-tile (tig + rr) mod 4 and
            // receives the pair of n-tile tig from lane (tig - rr) mod 4
            uint32_t rot[4];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              const uint32_t v = pick4(wd[0], wd[1], wd[2], wd[3], (tig + rr) & 3);
              rot[rr] = __shfl_sync(0xffffffffu, v, quad | ((tig - rr) & 3));
            }
            uint4 v;  // pairs from lanes 0, 1, 2, 3 of the quad: 8 channels of n-tile 4 hh + tig
            v.x = pick4(rot[0], rot[1], rot[2], rot[3], tig);
            v.y = pick4(rot[0], rot[1], rot[2], rot[3], (tig + 3) & 3);
            v.z = pick4(rot[0], rot[1], rot[2], rot[3], (tig + 2) & 3);
            v.w = pick4(rot[0], rot[1], rot[2], rot[3], (tig + 1) & 3);
            const int co = it.og * N + 32 * hh + 8 * tig;
            const bool inside = f < w.F && co < w.cout;
            if (inside) *reinterpret_cast<uint4*>(out_row + size_t(f) * w.cout + co) = v;
            if constexpr (CHAIN) {
              // the warp's 8 positions x 32 channels (zero outside the tensor)
              // through its stage; lane l adds channel 32 hh + l
              reinterpret_cast<uint4*>(stage)[lane] = inside ? v : make_uint4(0, 0, 0, 0);
              __syncwarp();
              float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
              for (int p = 0; p < 8; ++p) {
                const float r = __bfloat162float(reinterpret_cast<const bf16*>(stage)[32 * p + lane]);
                s1 += r;
                s2 += r * r;
              }
              float* const st = stat_s + warp * 2 * N + 32 * hh + lane;
              st[0] += s1;
              st[N] += s2;
              __syncwarp();  // before the next quarter overwrites the stage
            }
          }
        }
      }
    }

    if constexpr (CHAIN) {
      if (k + 1 == n || nx.og != it.og) {  // the run leaves the group: its sums into the row
        __syncthreads();
        for (int c = tid; c < 2 * N; c += kThreads) {
          float v = 0.0f;
#pragma unroll
          for (int p = 0; p < wide::kWarps; ++p) {
            v += stat_s[p * 2 * N + c];
            stat_s[p * 2 * N + c] = 0.0f;
          }
          const int co = it.og * N + (c < N ? c : c - N);
          if (co < w.cout) partials[size_t(g) * 2 * w.cout + (c < N ? 0 : w.cout) + co] = v;
        }
      }
    }
  }
}

template <int KF, int N>
__global__ void __launch_bounds__(kThreads, 1)
conv_dilated_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                             const float* __restrict__ bias, bf16* __restrict__ out, float* __restrict__ partials,
                             const WideWork work, const EvalParams ep) {
  conv_fwd_wide_body<KF, kWidePlain, N>(&tm_x, &tm_w, bias, out, partials, work, ep);
}

template <int KF, int N>
__global__ void __launch_bounds__(kThreads, 1)
conv_dgrad_wide_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                       const float* __restrict__ bias, bf16* __restrict__ out, float* __restrict__ partials,
                       const WideWork work, const EvalParams ep) {
  conv_fwd_wide_body<KF, kWideDgrad, N>(&tm_x, &tm_w, bias, out, partials, work, ep);
}

template <int KF, int N>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_act_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                            const float* __restrict__ bias, bf16* __restrict__ out, float* __restrict__ partials,
                            const WideWork work, const EvalParams ep) {
  conv_fwd_wide_body<KF, kWideChain, N>(&tm_x, &tm_w, bias, out, partials, work, ep);
}

template <int KF, int N>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_act_eval_wide_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                             const float* __restrict__ bias, bf16* __restrict__ out, float* __restrict__ partials,
                             const WideWork work, const EvalParams ep) {
  conv_fwd_wide_body<KF, kWideEval, N>(&tm_x, &tm_w, bias, out, partials, work, ep);
}

// every mode takes the same arguments; only the eval mode reads ep
using WideKernel = void (*)(const CUtensorMap, const CUtensorMap, const float*, bf16*, float*, const WideWork,
                            const EvalParams);

template <int KF, int MODE, int N>
WideKernel wide_kernel() {
  if constexpr (MODE == kWideEval) {
    return conv_bn_act_eval_wide_kernel<KF, N>;
  } else if constexpr (MODE == kWideChain) {
    return conv_bn_act_fwd_wide_kernel<KF, N>;
  } else if constexpr (MODE == kWideDgrad) {
    return conv_dgrad_wide_kernel<KF, N>;
  } else {
    return conv_dilated_fwd_wide_kernel<KF, N>;
  }
}

// The kernel of (kf, mode, n); the chain's modes take C a multiple of 64 of
// at least 128 channels, so they are built for n 128, 192 and 256 only; the
// plain and eval modes take every width that takes_layer sends.
template <int KF, int MODE>
WideKernel wide_kernel_n(int n) {
  switch (n) {
    case 128: return wide_kernel<KF, MODE, 128>();
    case 192: return wide_kernel<KF, MODE, 192>();
    case 256: return wide_kernel<KF, MODE, 256>();
    default: break;
  }
  if constexpr (MODE == kWidePlain || MODE == kWideEval) {
    if (n == 64) return wide_kernel<KF, MODE, 64>();
    if (n == 96) return wide_kernel<KF, MODE, 96>();
  }
  return nullptr;
}

template <int KF>
WideKernel wide_kernel_mode(int mode, int n) {
  switch (mode) {
    case kWidePlain: return wide_kernel_n<KF, kWidePlain>(n);
    case kWideDgrad: return wide_kernel_n<KF, kWideDgrad>(n);
    case kWideChain: return wide_kernel_n<KF, kWideChain>(n);
    case kWideEval: return wide_kernel_n<KF, kWideEval>(n);
    default: return nullptr;
  }
}

WideKernel find_kernel(int kf, int mode, int n) {
  switch (kf) {
    case 1: return wide_kernel_mode<1>(mode, n);
    case 3: return wide_kernel_mode<3>(mode, n);
    case 5: return wide_kernel_mode<5>(mode, n);
    default: return nullptr;
  }
}

cudaError_t plan(int B, int T_, int F, int cin, int cout, int kt, int kf, int dt, int mode,
                 wide::FwdWideInfo* info, WideWork* w, WideKernel* kernel) {
  if (bad_shape(B, T_, F, kt, kf, dt) || cin <= 0 || cout <= 0 || cin % 8 || cout % 8) {
    return cudaErrorInvalidValue;
  }
  wide::FwdTile& t = info->tile;
  if (!wide::fwd_tile(cout, kt, kf, mode, &t)) return cudaErrorInvalidValue;
  *kernel = find_kernel(kf, mode, t.n);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = occupancy(*kernel, t.smem, &info->resident, &info->registers, &info->local_bytes);
  if (err != cudaSuccess) return err;
  w->T = T_;
  w->F = F;
  w->kt = kt;
  w->dt = dt;
  w->cin = cin;
  w->cout = cout;
  w->n_slab = (cin + kC - 1) / kC;
  w->n_ft = (F + t.tf - 1) / t.tf;
  w->n_col = 0;
  for (int r = 0; r < dt && r < T_; ++r) {
    const int len = (T_ - r + dt - 1) / dt;
    w->n_col += (len + t.rows - 1) / t.rows;
  }
  w->wbufs = t.wbufs;
  const long long per_grp = (long long)B * w->n_ft * w->n_col, items = per_grp * t.groups;
  // the kernel counts items and its run's sub-steps in int
  if (items * w->n_slab * kt * kf >= (1LL << 31)) return cudaErrorInvalidValue;
  w->per_grp = int(per_grp);
  w->items = int(items);
  info->blocks = w->blocks = w->items < info->resident ? w->items : info->resident;
  if (mode == kWideDgrad) {
    info->partial_rows = info->blocks * wide::kWarps;
    info->scratch = (long long)info->partial_rows * cin;
  } else if (mode == kWideChain) {
    info->partial_rows = info->blocks;
    info->scratch = (long long)info->blocks * 2 * cout;
  } else {
    info->partial_rows = 0;
    info->scratch = 0;
  }
  return cudaSuccess;
}

}  // namespace

namespace wide {

cudaError_t conv_fwd_wide_plan(int B, int T, int F, int cin, int cout, int kt, int kf, int dt, int mode,
                               FwdWideInfo* info) {
  WideWork w;
  WideKernel kernel;
  return plan(B, T, F, cin, cout, kt, kf, dt, mode, info, &w, &kernel);
}

cudaError_t conv_fwd_wide_launch(int mode, const void* x, const void* w, const float* bias, void* out,
                                 float* partials, int B, int T, int F, int cin, int cout, int kt, int kf,
                                 int dt, cudaStream_t stream, FwdWideInfo* info, const EvalParams* ep) {
  if ((mode == kWideEval) != (ep != nullptr)) return cudaErrorInvalidValue;
  WideWork work;
  WideKernel kernel;
  cudaError_t err = plan(B, T, F, cin, cout, kt, kf, dt, mode, info, &work, &kernel);
  if (err != cudaSuccess) return err;
  // x as boxes of 64 channels x (tf + kf - 1) positions of one row; the
  // weights [kt kf][cin][cout] as boxes of 64 output x 64 input channels
  CUtensorMap tm_x, tm_w;
  err = activation_map(&tm_x, x, B, T, F, cin, info->tile.tf + kf - 1);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {cuuint64_t(cout), cuuint64_t(cin), cuuint64_t(kt) * kf};
  const cuuint64_t strides[2] = {cuuint64_t(cout) * 2, cuuint64_t(cout) * cin * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  err = bf16_map(&tm_w, w, 3, dims, strides, box);
  if (err != cudaSuccess) return err;
  kernel<<<info->blocks, kThreads, info->tile.smem, stream>>>(tm_x, tm_w, bias, static_cast<bf16*>(out), partials,
                                                               work, ep ? *ep : EvalParams{});
  return cudaGetLastError();
}

}  // namespace wide

// The forward tile of conv_fwd_wide.cu for bf16 at (cout, kt, kf, mode) on
// no card (the table alone): n, groups, m64 tiles a warpgroup, rows and
// positions an item, ring slots, weight slices, dynamic shared memory.
extern "C" int conv_fwd_wide_tile(int cout, int kt, int kf, int mode, int* n, int* groups, int* mt, int* rows,
                                  int* tf, int* ring, int* wbufs, long long* smem) {
  wide::FwdTile t;
  if (bad_shape(1, 1, 1, kt, kf, 1) || cout <= 0 || cout % 8 || mode < 0 || mode > 3 ||
      !wide::fwd_tile(cout, kt, kf, mode, &t)) {
    return cudaErrorInvalidValue;
  }
  *n = t.n;
  *groups = t.groups;
  *mt = t.mt;
  *rows = t.rows;
  *tf = t.tf;
  *ring = t.ring;
  *wbufs = t.wbufs;
  *smem = static_cast<long long>(t.smem);
  return cudaSuccess;
}

// Registers and local (spilled) bytes a thread of the forward body's wide
// instantiation (kf, mode, n), from the built library without a launch.
extern "C" int conv_fwd_wide_attributes(int kf, int mode, int n, int* registers, int* local_bytes) {
  const auto kernel = find_kernel(kf, mode, n);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  return cudaSuccess;
}
