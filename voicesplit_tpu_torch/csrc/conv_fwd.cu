// Forward / data-gradient "same" time-dilated conv for Hopper (sm_90a): the
// opt-in conv path's conv_dilated_fwd (VOICESPLIT_PALLAS_CONV=1; with
// flipped weights also its data gradient) and its eval-mode layer
// conv_bn_act_eval, and the fused chain's forward conv_bn_act_fwd and data
// gradient conv_dgrad: one kernel body in four modes (plain, dgrad, chain,
// eval).
//
// Replaces the TPU kernels (the Python wrappers of the same names, in
// ops/conv_cuda.py and ops/conv_fused.py, launch the C functions below)
//   conv_dilated_fwd <- voicesplit_tpu/ops/conv_pallas.py _fwd_kernel   (:95, launched by
//                       _conv_fwd_core :167; the data gradient with flipped weights :371-378)
//   conv_bn_act_fwd  <- voicesplit_tpu/ops/conv_fused.py  _fwd_kernel   (:303, launched by
//                       _conv_fwd :365)
//   conv_bn_act_eval <- conv_pallas.py _fwd_kernel (:95) with the bias that conv_dispatch
//                       adds after it (:406-420) and the eval-mode BatchNorm + activation
//                       that follows (ops/bn_act.py folded_bn_act_eval), in one epilogue
//   conv_dgrad       <- voicesplit_tpu/ops/conv_fused.py  _dgrad_kernel (:411, launched by
//                       _conv_dgrad :476); its prologue=True branch (:423-444, d_raw
//                       drawn from dy and the raw x in the load path) is the d_raw
//                       pass of conv_wgrad.cu (conv_draw_prologue), then this kernel
//                       on d_raw, so dbias sums the rounded d_raw as :470-473 does
//
// Channels-last activations [B, T, F, Cin] in, [B, T, F, Cout] out, weights
// [kt, kf, Cin, Cout], time dilation dt, frequency dilation 1, odd kt <= 7,
// kf in {1, 3, 5}:
//
//   out[b, t, f, co] = round(sum_{i,j,c} x[b, t + i*dt - pad_t, f + j - pad_f, c] * W[i, j, c, co])
//   conv_dgrad also  dbias[c] = sum_{b,t,f} x[b, t, f, c]   (x = d_raw, fp32)
//   conv_bn_act_fwd  raw = round(the same sum + bias[co]), stats[0, co] = sum raw,
//                    stats[1, co] = sum raw^2 (fp32, of the rounded raw over [0, T) x [0, F))
//   conv_bn_act_eval out = round(act((the same sum + bias[co]) inv[co] + shift[co])),
//                    inv = scale / sqrt(var + eps), shift = beta - mean inv (running statistics)
//
// round() casts to the operand type (bf16 or fp32), every product
// accumulates in fp32, a tap outside [0, T) x [0, F) contributes zero.  The
// TPU's conv_pallas kernel rounds each frequency tap's partial sum; this one
// sums every tap in fp32 and rounds once.  The chain's prologue (the previous
// layer's BatchNorm affine and activation, round(act(x * inv + shift))) is
// not in this kernel: the caller runs the prologue pass of conv_wgrad.cu
// (conv_wgrad_prologue) first, once per element, and hands its output in as
// x, so the halo stays zero after the activation as the TPU kernel's edge
// masks keep it.  Not carried over: the TPU kernels' K-fold / N-fold,
// frequency fold, lane padding and halo frames, which feed a 128-wide matrix
// unit; here the halo is a copy of zero bytes.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense),
// each input byte read once and each output byte written once: a (5,5)
// layer at [2, 301, 601, 64] is 74 GFLOP against 93 MB, bound by operations
// (0.074 ms); the (7,1) layer (21 GFLOP) by bytes (0.028 ms).
//
// Design.  The first version (two rows x 128 positions a block, each time
// tap's input rows and weights staged through registers between two
// barriers, 5.7 waves of blocks) left nothing in flight while the tensor
// cores worked and moved 5.5-7.5x the input from L2.  This one:
//
//   One wave, balanced runs.  G = cudaOccupancyMaxActiveBlocksPerMultiprocessor
//   x SMs blocks (one a SM: the ring below takes most of its shared memory),
//   or the item count if smaller; block g takes the contiguous run of items
//   [g N / G, (g+1) N / G), so no block runs alone after the wave.
//
//   Items.  An item is R output rows x TF frequency positions x 64 output
//   channels (bf16: R = 4, TF = 128; fp32: R = 1, TF = 16, the tests'
//   instantiation).  In a (b, frequency tile) column the rows come in
//   residue-major order (t mod dt, then t) and an item takes R consecutive
//   rows of one residue, t, t + dt, ...: it reads the R + kt - 1 input rows
//   t + (p - centre) dt, p < R + kt - 1, and the next item of the residue
//   shares kt - 1 of them.  Input rows therefore cross from L2 about once per
//   column instead of once per time tap that reads them.
//
//   Steps and the ring.  An item takes one step per time tap i; a step
//   multiplies input row u + i of the item into output row u.  The item's
//   input rows (TF + kf - 1 positions with the frequency halo) live in a
//   ring of S = R + kt - 1 row tiles in shared memory, numbered in load order
//   (slot = number mod S).  Row m < R is read last by step m, so during step
//   m + 1 the next item of the residue loads its new row m into that slot
//   (cp.async, 16 bytes a thread, src-size 0 for the halo and for rows
//   outside [0, T)): by the item's end every new row is in flight or landed.
//   An item that starts a residue or a run loads all its rows and waits once.
//   (A ring with room for the next item's rows as well, loaded at the item's
//   first step, was as fast: 0.083 against 0.081 ms on (7,1) at B=2, 0.171
//   against 0.168 on (5,5) d1; NVIDIA H100 80GB HBM3, 700 W.)
//
//   Weights.  kf = 1 (the (7,1) layer): all kt taps, 57,344 B in bf16, are
//   loaded once per block and stay.  kf = 3, 5: all 25 taps of a (5,5)
//   layer (204,800 B) do not fit beside the ring, and splitting the output
//   channels would read every input row twice and halve the products each
//   operand load feeds.  So a step's kf x 64 x 64 weights (40,960 B) are
//   double-buffered, loaded during the step before, and each staged byte
//   serves R x 128 positions.  bf16 (5,5): ring 135,168 B + weights 81,920 B;
//   (7,1): 163,840 + 57,344 B.
//
//   Layout.  Tiles keep rows of 64 channels without padding; the 16-byte
//   chunks of row p are permuted by chunk ^ (p & 7), wgmma's 128-byte
//   swizzle, so that ldmatrix (eight consecutive rows at one logical chunk)
//   reads eight bank groups and a weight tile is a wgmma B operand as it is.
//
//   Products.  bf16: wgmma.m64n64k16 (fp32 accumulate).  Warpgroup wg of the
//   two computes output rows 2 wg, 2 wg + 1 of the item, each as two m64
//   tiles of 64 positions x all 64 output channels.  A = the activations,
//   from registers: ldmatrix at the frequency tap's row shift j (a register
//   operand has no swizzle constraint, which a shift of j rows of 128 bytes
//   would break in shared memory); B = the tap's weights, read by wgmma from
//   shared memory (k rows, n contiguous: the transposed B).  A is double-
//   buffered in registers, so the next tap row's ldmatrix overlaps the
//   current products.  A warpgroup whose output rows lie past T, or whose
//   input rows at this tap all lie outside [0, T), skips the step.  (With
//   mma.sync.m16n8k16 and the same layout, 2 A- and 4 B-ldmatrix per 16
//   products per warp bound it by shared-memory reads: 0.206 against 0.172
//   ms on (5,5) d1 at B=2, 0.088 against 0.085 on (7,1); wgmma reads each B
//   tile once per warpgroup.)  fp32: FMAs on CUDA cores (not TF32).
//
//   Epilogue.  From registers: each quad of lanes swaps its bf16 pairs so
//   that a lane holds 8 consecutive channels, written 16 bytes a lane (fp32:
//   4 channels, 16 bytes).  conv_bn_act_fwd first adds the bias to the fp32
//   sums and rounds once; then each warp passes every 8 positions x 32
//   channels it wrote (zeros outside [0, T) x [0, F)) through a 512-byte
//   stage in shared memory, and lane l adds channel l of that half in fp32,
//   and its square, over the run (fp32: each thread its 4 channels).  Summed
//   beside the accumulators in registers, the statistics spilled (255
//   registers); the chain mode therefore zeroes its accumulators at each item
//   and always accumulates, so that they are dead once written.
//   conv_bn_act_eval stages [bias, inv, shift] of every output channel in
//   shared memory at the block's start (fp32, formed from the five [Cout]
//   vectors) and passes each fp32 sum through act((sum + bias) inv + shift)
//   (conv_tile.cuh's activate_eval, the activation a runtime argument)
//   before the one rounding: the eval-mode layer's conv, bias, BatchNorm
//   and activation in one pass over its output.
//   conv_dgrad sums each input element once, from the A registers of the
//   centre tap (time and frequency) of the item whose output row is its row,
//   per lane in fp32 over the run.  Either way the block adds its lanes and
//   warps in a fixed order into one partial row and reduce_rows_kernel adds
//   the rows in a fixed order, in double.  No float atomics: the same inputs
//   give the same bits.
//
//   Channels.  Every tile above is 64 channels wide, and C = 64 in and out
//   is its own compile-time instantiation (WIDE = false), as described.
//   Any other Cin, Cout (a multiple of 8, which the 16-byte copies need:
//   ops/conv_cuda.py pads other counts) goes in bf16 to the wide-tile body
//   of conv_fwd_wide.cu (all output channels of a group of up to 256 in one
//   wgmma.m64nNk16 product; the tile from conv_wide.cuh's table), and in
//   fp32 (WIDE = true, CUDA-core FMAs: the tests' instantiation) to the
//   slab route of this body, as follows.  It works in 64-wide
//   slabs.  An item also names one group of 64 output channels (groups
//   outermost in the numbering, so that a run meets each group once) and
//   walks the input channels in 64-wide slabs, each slab a pass over the
//   item's time taps into the same accumulators: each (slab, group) is the
//   64 x 64 tile problem above.  With one slab the ring carries rows from
//   item to item as above; with more, each slab of an item loads its rows
//   anew, so a row crosses from L2 about (R + kt - 1) / R times per slab and
//   group.  The weights of every step, kf = 1 too, are one [kf][64][64]
//   tile, double-buffered.  Channels past Cin or Cout read as zero (cp.async
//   with src-size 0, as the halo) and are not stored.  (All channels at once
//   would not fit: at C = 128 the bf16 (5,5) ring alone is 270,336 B and a
//   step's weights 163,840 B; by slab the item keeps the C = 64 budget.)
//   conv_bn_act_fwd writes each group's statistics into the block's partial
//   row [2 Cout] when the run leaves the group; conv_dgrad adds each slab's
//   column sums, taken by the items of group 0 (which read every input
//   element once), into the block's row [Cin] after the slab; both in a
//   fixed order.

#include "conv_tile.cuh"
#include "conv_wide.cuh"

namespace {

// What the kernel body computes besides the conv: nothing (conv_dilated_fwd),
// the input's column sums (conv_dgrad), the bias and the output's
// statistics (conv_bn_act_fwd), or the bias, the eval-mode BatchNorm and the
// activation (conv_bn_act_eval).
enum FwdMode : int { kFwdPlain = 0, kFwdDgrad = 1, kFwdChain = 2, kFwdEval = 3 };

// The shape of an item, by operand type and frequency taps.
template <typename T, int KF>
struct FwdShape {
  static constexpr bool kTensorCore = sizeof(T) == 2;
  static constexpr int R = kTensorCore ? 4 : 1;      // output rows
  static constexpr int TF = kTensorCore ? 128 : 16;  // frequency positions
  static constexpr int kRowElems = (TF + KF - 1) * kC;
};

// ring tiles: an item's input rows
template <typename T, int KF>
__host__ __device__ constexpr int ring_slots(int kt) {
  return FwdShape<T, KF>::R + kt - 1;
}

// Element (row, channel) of a [rows][64] tile whose 16-byte chunks are
// permuted by chunk ^ (row & 7): the 128-byte swizzle of wgmma's shared-memory
// layouts, and eight consecutive rows at one logical chunk (an ldmatrix
// phase) fall in eight bank groups.
template <typename T>
__device__ __forceinline__ int swz(int row, int ch) {
  constexpr int kVec = 16 / int(sizeof(T));
  return row * kC + ((ch / kVec) ^ (row & 7)) * kVec + ch % kVec;
}

// Items of one launch; block g takes [g * items / blocks, (g+1) * items / blocks).
struct FwdWork {
  int T, F, kt, dt, n_ft, n_col, blocks;  // n_col: items of one (b, frequency tile)
  long long items;
  int cin, cout, n_slab, n_grp;  // WIDE: channels, 64-wide input slabs, 64-wide output groups
};

struct FwdItem {
  int b, f0, r, q;  // output rows r + (q R + u) dt for u < R, positions [f0, f0 + TF)
  int og;           // output channels [64 og, 64 og + 64)
};

template <typename T, int KF, bool WIDE>
__device__ __forceinline__ FwdItem decode_fwd(const FwdWork& w, long long item) {
  constexpr int R = FwdShape<T, KF>::R;
  int og = 0;
  if constexpr (WIDE) {  // output groups outermost
    const long long per_grp = w.items / w.n_grp;
    og = int(item / per_grp);
    item -= (long long)og * per_grp;
  }
  const long long per_b = (long long)w.n_ft * w.n_col;
  const int b = int(item / per_b);
  const long long rem = item - (long long)b * per_b;
  const int ft = int(rem / w.n_col);
  int q = int(rem - (long long)ft * w.n_col), r = 0;
  for (int len = (w.T + w.dt - 1) / w.dt; q >= (len + R - 1) / R; len = (w.T - r + w.dt - 1) / w.dt) {
    q -= (len + R - 1) / R;  // the items of residue r
    ++r;
  }
  return {b, ft * FwdShape<T, KF>::TF, r, q, og};
}

// wgmma's 128-byte swizzle needs tiles on 1024-byte boundaries
constexpr int kSmemAlign = 1024;

// the chain's statistics: a row of 2 x 64 sums per warp, then the bias
// (C = 64: 64 channels; WIDE: Cout)
template <bool WIDE>
size_t chain_smem_bytes(int cout) {
  return (size_t(kThreads / 32) * 2 * kC + (WIDE ? cout : kC)) * sizeof(float);
}

// every tap's weights stay in shared memory for the whole run (C = 64, kf = 1)
template <int KF, bool WIDE>
__host__ __device__ constexpr bool resident_weights() {
  return KF == 1 && !WIDE;
}

// the eval mode's [bias, inv, shift] table (C = 64: 64 channels; WIDE: Cout)
template <bool WIDE>
size_t eval_smem_bytes(int cout) {
  return size_t(3) * (WIDE ? cout : kC) * sizeof(float);
}

template <typename T, int KF, int MODE, bool WIDE>
size_t fwd_smem_bytes(int kt, int cout) {
  const size_t ring = size_t(ring_slots<T, KF>(kt)) * FwdShape<T, KF>::kRowElems;
  const size_t weights = size_t(resident_weights<KF, WIDE>() ? kt : 2 * KF) * kC * kC;
  const size_t extra = MODE == kFwdChain ? chain_smem_bytes<WIDE>(cout)
                       : MODE == kFwdEval ? eval_smem_bytes<WIDE>(cout) : 0;
  return (ring + weights) * sizeof(T) + extra + kSmemAlign;
}

// Input row t, positions [f_lo, f_lo + TF + KF - 1), channels [c0, c0 + 64),
// into a ring tile; zero outside [0, T) x [0, F) and past cin.
template <typename T, int KF, bool WIDE>
__device__ __forceinline__ void load_row(T* dst, const T* __restrict__ x, const FwdWork& w, int b,
                                         int t, int f_lo, int cin, int c0, int tid) {
  constexpr int kVec = 16 / int(sizeof(T));
  constexpr int kChunks = kC / kVec;
  constexpr int kPos = FwdShape<T, KF>::TF + KF - 1;
  const bool row_ok = t >= 0 && t < w.T;
  const T* row = x + (size_t(b) * w.T + (row_ok ? t : 0)) * w.F * cin + c0;
  for (int e = tid; e < kPos * kChunks; e += kThreads) {
    const int p = e / kChunks, c = (e % kChunks) * kVec, f = f_lo + p;
    const bool ok = row_ok && f >= 0 && f < w.F && (!WIDE || c0 + c < cin);
    cp_async16(dst + swz<T>(p, c), ok ? row + size_t(f) * cin + c : x, ok ? 16 : 0);
  }
}

// `rows` rows of 64 weights ([tap][j][c] rows, co along the row; C = 64).
template <typename T>
__device__ __forceinline__ void load_weights(T* dst, const T* __restrict__ src, int rows, int tid) {
  constexpr int kVec = 16 / int(sizeof(T));
  constexpr int kChunks = kC / kVec;
  for (int e = tid; e < rows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * kVec;
    cp_async16(dst + swz<T>(r, c), src + size_t(r) * kC + c, 16);
  }
}

// WIDE: the [KF][64][64] weight tile of time tap i, input slab cs and output
// group og from [kt][KF][Cin][Cout], zero past Cin and Cout.
template <typename T, int KF>
__device__ __forceinline__ void load_weight_tile(T* dst, const T* __restrict__ wt, const FwdWork& w,
                                                 int i, int cs, int og, int tid) {
  constexpr int kVec = 16 / int(sizeof(T));
  constexpr int kChunks = kC / kVec;
  for (int e = tid; e < KF * kC * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * kVec;
    const int ci = cs * kC + r % kC, co = og * kC + c;
    const bool ok = ci < w.cin && co < w.cout;
    const T* src = wt + (size_t(i * KF + r / kC) * w.cin + ci) * w.cout + co;
    cp_async16(dst + swz<T>(r, c), ok ? src : wt, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t sel4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, int i) {
  return i == 0 ? a0 : i == 1 ? a1 : i == 2 ? a2 : a3;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Shared-memory descriptor of a 16 x 64 bf16 B operand (rows k, 64 n-values
// of 128 bytes each, 128-byte swizzle, n contiguous: wgmma's transposed B).
// The next 8 rows of k lie 1024 bytes on.
__device__ __forceinline__ uint64_t b_desc(const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}


// D (64 x 64 fp32; this warp's 16 rows in the mma.sync accumulator layout)
// = A (64 x 16 bf16 from registers, this warp's 16 rows) x B (smem) + D if
// accumulate.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}

// grid (blocks); out [B, T, F, Cout]; kFwdDgrad: partials [blocks][Cin], the
// block's share of the input's column sums; kFwdChain: bias [Cout] and
// partials [blocks][2 Cout], the block's share of the output's sums and sums
// of squares (C = 64: Cin = Cout = 64); kFwdEval: ep, the layer's [Cout]
// vectors.
template <typename T, int KF, int MODE, bool WIDE>
__device__ __forceinline__ void conv_fwd_body(const T* __restrict__ x, const T* __restrict__ wt,
                                              const float* __restrict__ bias, T* __restrict__ out,
                                              float* __restrict__ partials, const FwdWork& w,
                                              const EvalParams& ep) {
  constexpr bool DGRAD = MODE == kFwdDgrad, CHAIN = MODE == kFwdChain, EVAL = MODE == kFwdEval;
  using Shape = FwdShape<T, KF>;
  constexpr int R = Shape::R, TF = Shape::TF;
  constexpr bool kTensorCore = Shape::kTensorCore;
  constexpr int kRowElems = Shape::kRowElems;
  constexpr int kTapElems = KF * kC * kC;
  constexpr bool kResidentW = resident_weights<KF, WIDE>();
  constexpr int pad_f = (KF - 1) / 2;
  static_assert(!(WIDE && kTensorCore), "bf16 at other widths is conv_fwd_wide.cu's");
  const int cin = WIDE ? w.cin : kC, cout = WIDE ? w.cout : kC;
  const int n_slab = WIDE ? w.n_slab : 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x;
  const long long it0 = (long long)g * w.items / w.blocks;
  const int n = int((long long)(g + 1) * w.items / w.blocks - it0);
  const int kt = w.kt, centre = (kt - 1) / 2, S = ring_slots<T, KF>(kt);
  // a continuing item's new rows loaded during the previous item, one a step
  // into a slot that step frees; the rest (R >= kt) at its start
  const int early = min(R, kt - 1);

  // kResidentW: [kt][64][64] weights for the whole run; else [2][KF][64][64],
  // one buffer per step in turn.  Then the ring [S][TF + KF - 1][64].
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const w_s = reinterpret_cast<T*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  T* const ring = w_s + (kResidentW ? kt : 2) * kTapElems;
  // CHAIN: [warp][sum 64, sum of squares 64] (bf16: the warp's stage of
  // rounded outputs until the end), then the bias; EVAL: [bias, inv, shift]
  // of every output channel
  float* const stat_s = reinterpret_cast<float*>(ring + S * kRowElems);
  float* const stage = stat_s + warp * 2 * kC;
  float* const bias_s = stat_s + (kThreads / 32) * 2 * kC;
  if constexpr (WIDE) {
    if (CHAIN) {
      for (int c = tid; c < cout; c += kThreads) bias_s[c] = bias[c];
    }
    if (DGRAD || CHAIN) {  // groups or slabs the run does not meet add nothing
      const int width = DGRAD ? cin : 2 * cout;
      for (int c = tid; c < width; c += kThreads) partials[size_t(g) * width + c] = 0.0f;
    }
  } else {
    if (CHAIN && tid < kC) bias_s[tid] = bias[tid];
  }
  if constexpr (EVAL) stage_eval(stat_s, ep, cout, tid, kThreads);  // read after the first step's barrier

  // bf16: warpgroup wg = warp / 4 computes output rows 2 wg and 2 wg + 1 of
  // the item; this warp's tile q = 2 r + x holds row 2 wg + r and 16 positions
  // from pos(x), its slice of the x-th 64-position half (wgmma's m64 tile)
  const int u0 = kTensorCore ? 2 * (warp >> 2) : 0;
  auto pos = [&](int x) { return 64 * x + 16 * (warp & 3); };
  float acc[4][8][4] = {};  // written only by wgmma after this
  // DGRAD: column sums of the input, bf16: channels 16 kk + 2 tig + {0, 1,
  // 8, 9} of this lane's rows; fp32: one channel's share
  float ds[4][4] = {};
  float dsum = 0.0f;
  float acc32[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // fp32: 4 output channels of one position
  float st32[2][4] = {};  // CHAIN, fp32: sums and sums of squares of those channels over the run
  float csum[2] = {}, csq[2] = {};  // CHAIN, bf16: those of channels l and 32 + l over the run

  if constexpr (WIDE) {
    if (n > 0) load_weight_tile<T, KF>(w_s, wt, w, 0, 0, decode_fwd<T, KF, WIDE>(w, it0).og, tid);
  } else {
    load_weights<T>(w_s, wt, (KF == 1 ? kt : 1) * KF * kC, tid);
  }
  cp_async_commit();

  // CHAIN: the run's sums and sums of squares of output group co0 / 64, from
  // the warps' registers through their stages, into the block's partial row
  // [sums Cout, sums of squares Cout] (C = 64: once, at the end of the run)
  auto flush_stats = [&](int co0) {
    if constexpr (kTensorCore) {
      __syncwarp();  // its stage is free
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        stage[32 * half + lane] = csum[half];
        stage[kC + 32 * half + lane] = csq[half];
      }
    } else {
      // the warp's two positions (lanes l, l ^ 16)
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const float v = st32[s2][nn] + __shfl_xor_sync(0xffffffffu, st32[s2][nn], 16);
          if (lane < 16) stage[s2 * kC + (tid & 15) * 4 + nn] = v;
          if constexpr (WIDE) st32[s2][nn] = 0.0f;
        }
      }
    }
    __syncthreads();
    if (tid < 2 * kC) {
      float v = 0.0f;
#pragma unroll
      for (int p = 0; p < kThreads / 32; ++p) v += stat_s[p * 2 * kC + tid];
      if constexpr (WIDE) {
        partials[size_t(g) * 2 * cout + (tid < kC ? 0 : cout) + co0 + (tid & (kC - 1))] = v;
      } else {
        partials[size_t(g) * 2 * kC + tid] = v;
      }
    }
    if constexpr (WIDE) __syncthreads();  // before the next group's epilogue reuses the stages
  };

  // DGRAD: the column sums of input channels [c0, c0 + 64) (C = 64: once, at
  // the end of the run; WIDE: after each slab of the items of group 0) over
  // the lanes in a fixed order into red [warp or part][channel], then the
  // warps or parts into the block's row (WIDE: added to it)
  auto flush_dsums = [&](float (*red)[kC], int c0) {
    if constexpr (kTensorCore) {
      // over the 8 lanes of one tig; lane tig of the warp's first 4 holds
      // channels 16 kk + 2 tig + {0, 1, 8, 9}
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = ds[kk][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) red[warp][16 * kk + 2 * lane + (e & 1) + 8 * (e >> 1)] = v;
        }
      }
    } else {
      red[tid >> 6][tid & 63] = dsum;
      if constexpr (WIDE) dsum = 0.0f;
    }
    __syncthreads();
    if (tid < kC && (!WIDE || c0 + tid < cin)) {
      constexpr int kParts = kTensorCore ? kThreads / 32 : kThreads / kC;
      float v = 0.0f;
#pragma unroll
      for (int p = 0; p < kParts; ++p) v += red[p][tid];
      if constexpr (WIDE) {
        partials[size_t(g) * cin + c0 + tid] += v;
      } else {
        partials[size_t(g) * kC + tid] = v;
      }
    }
    if constexpr (WIDE) __syncthreads();  // before the next slab's sums overwrite red
  };

  int base = 0;  // the current item's first ring row number (slot = number mod S)
  int s = 0;     // steps so far: the weight buffer of a step is s & 1
  for (int k = 0; k < n; ++k) {
    const FwdItem it = decode_fwd<T, KF, WIDE>(w, it0 + k);
    auto row_of = [&](const FwdItem& m, int p) { return m.r + (m.q * R + p - centre) * w.dt; };
    const FwdItem nx = k + 1 < n ? decode_fwd<T, KF, WIDE>(w, it0 + k + 1) : FwdItem{0, 0, 0, 0, 0};
    // the next item of this residue, in this run, takes its rows over (one
    // slab only: with more, each slab loads its rows anew)
    const bool next_continues = nx.q > 0 && n_slab == 1;
    const int t_out0 = row_of(it, u0 + centre);  // the warp(group)'s first output row
    bool first = true;  // the item's first product replaces the accumulators
    if constexpr (CHAIN && kTensorCore) {
      // CHAIN zeroes them instead and always accumulates, so that the
      // accumulators are dead from the epilogue on: the statistics there
      // need the registers
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) acc[q][nt][0] = acc[q][nt][1] = acc[q][nt][2] = acc[q][nt][3] = 0.0f;
      }
    }

    for (int cs = 0; cs < n_slab; ++cs) {  // C = 64: one slab
      const int c0 = cs * kC;
      if (k > 0 && it.q > 0 && n_slab == 1) {
        base += R;  // rows m < early were issued during the previous item
        if (early < R) {
          __syncthreads();  // every thread is done with the previous item's rows
          for (int m = early; m < R; ++m) {
            load_row<T, KF, WIDE>(ring + ((base + kt - 1 + m) % S) * kRowElems, x, w, it.b,
                                  row_of(it, kt - 1 + m), it.f0 - pad_f, cin, c0, tid);
          }
          cp_async_commit();
        }
      } else {
        __syncthreads();  // every thread is done with the ring
        base += S;
        for (int p = 0; p < S; ++p) {
          load_row<T, KF, WIDE>(ring + ((base + p) % S) * kRowElems, x, w, it.b, row_of(it, p),
                                it.f0 - pad_f, cin, c0, tid);
        }
        cp_async_commit();
      }

      for (int i = 0; i < kt; ++i, ++s) {
        cp_async_wait<0>();  // this step's weights and rows have landed (this thread's copies)
        __syncthreads();     // everyone's; everyone is done with the previous step
        if constexpr (WIDE) {
          // the next step's weight tile: the next tap, else the next slab's
          // first, else the next item's first
          const bool last_tap = i + 1 == kt, last_slab = cs + 1 == n_slab;
          if (!last_tap || !last_slab || k + 1 < n) {
            load_weight_tile<T, KF>(w_s + ((s + 1) & 1) * kTapElems, wt, w, last_tap ? 0 : i + 1,
                                    last_tap ? (last_slab ? 0 : cs + 1) : cs,
                                    last_tap && last_slab ? nx.og : it.og, tid);
          }
        } else if (KF > 1 && (k + 1 < n || i + 1 < kt)) {
          load_weights<T>(w_s + ((s + 1) & 1) * kTapElems, wt + size_t((i + 1) % kt) * kTapElems,
                          KF * kC, tid);
        }
        if (next_continues && i >= 1 && i - 1 < early) {
          // its new row m = i - 1, into the slot of this item's row m, which
          // step m was the last to read
          load_row<T, KF, WIDE>(ring + ((base + S + i - 1) % S) * kRowElems, x, w, nx.b,
                                row_of(nx, kt - 1 + i - 1), nx.f0 - pad_f, cin, 0, tid);
        }
        cp_async_commit();

        const T* w_tap = w_s + (kResidentW ? i : (s & 1)) * kTapElems;
        // DGRAD: every input element is summed once, by the items of group 0
        const bool sums = DGRAD && i == centre && (!WIDE || it.og == 0);
        if constexpr (kTensorCore) {
          // skip a step whose input rows are all outside [0, T) (zeros) or
          // whose output rows all are: uniform over the warpgroup
          const int t_lo = row_of(it, u0 + i), t_hi = row_of(it, u0 + 1 + i);
          if (t_out0 < w.T && t_hi >= 0 && t_lo < w.T) {
            const T* rows[2] = {ring + ((base + u0 + i) % S) * kRowElems,
                                ring + ((base + u0 + 1 + i) % S) * kRowElems};
            uint32_t a[2][4][4];  // A of tiles q, double-buffered across products
#pragma unroll
            for (int jk = 0; jk < KF * (kC / 16); ++jk) {
              const int j = jk / (kC / 16), kk = jk % (kC / 16);
              uint32_t (&af)[4][4] = a[jk & 1];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                ldmatrix_x4(af[q], rows[q / 2] + swz<T>(pos(q % 2) + (lane & 15) + j, kk * 16 + (lane >> 4) * 8));
              }
              if (sums && j == pad_f) {  // every input element is the centre of one output row
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float2 r0 = unpack_bf16(af[q][0]), r1 = unpack_bf16(af[q][1]);
                  const float2 r2 = unpack_bf16(af[q][2]), r3 = unpack_bf16(af[q][3]);
                  ds[kk][0] += r0.x + r1.x;
                  ds[kk][1] += r0.y + r1.y;
                  ds[kk][2] += r2.x + r3.x;
                  ds[kk][3] += r2.y + r3.y;
                }
              }
              const uint64_t desc = b_desc(w_tap + (j * kC + kk * 16) * kC);
              wgmma_fence();
#pragma unroll
              for (int q = 0; q < 4; ++q) wgmma_m64n64k16(acc[q], af[q], desc, CHAIN || !first);
              wgmma_commit();
              wgmma_wait<1>();  // the product before this one is done: its A registers are free
              first = false;
            }
            wgmma_wait<0>();  // before the next barrier frees the weights
          }
        } else {
          // one position, 4 output channels a thread
          const int m = tid >> 4, n0 = (tid & 15) * 4;
          const int t_in = row_of(it, i);
          if (t_out0 < w.T && t_in >= 0 && t_in < w.T) {
            const T* a_row = ring + ((base + i) % S) * kRowElems;
            for (int j = 0; j < KF; ++j) {
#pragma unroll 4
              for (int c = 0; c < kC; ++c) {
                const float av = to_float(a_row[swz<T>(m + j, c)]);
                const T* wr = w_tap + swz<T>(j * kC + c, n0);
#pragma unroll
                for (int nn = 0; nn < 4; ++nn) acc32[nn] = fmaf(av, to_float(wr[nn]), acc32[nn]);
              }
            }
          }
          if (sums) {
            // each input element once: the item's row is the centre row of its
            // output row
            const int c = tid & 63, part = tid >> 6;
            for (int p = part * (TF / 4); p < (part + 1) * (TF / 4); ++p) {
              dsum += to_float(ring[((base + centre) % S) * kRowElems + swz<T>(p + pad_f, c)]);
            }
          }
        }
      }

      if constexpr (WIDE && DGRAD) {
        if (it.og == 0) {  // the slab's column sums, added to the block's row
          __shared__ float red_w[kThreads / 32][kC];
          flush_dsums(red_w, c0);
        }
      }
    }

    // epilogue: (CHAIN: + bias; EVAL: + bias, BatchNorm, activation) round
    // once, write 16 bytes a lane
    const int co0 = it.og * kC;  // the group's first output channel
    if constexpr (kTensorCore) {
      if (t_out0 < w.T) {
        const int gr = lane >> 2, tig = lane & 3, quad = lane & ~3;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = row_of(it, u0 + q / 2 + centre);
          T* const out_row = out + (size_t(it.b) * w.T + (t < w.T ? t : 0)) * w.F * cout + co0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = it.f0 + pos(q % 2) + gr + 8 * h;
            uint32_t wd[8];  // channels 8 nt + 2 tig + {0, 1} of this lane's position
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              float v0 = acc[q][nt][2 * h], v1 = acc[q][nt][2 * h + 1];
              if constexpr (CHAIN) {
                v0 += bias_s[co0 + 8 * nt + 2 * tig];
                v1 += bias_s[co0 + 8 * nt + 2 * tig + 1];
              }
              if constexpr (EVAL) eval_pair(v0, v1, stat_s, cout, co0 + 8 * nt + 2 * tig, ep.act);
              wd[nt] = pack_bf16(v0, v1);
            }
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              // round rr: lane tig sends its pair of tile 4 half + (tig + rr) mod 4 and
              // receives the pair of tile 4 half + tig from lane (tig - rr) mod 4
              uint32_t rot[4];
#pragma unroll
              for (int rr = 0; rr < 4; ++rr) {
                const uint32_t v = sel4(wd[4 * half], wd[4 * half + 1], wd[4 * half + 2],
                                        wd[4 * half + 3], (tig + rr) & 3);
                rot[rr] = __shfl_sync(0xffffffffu, v, quad | ((tig - rr) & 3));
              }
              uint4 v;  // pairs from lanes 0, 1, 2, 3 of the quad
              v.x = sel4(rot[0], rot[1], rot[2], rot[3], tig);
              v.y = sel4(rot[0], rot[1], rot[2], rot[3], (tig + 3) & 3);
              v.z = sel4(rot[0], rot[1], rot[2], rot[3], (tig + 2) & 3);
              v.w = sel4(rot[0], rot[1], rot[2], rot[3], (tig + 1) & 3);
              const int ch = (4 * half + tig) * 8;  // this lane's 8 channels of the group
              const bool inside = t < w.T && f < w.F;
              if (inside) {
                *reinterpret_cast<uint4*>(out_row + size_t(f) * cout + ch) = v;
              }
              if constexpr (CHAIN) {
                // the warp's 8 positions x 32 channels (zero outside the
                // tensor) through its stage; lane l sums channel 32 half + l
                reinterpret_cast<uint4*>(stage)[lane] = inside ? v : make_uint4(0, 0, 0, 0);
                __syncwarp();
#pragma unroll
                for (int p = 0; p < 8; ++p) {
                  const float r = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(stage)[32 * p + lane]);
                  csum[half] += r;
                  csq[half] += r * r;
                }
                __syncwarp();  // before the next tile overwrites the stage
              }
            }
          }
        }
      }
    } else {
      const int m = tid >> 4, n0 = (tid & 15) * 4;
      if (t_out0 < w.T && it.f0 + m < w.F && (!WIDE || co0 + n0 < cout)) {
        float v[4];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          v[nn] = CHAIN ? acc32[nn] + bias_s[co0 + n0 + nn] : acc32[nn];
          if constexpr (CHAIN) {
            st32[0][nn] += v[nn];
            st32[1][nn] += v[nn] * v[nn];
          }
        }
        if constexpr (EVAL) {
          eval_pair(v[0], v[1], stat_s, cout, co0 + n0, ep.act);
          eval_pair(v[2], v[3], stat_s, cout, co0 + n0 + 2, ep.act);
        }
        *reinterpret_cast<float4*>(out + ((size_t(it.b) * w.T + t_out0) * w.F + it.f0 + m) * cout + co0 + n0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      acc32[0] = acc32[1] = acc32[2] = acc32[3] = 0.0f;
    }

    if constexpr (CHAIN && WIDE) {
      if (k + 1 == n || nx.og != it.og) flush_stats(co0);  // the run leaves the group
    }
  }
  if constexpr (CHAIN && !WIDE) flush_stats(0);

  if constexpr (DGRAD && !WIDE) {
    __shared__ float red_s[kThreads / 32][kC];
    flush_dsums(red_s, 0);
  }
}

template <typename T, int KF, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
conv_dilated_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                        const FwdWork work) {
  conv_fwd_body<T, KF, kFwdPlain, WIDE>(x, w, nullptr, out, nullptr, work, EvalParams{});
}

template <typename T, int KF, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
conv_dgrad_kernel(const T* __restrict__ d_raw, const T* __restrict__ w, T* __restrict__ dx,
                  float* __restrict__ partials, const FwdWork work) {
  conv_fwd_body<T, KF, kFwdDgrad, WIDE>(d_raw, w, nullptr, dx, partials, work, EvalParams{});
}

template <typename T, int KF, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_act_fwd_kernel(const T* __restrict__ y, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ raw,
                       float* __restrict__ partials, const FwdWork work) {
  conv_fwd_body<T, KF, kFwdChain, WIDE>(y, w, bias, raw, partials, work, EvalParams{});
}

template <typename T, int KF, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_act_eval_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                        const EvalParams ep, const FwdWork work) {
  conv_fwd_body<T, KF, kFwdEval, WIDE>(x, w, nullptr, out, nullptr, work, ep);
}

template <typename T, int KF, int MODE, bool WIDE>
auto fwd_kernel() {
  if constexpr (MODE == kFwdEval) {
    return conv_bn_act_eval_kernel<T, KF, WIDE>;
  } else if constexpr (MODE == kFwdChain) {
    return conv_bn_act_fwd_kernel<T, KF, WIDE>;
  } else if constexpr (MODE == kFwdDgrad) {
    return conv_dgrad_kernel<T, KF, WIDE>;
  } else {
    return conv_dilated_fwd_kernel<T, KF, WIDE>;
  }
}

struct FwdPlan {
  FwdWork work;
  bool wide;  // the instantiation for other channels than 64 in and out (fp32 here, bf16 wide tiles)
  int blocks, resident, registers, local_bytes;
  size_t smem, scratch;  // dynamic shared memory bytes; fp32 scratch elements
  int rows;              // partial rows the sums reduce
};

template <typename T, int KF, int MODE, bool WIDE>
cudaError_t plan_kf(int B, int T_, int F, int cin, int cout, int kt, int dt, FwdPlan* p) {
  constexpr int R = FwdShape<T, KF>::R, TF = FwdShape<T, KF>::TF;
  p->wide = WIDE;
  p->smem = fwd_smem_bytes<T, KF, MODE, WIDE>(kt, cout);
  // fails when the ring and the weights do not fit one block's shared memory
  cudaError_t err = occupancy(fwd_kernel<T, KF, MODE, WIDE>(), p->smem, &p->resident, &p->registers,
                              &p->local_bytes);
  if (err != cudaSuccess) return err;
  FwdWork& w = p->work;
  w.T = T_;
  w.F = F;
  w.kt = kt;
  w.dt = dt;
  w.cin = cin;
  w.cout = cout;
  w.n_slab = (cin + kC - 1) / kC;
  w.n_grp = (cout + kC - 1) / kC;
  w.n_ft = (F + TF - 1) / TF;
  w.n_col = 0;
  for (int r = 0; r < dt && r < T_; ++r) {
    const int len = (T_ - r + dt - 1) / dt;
    w.n_col += (len + R - 1) / R;
  }
  w.items = (long long)w.n_grp * B * w.n_ft * w.n_col;
  p->blocks = w.blocks = int(w.items < p->resident ? w.items : p->resident);
  p->scratch = size_t(w.blocks) * (MODE == kFwdDgrad ? cin : MODE == kFwdChain ? 2 * cout : 0);
  p->rows = w.blocks;
  return cudaSuccess;
}

template <typename T, int MODE, bool WIDE>
cudaError_t plan_wide(int B, int T_, int F, int cin, int cout, int kt, int kf, int dt, FwdPlan* p) {
  switch (kf) {
    case 1: return plan_kf<T, 1, MODE, WIDE>(B, T_, F, cin, cout, kt, dt, p);
    case 3: return plan_kf<T, 3, MODE, WIDE>(B, T_, F, cin, cout, kt, dt, p);
    case 5: return plan_kf<T, 5, MODE, WIDE>(B, T_, F, cin, cout, kt, dt, p);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int MODE>
cudaError_t plan(int B, int T_, int F, int cin, int cout, int kt, int kf, int dt, FwdPlan* p) {
  constexpr int kVec = 16 / int(sizeof(T));  // channels a 16-byte copy moves
  if (bad_shape(B, T_, F, kt, kf, dt) || cin <= 0 || cout <= 0 || cin % kVec || cout % kVec) {
    return cudaErrorInvalidValue;
  }
  if (cin == kC && cout == kC) return plan_wide<T, MODE, false>(B, T_, F, cin, cout, kt, kf, dt, p);
  if constexpr (sizeof(T) == 2) {
    wide::FwdWideInfo info;
    cudaError_t err = wide::conv_fwd_wide_plan(B, T_, F, cin, cout, kt, kf, dt, MODE, &info);
    if (err != cudaSuccess) return err;
    p->wide = true;
    p->blocks = info.blocks;
    p->resident = info.resident;
    p->registers = info.registers;
    p->local_bytes = info.local_bytes;
    p->smem = info.tile.smem;
    p->scratch = size_t(info.scratch);
    p->rows = info.partial_rows;
    return cudaSuccess;
  } else {
    return plan_wide<T, MODE, true>(B, T_, F, cin, cout, kt, kf, dt, p);
  }
}

// The kernel of MODE for kf frequency taps and the plan's channels on
// `args`, then its work.
template <typename T, int MODE, bool WIDE, typename... Args>
void launch_kf(const FwdPlan& p, int kf, cudaStream_t stream, Args... args) {
  switch (kf) {
    case 1: fwd_kernel<T, 1, MODE, WIDE>()<<<p.blocks, kThreads, p.smem, stream>>>(args..., p.work); break;
    case 3: fwd_kernel<T, 3, MODE, WIDE>()<<<p.blocks, kThreads, p.smem, stream>>>(args..., p.work); break;
    default: fwd_kernel<T, 5, MODE, WIDE>()<<<p.blocks, kThreads, p.smem, stream>>>(args..., p.work); break;
  }
}

template <typename T, int MODE, typename... Args>
cudaError_t launch_body(const FwdPlan& p, int kf, cudaStream_t stream, Args... args) {
  if constexpr (sizeof(T) == 2) {
    launch_kf<T, MODE, false>(p, kf, stream, args...);  // other widths: conv_fwd_wide.cu
  } else if (p.wide) {
    launch_kf<T, MODE, true>(p, kf, stream, args...);
  } else {
    launch_kf<T, MODE, false>(p, kf, stream, args...);
  }
  return cudaGetLastError();
}

// bf16 at other widths than 64 goes to conv_fwd_wide.cu
template <typename T>
bool takes_tiles(int cin, int cout) {
  return sizeof(T) == 2 && !(cin == kC && cout == kC);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, void* out, int B, int T_, int F, int cin,
                       int cout, int kt, int kf, int dt, cudaStream_t stream) {
  if (takes_tiles<T>(cin, cout)) {
    wide::FwdWideInfo info;
    return wide::conv_fwd_wide_launch(kFwdPlain, x, w, nullptr, out, nullptr, B, T_, F, cin, cout, kt, kf, dt,
                                      stream, &info);
  }
  FwdPlan p;
  cudaError_t err = plan<T, kFwdPlain>(B, T_, F, cin, cout, kt, kf, dt, &p);
  if (err != cudaSuccess) return err;
  return launch_body<T, kFwdPlain>(p, kf, stream, static_cast<const T*>(x), static_cast<const T*>(w),
                                   static_cast<T*>(out));
}

// conv_bn_act_eval: the eval mode's kernel at (cin, cout) with the layer's
// vectors in ep.
template <typename T>
cudaError_t launch_eval(const void* x, const void* w, void* out, const EvalParams& ep, int B, int T_, int F,
                        int cin, int cout, int kt, int kf, int dt, cudaStream_t stream) {
  if (takes_tiles<T>(cin, cout)) {
    wide::FwdWideInfo info;
    return wide::conv_fwd_wide_launch(kFwdEval, x, w, nullptr, out, nullptr, B, T_, F, cin, cout, kt, kf, dt,
                                      stream, &info, &ep);
  }
  FwdPlan p;
  cudaError_t err = plan<T, kFwdEval>(B, T_, F, cin, cout, kt, kf, dt, &p);
  if (err != cudaSuccess) return err;
  return launch_body<T, kFwdEval>(p, kf, stream, static_cast<const T*>(x), static_cast<const T*>(w),
                                  static_cast<T*>(out), ep);
}

// conv_dgrad (sums: dbias [C]) or conv_bn_act_fwd (bias; sums: stats [2][C]):
// the kernel, then its per-block partial rows added in a fixed order.
template <typename T, int MODE>
cudaError_t launch_with_sums(const void* x, const void* w, const float* bias, void* out,
                             void* sums, void* scratch, int B, int T_, int F, int C, int kt, int kf,
                             int dt, cudaStream_t stream) {
  float* partials = static_cast<float*>(scratch);
  cudaError_t err;
  int rows;  // the partial rows the launch wrote
  if (takes_tiles<T>(C, C)) {
    wide::FwdWideInfo info;
    err = wide::conv_fwd_wide_launch(MODE, x, w, bias, out, partials, B, T_, F, C, C, kt, kf, dt, stream,
                                     &info);
    rows = info.partial_rows;
  } else {
    FwdPlan p;
    err = plan<T, MODE>(B, T_, F, C, C, kt, kf, dt, &p);
    if (err != cudaSuccess) return err;
    rows = p.rows;
    const T* x_ = static_cast<const T*>(x);
    const T* w_ = static_cast<const T*>(w);
    if constexpr (MODE == kFwdChain) {
      err = launch_body<T, MODE>(p, kf, stream, x_, w_, bias, static_cast<T*>(out), partials);
    } else {
      err = launch_body<T, MODE>(p, kf, stream, x_, w_, static_cast<T*>(out), partials);
    }
  }
  if (err != cudaSuccess) return err;
  const int width = MODE == kFwdChain ? 2 * C : C;
  reduce_rows_kernel<32><<<(width + 31) / 32, dim3(32, 32), 0, stream>>>(
      partials, rows, width, static_cast<float*>(sums));
  return cudaGetLastError();
}

template <typename T>
cudaError_t plan_mode(int B, int T_, int F, int cin, int cout, int kt, int kf, int dt, int mode,
                      FwdPlan* p) {
  switch (mode) {
    case kFwdPlain: return plan<T, kFwdPlain>(B, T_, F, cin, cout, kt, kf, dt, p);
    case kFwdDgrad: return plan<T, kFwdDgrad>(B, T_, F, cin, cout, kt, kf, dt, p);
    case kFwdChain: return plan<T, kFwdChain>(B, T_, F, cin, cout, kt, kf, dt, p);
    case kFwdEval: return plan<T, kFwdEval>(B, T_, F, cin, cout, kt, kf, dt, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function returns its
// cudaError_t; 0 is success.  `bf16` selects bf16 activations and weights,
// otherwise fp32; bias, stats ([2, C]: sums, sums of squares), dbias,
// scratch and conv_bn_act_eval's [Cout] vectors are fp32.  Activations are [B, T, F, Cin] in and [B, T, F, Cout]
// out, weights [kt, kf, Cin, Cout] (conv_dgrad: flipped and transposed by
// the caller; conv_dgrad and conv_bn_act_fwd take Cin = Cout = C), channel
// counts a multiple of 8 (bf16) or 4 (fp32).  `scratch` holds the per-block
// partial sums of conv_dgrad and conv_bn_act_fwd (conv_fwd_launch_config
// gives its size).

extern "C" int conv_dilated_fwd(const void* x, const void* w, void* out, int B, int T, int F,
                                int cin, int cout, int kt, int kf, int dt, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, w, out, B, T, F, cin, cout, kt, kf, dt, s)
              : launch_fwd<float>(x, w, out, B, T, F, cin, cout, kt, kf, dt, s);
}

// The eval-mode layer: the conv of x [B, T, F, cin] with w [kt, kf, cin,
// cout], then act((. + bias) inv + shift) with inv = scale / sqrt(var + eps),
// shift = beta - mean inv, rounded once into out [B, T, F, cout]; act 1 mish,
// 2 relu.
extern "C" int conv_bn_act_eval(const void* x, const void* w, const void* bias, const void* scale,
                                const void* beta, const void* mean, const void* var, void* out, int B,
                                int T, int F, int cin, int cout, int kt, int kf, int dt, float eps,
                                int act, int bf16, void* stream) {
  if (act != kMish && act != kRelu) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EvalParams ep{static_cast<const float*>(bias), static_cast<const float*>(scale),
                      static_cast<const float*>(beta),  static_cast<const float*>(mean),
                      static_cast<const float*>(var),   eps, act};
  return bf16 ? launch_eval<__nv_bfloat16>(x, w, out, ep, B, T, F, cin, cout, kt, kf, dt, s)
              : launch_eval<float>(x, w, out, ep, B, T, F, cin, cout, kt, kf, dt, s);
}

extern "C" int conv_bn_act_fwd(const void* y, const void* w, const void* bias, void* raw,
                               void* stats, void* scratch, int B, int T, int F, int C, int kt,
                               int kf, int dt, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  return bf16 ? launch_with_sums<__nv_bfloat16, kFwdChain>(y, w, b, raw, stats, scratch, B, T, F,
                                                           C, kt, kf, dt, s)
              : launch_with_sums<float, kFwdChain>(y, w, b, raw, stats, scratch, B, T, F, C, kt,
                                                   kf, dt, s);
}

extern "C" int conv_dgrad(const void* d_raw, const void* w_flipped, void* dx, void* dbias,
                          void* scratch, int B, int T, int F, int C, int kt, int kf, int dt,
                          int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_with_sums<__nv_bfloat16, kFwdDgrad>(d_raw, w_flipped, nullptr, dx, dbias,
                                                           scratch, B, T, F, C, kt, kf, dt, s)
              : launch_with_sums<float, kFwdDgrad>(d_raw, w_flipped, nullptr, dx, dbias, scratch, B,
                                                   T, F, C, kt, kf, dt, s);
}

// Launch shape of conv_dilated_fwd (mode 0), conv_dgrad (mode 1),
// conv_bn_act_fwd (mode 2) or conv_bn_act_eval (mode 3) on the current card: blocks (never more than
// `resident`, the blocks the card holds at once), threads, dynamic shared
// memory, fp32 scratch elements, registers a thread and local (spilled)
// bytes a thread.
extern "C" int conv_fwd_launch_config(int B, int T, int F, int cin, int cout, int kt, int kf,
                                      int dt, int bf16, int mode, int* blocks, int* threads,
                                      long long* smem, long long* scratch, int* resident,
                                      int* registers, int* local_bytes) {
  FwdPlan p;
  cudaError_t err = bf16 ? plan_mode<__nv_bfloat16>(B, T, F, cin, cout, kt, kf, dt, mode, &p)
                         : plan_mode<float>(B, T, F, cin, cout, kt, kf, dt, mode, &p);
  if (err != cudaSuccess) return err;
  *blocks = p.blocks;
  *threads = kThreads;
  *smem = static_cast<long long>(p.smem);
  *scratch = static_cast<long long>(p.scratch);
  *resident = p.resident;
  *registers = p.registers;
  *local_bytes = p.local_bytes;
  return cudaSuccess;
}
