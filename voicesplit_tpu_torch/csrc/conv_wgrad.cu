// Weight gradient of the "same" time-dilated conv for Hopper (sm_90a): the
// fused chain's conv_wgrad and the opt-in path's conv_dilated_wgrad, and the
// chain's two elementwise passes.
//
// Replaces the TPU kernels (the Python wrappers of the same names, in
// ops/conv_fused.py and ops/conv_cuda.py, launch the C functions below)
//   conv_wgrad         <- voicesplit_tpu/ops/conv_fused.py  _wgrad_kernel (:524, launched by
//                         _conv_wgrad :583): conv_wgrad_prologue (lhs_prologue), then conv_wgrad
//   conv_dilated_wgrad <- voicesplit_tpu/ops/conv_pallas.py _wgrad_kernel (:234, launched by
//                         _conv_wgrad_core :292): conv_wgrad
//   conv_draw_prologue <- the BatchNorm-backward prologue of the TPU's chain kernels
//                         (_prologue_draw_inplace :221): the prologue=True branch of
//                         _dgrad_kernel (:423-444) as conv_draw_prologue then conv_dgrad
//                         (conv_fwd.cu), the rhs_prologue branch of _wgrad_kernel
//                         (:539-540, :561-563) as conv_draw_prologue then conv_wgrad
//
// The d_raw pass (draw_prologue_kernel, at the end of the file) reads dy and
// the raw conv output x [B, T, F, C] and writes d_raw in their type: 3 x 46
// MB at [2, 301, 601, 64] bf16, 0.041 ms at the memory rate, against one
// exponential and ~25 fp32 operations an element, so bound by bytes.  It is
// a pass of its own and not a transform in the conv kernels' rings for the
// reason the forward's prologue is one (a prologue in the forward kernel's
// ring measured slower than a pass; the first conv_wgrad spent 40% of its
// time redoing its prologue once per time tap), and writing only [0, T) x
// [0, F) keeps the convs' halo zero after the draw.
//
// Channels-last activations y [B, T, F, Cin] and d [B, T, F, Cout], time
// dilation dt, frequency dilation 1, odd kt, kf in {1, 3, 5}:
//
//   dW[i, j, c, co] = sum_{b,t,f} y[b, t + i*dt - pad_t, f + j - pad_f, c] * d[b, t, f, co]  (fp32)
//
// a tap outside [0, T) x [0, F) contributing zero.  conv_dilated_wgrad takes
// y = x.  conv_wgrad takes y = round(act(float(x) * inv[c] + shift[c])), the
// previous layer's BatchNorm affine and activation (the chain's prologue,
// every step rounded on its own as the plain version computes it); it is a
// prologue pass that writes y once into a scratch tensor, then the same
// weight-gradient kernel, so conv_wgrad on x gives the bits of
// conv_dilated_wgrad on y.  The TPU kernel activates each window once and
// runs every tap from it (conv_fused.py:557-582); here the prologue runs
// once per input element per call, where the first version ran it once per
// time tap that staged the row (40% of its time).
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense):
// a (5,5) layer at [2, 301, 601, 64] is 74 GFLOP against 93 MB, bound by
// operations (0.074 ms); the (7,1) layer (21 GFLOP) by bytes (0.028 ms).  The
// prologue pass moves 2 x 46 MB at B=2 (0.028 ms at the memory rate).
//
// Design.
//
//   Work items (kf = 3, 5: conv_wgrad_kernel).  An item is (time tap i, row
//   (b, t), 128 frequency positions); rows whose tap falls outside [0, T)
//   are not items at all (at dilation 16 taps 0 and 4 skip 32 of every 301
//   rows).  Items are numbered tap-major, row, then frequency tile, and
//   block g of G takes the contiguous run [g N / G, (g+1) N / G): every block
//   gets the same number of items, within one.  G is the number of blocks
//   the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
//   SMs; 2 x 132 on an H100) or N if smaller, so the launch is one whole
//   wave and no block runs alone after it.  Blocks of different taps start
//   at the same relative row and move at the same pace, so the kt blocks
//   that read a row of d (and the overlapping rows of y) read it at about
//   the same time and L2 serves the re-reads.
//
//   Work items (kf = 1: conv_wgrad_kf1_kernel).  dW of all kt <= 7 taps fits
//   one block's registers (7 x 16 floats a thread), so one block owns every
//   tap: an item is (row (b, t), 64 frequency positions), and the rows of a
//   column come in residue-major order (t mod dt, then t), so that items t
//   and t + dt share kt - 1 input rows.  The input rows stay in a ring of
//   tiles in shared memory: an item loads its row of d and one new input
//   row (all kt at the start of a run), and every row of y and d crosses
//   from memory once per column instead of once per tap.  One block per SM
//   (the ring, with a tile of zeros for rows outside [0, T), takes
//   230,400 B); balanced runs as above.
//
//   Loads.  Each item stages its tiles of d and y (the y tile of a kf-wide
//   tap 128 + kf - 1 positions, the halo zero-filled) into a three-stage
//   ring in shared memory with cp.async (16 bytes a thread, src-size 0 for
//   the halo), two items ahead of the one being multiplied; rows keep the
//   16-byte padding that makes ldmatrix free of bank conflicts.  A stage
//   waits only for its own copy group.  A frequency tile that ends past F
//   multiplies only the 16-position steps that hold a position inside it.
//
//   Products.  bf16: mma.sync.m16n8k16 (fp32 accumulate); positions are the
//   contraction dimension.  Warp (wm, wn) of 8 owns input channels
//   [16 wm, +16) x output channels [32 wn, +32) of every tap: A = y^T read
//   with ldmatrix.trans at row offset j for frequency tap j (any row address
//   is legal for ldmatrix, which is why this is not wgmma: a shift of j rows
//   of 128 bytes breaks wgmma's swizzled shared-memory layouts), B = d.
//   fp32: FMAs on CUDA cores (not TF32), the tests' instantiation at reduced
//   shapes.  dW lives in registers (kf x 16 or kt x 16 floats a thread).
//
//   Sums across blocks.  When its run moves to the next tap and at its
//   end, a block writes its partial dW[i] to row g + i of the scratch
//   (rows are unique: runs are contiguous and tap-major), so tap i's
//   partials are one contiguous range of rows (kf = 1: row g holds every
//   tap); reduce_taps_kernel adds each range in a fixed order, in double,
//   into its block of dW.
//   No float atomics: the same inputs give the same bits.
//
//   Channels.  Every tile above is 64 channels wide, and C = 64 in and out
//   is its own compile-time instantiation (WIDE = false), as described.  Any
//   other Cin, Cout (a multiple of 8, which the 16-byte copies need) goes in
//   bf16 to conv_wgrad_wide.cu (wgmma.m64nNk16 over all output channels of
//   a group of up to 128, the tiles of a tap in segments; the tile from
//   conv_wide.cuh's table) and in fp32 (WIDE = true, CUDA-core FMAs: the
//   tests' instantiation) to the pair route of these kernels: it is
//   worked in pairs of a 64-wide input slab and a 64-wide output
//   group: an item also names its pair (pairs outermost in the numbering,
//   then as above), stages that slab of y and that group of d (channels past
//   Cin or Cout read as zero, as the halo) and computes that 64 x 64 block
//   of dW.  A block flushes its partials when its run moves to the next
//   (pair, tap) segment (kf = 1: the next pair), to row g + segment, so the
//   scratch grows by (Cin / 64) (Cout / 64) kt rows (kf = 1: pairs), and
//   reduce_taps_kernel adds each segment's range as above into its block
//   of dW [kt][kf][Cin][Cout].  The prologue pass
//   reads its per-channel table for any C, a multiple of 8.

#include "conv_tile.cuh"
#include "conv_wide.cuh"

namespace {

constexpr int kStages = 3;  // cp.async ring depth

// Items of one launch; block g takes [g * items / blocks, (g+1) * items / blocks).
struct WgradWork {
  int T, F, dt, pad_t, n_ft, blocks;
  long long items;
  int t_lo[kMaxTaps], n_rows[kMaxTaps];  // tap i's rows: t in [t_lo, t_lo + n_rows) per b
  long long first[kMaxTaps + 1];         // tap i's items (of one pair): [first[i], first[i + 1])
  int kt, cin, cout, n_og;  // WIDE: pair p is input slab p / n_og, output group p % n_og
};

struct Item {
  int i, b, t, f0;
  int cs, og;  // input channels [64 cs, +64), output channels [64 og, +64)
};

template <bool WIDE>
__device__ __forceinline__ Item decode(const WgradWork& w, long long item) {
  int cs = 0, og = 0;
  if constexpr (WIDE) {  // pairs outermost
    const long long per_pair = w.first[kMaxTaps];
    const int p = int(item / per_pair);
    item -= (long long)p * per_pair;
    cs = p / w.n_og;
    og = p - cs * w.n_og;
  }
  int i = 0;
  while (item >= w.first[i + 1]) ++i;  // a tap without items has first[i] == first[i + 1]
  const long long l = item - w.first[i];
  const int row = int(l / w.n_ft);
  return {i, row / w.n_rows[i], w.t_lo[i] + row % w.n_rows[i], int(l - (long long)row * w.n_ft) * kTileF,
          cs, og};
}

template <typename T, int KF>
__host__ __device__ constexpr size_t wgrad_y_bytes() {
  return align16(size_t(kTileF + KF - 1) * Ld<T>::value * sizeof(T));
}
template <typename T, int KF>
__host__ __device__ constexpr size_t wgrad_stage_bytes() {
  return wgrad_y_bytes<T, KF>() + align16(size_t(kTileF) * Ld<T>::value * sizeof(T));
}

// Issue one item's copies (y rows with halo, d rows; WIDE: the item's slab
// of y and group of d) into a ring stage.
template <typename T, int KF, bool WIDE>
__device__ __forceinline__ void load_item(unsigned char* stage, const T* __restrict__ y,
                                          const T* __restrict__ d, const WgradWork& w,
                                          long long item, int tid) {
  constexpr int LD = Ld<T>::value;
  constexpr int kVec = 16 / int(sizeof(T));  // elements per 16 bytes
  constexpr int kPerRow = kC / kVec;
  constexpr int y_rows = kTileF + KF - 1;
  constexpr int pad_f = (KF - 1) / 2;
  const int cin = WIDE ? w.cin : kC, cout = WIDE ? w.cout : kC;
  const Item it = decode<WIDE>(w, item);
  const int ti = it.t + it.i * w.dt - w.pad_t;
  const T* y_row = y + (size_t(it.b) * w.T + ti) * w.F * cin + it.cs * kC;
  const T* d_row = d + (size_t(it.b) * w.T + it.t) * w.F * cout + it.og * kC;
  T* y_s = reinterpret_cast<T*>(stage);
  T* d_s = reinterpret_cast<T*>(stage + wgrad_y_bytes<T, KF>());
  for (int e = tid; e < (y_rows + kTileF) * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    const bool is_y = r < y_rows;
    const int p = is_y ? r : r - y_rows;
    const int f = it.f0 + p - (is_y ? pad_f : 0);
    const int stride = is_y ? cin : cout;
    const bool inside =
        f >= 0 && f < w.F && (!WIDE || c < (is_y ? cin - it.cs * kC : cout - it.og * kC));
    const T* row = is_y ? y_row : d_row;
    T* dst = (is_y ? y_s : d_s) + size_t(p) * LD + c;
    cp_async16(dst, inside ? row + size_t(f) * stride + c : row, inside ? 16 : 0);
  }
}

// Write a block's partial dW[i, 0..KF) (layout [KF][64][64]) and zero the
// accumulators.
template <typename T, int KF>
__device__ __forceinline__ void flush_partials(float (&acc)[KF][4][4], float* __restrict__ part,
                                               int tid) {
  if constexpr (sizeof(T) == 2) {
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp & 3, wn = warp >> 2, gr = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int j = 0; j < KF; ++j) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* o = part + (size_t(j) * kC + wm * 16 + gr) * kC + wn * 32 + nt * 8 + 2 * tig;
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][nt][0], acc[j][nt][1]);
        *reinterpret_cast<float2*>(o + 8 * kC) = make_float2(acc[j][nt][2], acc[j][nt][3]);
        acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.0f;
      }
    }
  } else {
    const int c = tid >> 2, n0 = (tid & 3) * 16;
#pragma unroll
    for (int j = 0; j < KF; ++j) {
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        part[(size_t(j) * kC + c) * kC + n0 + m] = acc[j][m >> 2][m & 3];
        acc[j][m >> 2][m & 3] = 0.0f;
      }
    }
  }
}

// grid (blocks); partials [blocks + kt][KF][64][64], row g + i of block g for
// tap i (WIDE: [blocks + pairs kt], row g + p kt + i for pair p).
template <typename T, int KF, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
conv_wgrad_kernel(const T* __restrict__ y, const T* __restrict__ d, float* __restrict__ partials,
                  const WgradWork work) {
  constexpr int LD = Ld<T>::value;
  constexpr bool kTensorCore = sizeof(T) == 2;
  static_assert(!(WIDE && kTensorCore), "bf16 at other widths is conv_wgrad_wide.cu's");
  constexpr size_t kStage = wgrad_stage_bytes<T, KF>();
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x;

  __shared__ WgradWork w;  // indexed by tap below: shared, not the parameter space
  if (tid == 0) w = work;
  __syncthreads();
  const long long it0 = (long long)g * w.items / w.blocks;
  const int n = int((long long)(g + 1) * w.items / w.blocks - it0);

  extern __shared__ __align__(16) unsigned char smem_raw[];  // [kStages][y rows, d rows]

  // tensor cores: warp (wm, wn) owns input channels [16 wm, +16) x output
  // channels [32 wn, +32) of every frequency tap: acc[j][n8 tile][4].
  // FMA: thread owns input channel tid / 4 x 16 output channels.
  float acc[KF][4][4];
#pragma unroll
  for (int j = 0; j < KF; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k][0] = acc[j][k][1] = acc[j][k][2] = acc[j][k][3] = 0.0f;
  }
  const int wm = warp & 3, wn = warp >> 2;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load_item<T, KF, WIDE>(smem_raw + s * kStage, y, d, w, it0 + s, tid);
    cp_async_commit();  // an empty group keeps the count uniform
  }
  int tap = -1;  // the segment (WIDE: pair kt + tap) whose partials the registers hold
  for (int k = 0; k < n; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of item k have landed
    __syncthreads();               // everyone's have; everyone is done with item k - 1's stage
    if (k + kStages - 1 < n) {
      load_item<T, KF, WIDE>(smem_raw + ((k + kStages - 1) % kStages) * kStage, y, d, w,
                             it0 + k + kStages - 1, tid);
    }
    cp_async_commit();

    const Item it = decode<WIDE>(w, it0 + k);
    const int seg = WIDE ? (it.cs * w.n_og + it.og) * w.kt + it.i : it.i;
    if (seg != tap) {
      if (tap >= 0) flush_partials<T, KF>(acc, partials + (size_t(g) + tap) * KF * kC * kC, tid);
      tap = seg;
    }
    const T* y_s = reinterpret_cast<const T*>(smem_raw + (k % kStages) * kStage);
    const T* d_s = reinterpret_cast<const T*>(smem_raw + (k % kStages) * kStage +
                                              wgrad_y_bytes<T, KF>());
    const int n_ks = min(kTileF, w.F - it.f0 + 15) / 16;  // steps holding a position < F
    if constexpr (kTensorCore) {
#pragma unroll 2
      for (int ks = 0; ks < n_ks; ++ks) {
        uint32_t bf[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          ldmatrix_x4_trans(bf[np], d_s + size_t(ks * 16 + (lane & 15)) * LD + wn * 32 + np * 16 +
                                        (lane >> 4) * 8);
        }
        // A[m = channel][k = position] from y_s[position][channel]
        const int krow = ks * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        const int mcol = wm * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int j = 0; j < KF; ++j) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, y_s + size_t(krow + j) * LD + mcol);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_bf16(acc[j][nt], a, bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]);
          }
        }
      }
    } else {
      const int c = tid >> 2, n0 = (tid & 3) * 16;
      for (int p = 0; p < n_ks * 16; ++p) {
        float dv[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) dv[m] = to_float(d_s[size_t(p) * LD + n0 + m]);
#pragma unroll
        for (int j = 0; j < KF; ++j) {
          const float yv = to_float(y_s[size_t(p + j) * LD + c]);
#pragma unroll
          for (int m = 0; m < 16; ++m) acc[j][m >> 2][m & 3] = fmaf(yv, dv[m], acc[j][m >> 2][m & 3]);
        }
      }
    }
  }
  if (tap >= 0) flush_partials<T, KF>(acc, partials + (size_t(g) + tap) * KF * kC * kC, tid);
}

// ---------------------------------------------------------------------------
// kf = 1: every time tap in one block, a sliding window of input rows
// ---------------------------------------------------------------------------

// positions per item: 64 bf16 or 32 fp32 (the ring below must fit one block)
template <typename T> constexpr int kColF = sizeof(T) == 2 ? 64 : 32;
// input tiles in flight: an item brings at most kMaxTaps new ones and the
// ring holds kStages items' worth, so no tile is overwritten while read
constexpr int kYRing = kStages * kMaxTaps;

// Items of the kf = 1 kernel: (b, frequency tile, row t), the rows of one
// (b, tile) in residue-major order (t mod dt, then t), so that consecutive
// items t, t + dt of one residue share kt - 1 of their input rows.
struct ColumnWork {
  int T, F, dt, kt, n_ft, blocks;
  long long items;
  long long per_pair;  // WIDE: items of one (input slab, output group) pair, the outermost
  int cin, cout, n_og;
};

struct ColItem {
  int b, f0, t, q;  // q: rows of the same residue above t
  int p;            // WIDE: the pair, input slab p / n_og and output group p % n_og
};

template <typename T, bool WIDE>
__device__ __forceinline__ ColItem decode_col(const ColumnWork& w, long long item) {
  int pair = 0;
  if constexpr (WIDE) {
    pair = int(item / w.per_pair);
    item -= (long long)pair * w.per_pair;
  }
  const int per_b = w.n_ft * w.T;
  const int b = int(item / per_b);
  const int rem = int(item - (long long)b * per_b);
  const int ft = rem / w.T;
  int q = rem - ft * w.T, r = 0;
  for (int len = (w.T + w.dt - 1) / w.dt; q >= len; len = (w.T - r + w.dt - 1) / w.dt) {
    q -= len;
    ++r;
  }
  return {b, ft * kColF<T>, r + q * w.dt, q, pair};
}

template <typename T>
__host__ __device__ constexpr size_t col_tile_bytes() {
  return align16(size_t(kColF<T>) * Ld<T>::value * sizeof(T));
}

// One tile: kColF positions [f0, f0 + kColF) of a row, 64 channels from
// `row` (positions `stride` elements apart), zero past F and (WIDE) from
// channel `lim` on.
template <typename T, bool WIDE>
__device__ __forceinline__ void load_col_tile(unsigned char* dst, const T* __restrict__ row, int f0,
                                              int F, int stride, int lim, int tid) {
  constexpr int LD = Ld<T>::value;
  constexpr int kVec = 16 / int(sizeof(T));
  constexpr int kPerRow = kC / kVec;
  for (int e = tid; e < kColF<T> * kPerRow; e += kThreads) {
    const int p = e / kPerRow, c = (e % kPerRow) * kVec;
    const bool inside = f0 + p < F && (!WIDE || c < lim);
    cp_async16(reinterpret_cast<T*>(dst) + size_t(p) * LD + c,
               inside ? row + size_t(f0 + p) * stride + c : row, inside ? 16 : 0);
  }
}

// grid (blocks); partials [blocks][kMaxTaps][64][64] (WIDE: [blocks + pairs],
// row g + p of block g for pair p).  Input tiles get
// sequence numbers in load order and live in ring slot seq % kYRing; item k
// reads tap i from tile base_k + i, where base_k = base_{k-1} + 1 when item
// k continues item k - 1's residue (one new tile: its last tap's row) and
// the next unused number otherwise (kt new tiles).
template <typename T, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgrad_kf1_kernel(const T* __restrict__ y, const T* __restrict__ d, float* __restrict__ partials,
                      const ColumnWork w) {
  constexpr int LD = Ld<T>::value;
  constexpr bool kTensorCore = sizeof(T) == 2;
  static_assert(!(WIDE && kTensorCore), "bf16 at other widths is conv_wgrad_wide.cu's");
  constexpr size_t kTile = col_tile_bytes<T>();
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x;
  const long long it0 = (long long)g * w.items / w.blocks;
  const int n = int((long long)(g + 1) * w.items / w.blocks - it0);
  const int centre = (w.kt - 1) / 2;
  const int cin = WIDE ? w.cin : kC, cout = WIDE ? w.cout : kC;

  // [kYRing] y tiles, [kStages] d tiles, one tile of zeros for the taps
  // whose row is outside [0, T) (a branch per tap would keep the compiler
  // from hoisting the operand loads above the products)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const d_ring = smem_raw + kYRing * kTile;
  T* const zeros = reinterpret_cast<T*>(d_ring + kStages * kTile);
  for (int e = tid; e < int(kTile / 16); e += kThreads) {
    reinterpret_cast<uint4*>(zeros)[e] = make_uint4(0, 0, 0, 0);
  }  // visible after the first barrier of the loop, before any product

  float acc[kMaxTaps][4][4];
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k][0] = acc[i][k][1] = acc[i][k][2] = acc[i][k][3] = 0.0f;
  }
  const int wm = warp & 3, wn = warp >> 2;

  int issued = 0;  // producer: next tile sequence number
  auto issue = [&](int k) {
    const ColItem it = decode_col<T, WIDE>(w, it0 + k);
    const int cs = WIDE ? it.p / w.n_og : 0, og = WIDE ? it.p - cs * w.n_og : 0;
    const bool cont = k > 0 && it.q > 0;
    const int base = cont ? issued - w.kt + 1 : issued;
    for (int i = cont ? w.kt - 1 : 0; i < w.kt; ++i) {
      const int row = it.t + (i - centre) * w.dt;
      if (row >= 0 && row < w.T) {  // a row outside is never read: its taps are skipped
        load_col_tile<T, WIDE>(smem_raw + ((base + i) % kYRing) * kTile,
                               y + (size_t(it.b) * w.T + row) * w.F * cin + cs * kC, it.f0, w.F,
                               cin, cin - cs * kC, tid);
      }
    }
    load_col_tile<T, WIDE>(d_ring + (k % kStages) * kTile,
                           d + (size_t(it.b) * w.T + it.t) * w.F * cout + og * kC, it.f0, w.F,
                           cout, cout - og * kC, tid);
    issued = base + w.kt;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();
  }
  int consumed = 0;  // consumer: the same sequence, one item behind the barrier
  int pair = -1;     // WIDE: the pair whose partials the registers hold
  for (int k = 0; k < n; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (k + kStages - 1 < n) issue(k + kStages - 1);
    cp_async_commit();

    const ColItem it = decode_col<T, WIDE>(w, it0 + k);
    if constexpr (WIDE) {
      if (it.p != pair) {
        if (pair >= 0) {
          flush_partials<T, kMaxTaps>(acc, partials + (size_t(g) + pair) * kMaxTaps * kC * kC, tid);
        }
        pair = it.p;
      }
    }
    const int base = (k > 0 && it.q > 0) ? consumed - w.kt + 1 : consumed;
    consumed = base + w.kt;
    const T* ys[kMaxTaps];
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      const int row = it.t + (i - centre) * w.dt;
      ys[i] = (i < w.kt && row >= 0 && row < w.T)
                  ? reinterpret_cast<const T*>(smem_raw + ((base + i) % kYRing) * kTile)
                  : zeros;
    }
    const T* d_s = reinterpret_cast<const T*>(d_ring + (k % kStages) * kTile);
    const int n_ks = min(kColF<T>, w.F - it.f0 + 15) / 16;
    if constexpr (kTensorCore) {
      const int krow = (lane & 7) + ((lane >> 4) & 1) * 8;
      const int mcol = wm * 16 + ((lane >> 3) & 1) * 8;
      for (int ks = 0; ks < n_ks; ++ks) {
        uint32_t bf[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          ldmatrix_x4_trans(bf[np], d_s + size_t(ks * 16 + (lane & 15)) * LD + wn * 32 + np * 16 +
                                        (lane >> 4) * 8);
        }
#pragma unroll
        for (int i = 0; i < kMaxTaps; ++i) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, ys[i] + size_t(ks * 16 + krow) * LD + mcol);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_bf16(acc[i][nt], a, bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]);
          }
        }
      }
    } else {
      const int c = tid >> 2, n0 = (tid & 3) * 16;
      for (int p = 0; p < n_ks * 16; ++p) {
        float dv[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) dv[m] = to_float(d_s[size_t(p) * LD + n0 + m]);
#pragma unroll
        for (int i = 0; i < kMaxTaps; ++i) {
          const float yv = to_float(ys[i][size_t(p) * LD + c]);
#pragma unroll
          for (int m = 0; m < 16; ++m) acc[i][m >> 2][m & 3] = fmaf(yv, dv[m], acc[i][m >> 2][m & 3]);
        }
      }
    }
  }
  flush_partials<T, kMaxTaps>(acc, partials + (size_t(g) + (WIDE ? pair : 0)) * kMaxTaps * kC * kC, tid);
}

// The sums' segments: segment s = p seg_taps + i holds the partial rows of
// channel pair p (C = 64: the one pair) and tap i (the kf = 1 kernel: every
// tap, seg_taps = 1), the rows of the blocks whose runs meet its items, each
// at g + s.
struct SegRows {
  long long first[kMaxTaps + 1];  // segment tap i's items within a pair: [first[i], first[i + 1])
  long long per_pair, items;      // items of one pair, of the launch
  int blocks, seg_taps, kf, cin, cout, n_og, width, stride;
};

// dW [kt][kf][Cin][Cout] from the segments' partial rows (`stride` floats
// apart): segment s (grid y), column (plane jj, c, co) of its rows added in
// a fixed order, in double (0 for a segment without items), into plane
// i kf + jj (the kf = 1 kernel: tap jj), input channel 64 cs + c and output
// channel 64 og + co of its pair p = cs n_og + og, if inside.  grid (width /
// 32, segments), block (32, 4).
__global__ void reduce_taps_kernel(const float* __restrict__ in, const SegRows r,
                                   float* __restrict__ dw) {
  __shared__ double part[4][32];
  const int s = blockIdx.y, col = blockIdx.x * 32 + threadIdx.x;
  const int p = s / r.seg_taps, i = s - p * r.seg_taps;
  long long lo_item = (long long)p * r.per_pair, hi_item = lo_item;
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {  // constant indices: no local copy of the parameter
    if (k == i) {
      lo_item += r.first[k];
      hi_item += r.first[k + 1];
    }
  }
  // block g's run is [g N / G, (g+1) N / G): item m is in block ((m + 1) G - 1) / N
  auto block_of = [&](long long m) { return int(((m + 1) * r.blocks - 1) / r.items); };
  int lo = 0, hi = 0;
  if (hi_item > lo_item) {
    lo = block_of(lo_item) + s;
    hi = block_of(hi_item - 1) + s + 1;
  }
  double a = 0.0;
  if (col < r.width) {
    for (int row = lo + threadIdx.y; row < hi; row += 4) a += double(in[size_t(row) * r.stride + col]);
  }
  part[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && col < r.width) {
    const int jj = col / (kC * kC), c = (col / kC) % kC, co = col % kC;
    const int cs = p / r.n_og, og = p - cs * r.n_og;
    const int ci = cs * kC + c, cj = og * kC + co;
    if (ci < r.cin && cj < r.cout) {
      dw[(size_t(i * r.kf + jj) * r.cin + ci) * r.cout + cj] =
          float((part[0][threadIdx.x] + part[1][threadIdx.x]) + (part[2][threadIdx.x] + part[3][threadIdx.x]));
    }
  }
}

// y = round(act(float(x) * inv[c] + shift[c])), 8 channels a thread (C = 64:
// the table in shared memory; WIDE: any C, a multiple of 8, read through L1).
template <typename T, bool WIDE>
__global__ void __launch_bounds__(kThreads)
wgrad_prologue_kernel(const T* __restrict__ x, const float* __restrict__ scal, T* __restrict__ y,
                      long long n8, int act, int C) {
  if constexpr (WIDE) {
    const int c8s = C / 8;
    for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n8;
         e += (long long)gridDim.x * kThreads) {
      const int c8 = int(e % c8s) * 8;
      float v[8];
      load8(x + e * 8, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = activate(__fadd_rn(__fmul_rn(v[k], __ldg(scal + c8 + k)), __ldg(scal + C + c8 + k)), act);
      }
      store8(y + e * 8, v);
    }
  } else {
    __shared__ float inv_s[kC], shift_s[kC];
    if (threadIdx.x < kC) {
      inv_s[threadIdx.x] = scal[threadIdx.x];
      shift_s[threadIdx.x] = scal[kC + threadIdx.x];
    }
    __syncthreads();
    for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n8;
         e += (long long)gridDim.x * kThreads) {
      const int c8 = int(e & 7) * 8;
      float v[8];
      load8(x + e * 8, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = activate(__fadd_rn(__fmul_rn(v[k], inv_s[c8 + k]), shift_s[c8 + k]), act);
      }
      store8(y + e * 8, v);
    }
  }
}

// ---------------------------------------------------------------------------
// The BatchNorm + activation backward between two convs: the d_raw pass
// ---------------------------------------------------------------------------

// rows of the chain's [8, C] table the pass reads: inv, shift, mean, r,
// mean(dz), mean(dz x^) (ops/conv_fused.py _S_INV ... _S_MDZX)
constexpr int kDrawRows = 6;

// act'(z), every step rounded on its own as the plain version computes it:
// mish' = t + z (1 - t^2) sigmoid(z), t = tanh(softplus(z)), both from one
// exponential (the JAX package's _act_deriv, conv_fused.py:172-195); relu'
// = [z > 0].
__device__ __forceinline__ float activate_deriv(float z, int act) {
  if (act == kRelu) return z > 0.0f ? 1.0f : 0.0f;
  const float u = expf(fminf(z, 20.0f));
  const float up = __fadd_rn(1.0f, u);
  const float w = __fmul_rn(up, up);
  const float t = __fdiv_rn(__fsub_rn(w, 1.0f), __fadd_rn(w, 1.0f));
  const float sig = __fdiv_rn(u, up);
  return __fadd_rn(t, __fmul_rn(__fmul_rn(z, __fsub_rn(1.0f, __fmul_rn(t, t))), sig));
}

// d_raw = inv (dy act'(z) - mean(dz) - x^ mean(dz x^)), z = x inv + shift,
// x^ = (x - mean) r, in fp32 (s: one channel's table rows).
__device__ __forceinline__ float draw_one(float dy, float x, const float (&s)[kDrawRows], int act) {
  const float z = __fadd_rn(__fmul_rn(x, s[0]), s[1]);
  const float dz = __fmul_rn(dy, activate_deriv(z, act));
  const float xhat = __fmul_rn(__fsub_rn(x, s[2]), s[3]);
  return __fmul_rn(s[0], __fsub_rn(__fsub_rn(dz, s[4]), __fmul_rn(xhat, s[5])));
}

// d_raw = round(draw_one(dy, x)), 8 channels a thread, one wave of
// grid-strided blocks, for any C a multiple of 8: the table's six rows in
// dynamic shared memory (6 C floats), and the grid's stride a multiple of
// C / 8 (launch_draw), so each thread keeps its 8 channels for the whole
// walk.  Writes only [0, T) x [0, F): the conv kernels after it read their
// halo as zero, where the draw of a zero dy and x would not be (the TPU
// kernels mask it, _mask3).
template <typename T>
__global__ void __launch_bounds__(kThreads)
draw_prologue_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const float* __restrict__ scal, T* __restrict__ d_raw, long long n8, int act,
                     int C) {
  extern __shared__ float4 tab4[];  // [kDrawRows, C] as float4
  float* tab = reinterpret_cast<float*>(tab4);
  for (int e = threadIdx.x; e < kDrawRows * C; e += kThreads) tab[e] = scal[e];
  __syncthreads();
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int c8 = int(first % (C / 8)) * 8;
  for (long long e = first; e < n8; e += (long long)gridDim.x * kThreads) {
    float g[8], v[8];
    load8(dy + e * 8, g);
    load8(x + e * 8, v);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 row[kDrawRows];
#pragma unroll
      for (int r = 0; r < kDrawRows; ++r) row[r] = tab4[(r * C + c8) / 4 + h];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float s[kDrawRows];
#pragma unroll
        for (int r = 0; r < kDrawRows; ++r) {
          s[r] = k == 0 ? row[r].x : k == 1 ? row[r].y : k == 2 ? row[r].z : row[r].w;
        }
        g[4 * h + k] = draw_one(g[4 * h + k], v[4 * h + k], s, act);
      }
    }
    store8(d_raw + e * 8, g);
  }
}

struct WgradPlan {
  WgradWork work;   // kf 3, 5
  ColumnWork cols;  // kf 1
  SegRows segs;     // the reduction into dW
  bool wide;        // other channels than 64 in and out (fp32 here, bf16 conv_wgrad_wide.cu)
  int blocks, groups;
  int resident, registers, local_bytes;
  size_t smem, scratch;  // dynamic shared memory bytes; fp32 scratch elements
};

// Shared memory, residency and registers of `kernel` on the current card.
template <typename K>
cudaError_t occupancy(K kernel, size_t smem, WgradPlan* p) {
  p->smem = smem;
  return occupancy(kernel, smem, &p->resident, &p->registers, &p->local_bytes);
}

// The reduction's description: `seg_taps` segments a pair whose items
// (within the pair) are [first[i], first[i + 1]), rows of `width` floats
// `stride` apart.
void plan_segments(WgradPlan* p, const long long* first, long long per_pair, long long items,
                   int seg_taps, int kf, int cin, int cout, int width, int stride) {
  SegRows& r = p->segs;
  for (int i = 0; i <= kMaxTaps; ++i) r.first[i] = first[i];
  r.per_pair = per_pair;
  r.items = items;
  r.blocks = p->blocks;
  r.seg_taps = seg_taps;
  r.kf = kf;
  r.cin = cin;
  r.cout = cout;
  r.n_og = (cout + kC - 1) / kC;
  r.width = width;
  r.stride = stride;
  p->groups = int(items / per_pair) * seg_taps;
}

template <typename T, int KF, bool WIDE>
cudaError_t plan_taps(int B, int T_, int F, int cin, int cout, int kt, int dt, WgradPlan* p) {
  cudaError_t err =
      occupancy(conv_wgrad_kernel<T, KF, WIDE>, kStages * wgrad_stage_bytes<T, KF>(), p);
  if (err != cudaSuccess) return err;
  p->wide = WIDE;
  WgradWork& w = p->work;
  w.T = T_;
  w.F = F;
  w.dt = dt;
  w.kt = kt;
  w.cin = cin;
  w.cout = cout;
  w.n_og = (cout + kC - 1) / kC;
  const int pairs = (cin + kC - 1) / kC * w.n_og;
  w.pad_t = (kt - 1) * dt / 2;
  w.n_ft = (F + kTileF - 1) / kTileF;
  w.first[0] = 0;
  for (int i = 0; i < kMaxTaps; ++i) {
    const int off = i * dt - w.pad_t;
    const int lo = off < 0 ? -off : 0, hi = off > 0 ? T_ - off : T_;
    w.t_lo[i] = lo;
    w.n_rows[i] = (i < kt && hi > lo) ? hi - lo : 0;
    w.first[i + 1] = w.first[i] + (long long)B * w.n_rows[i] * w.n_ft;
  }
  w.items = w.first[kt] * pairs;
  // the centre tap always has items; no block may be empty (its rows would
  // fall inside a tap's range unwritten)
  p->blocks = w.blocks = int(w.items < p->resident ? w.items : p->resident);
  p->scratch = size_t(w.blocks + pairs * kt) * KF * kC * kC;
  plan_segments(p, w.first, w.first[kt], w.items, kt, KF, cin, cout, KF * kC * kC, KF * kC * kC);
  return cudaSuccess;
}

template <typename T, bool WIDE>
cudaError_t plan_columns(int B, int T_, int F, int cin, int cout, int kt, int dt, WgradPlan* p) {
  cudaError_t err =
      occupancy(conv_wgrad_kf1_kernel<T, WIDE>, (kYRing + kStages + 1) * col_tile_bytes<T>(), p);
  if (err != cudaSuccess) return err;
  p->wide = WIDE;
  ColumnWork& w = p->cols;
  w.T = T_;
  w.F = F;
  w.dt = dt;
  w.kt = kt;
  w.cin = cin;
  w.cout = cout;
  w.n_og = (cout + kC - 1) / kC;
  const int pairs = (cin + kC - 1) / kC * w.n_og;
  w.n_ft = (F + kColF<T> - 1) / kColF<T>;
  w.per_pair = (long long)B * w.n_ft * T_;
  w.items = w.per_pair * pairs;
  p->blocks = w.blocks = int(w.items < p->resident ? w.items : p->resident);
  p->scratch = size_t(w.blocks + (WIDE ? pairs : 0)) * kMaxTaps * kC * kC;
  const long long first[kMaxTaps + 1] = {0, w.per_pair};  // one segment a pair: every tap
  plan_segments(p, first, w.per_pair, w.items, 1, 1, cin, cout, kt * kC * kC, kMaxTaps * kC * kC);
  return cudaSuccess;
}

template <typename T, bool WIDE>
cudaError_t plan_wide(int B, int T_, int F, int cin, int cout, int kt, int kf, int dt, WgradPlan* p) {
  switch (kf) {
    case 1: return plan_columns<T, WIDE>(B, T_, F, cin, cout, kt, dt, p);
    case 3: return plan_taps<T, 3, WIDE>(B, T_, F, cin, cout, kt, dt, p);
    case 5: return plan_taps<T, 5, WIDE>(B, T_, F, cin, cout, kt, dt, p);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t plan(int B, int T_, int F, int cin, int cout, int kt, int kf, int dt, WgradPlan* p) {
  constexpr int kVec = 16 / int(sizeof(T));  // channels a 16-byte copy moves
  if (bad_shape(B, T_, F, kt, kf, dt) || cin <= 0 || cout <= 0 || cin % kVec || cout % kVec) {
    return cudaErrorInvalidValue;
  }
  if (cin == kC && cout == kC) return plan_wide<T, false>(B, T_, F, cin, cout, kt, kf, dt, p);
  if constexpr (sizeof(T) == 2) {
    wide::WgradWideInfo info;
    cudaError_t err = wide::conv_wgrad_wide_plan(B, T_, F, cin, cout, kt, kf, dt, &info);
    if (err != cudaSuccess) return err;
    p->wide = true;
    p->blocks = info.blocks;
    p->resident = info.resident;
    p->registers = info.registers;
    p->local_bytes = info.local_bytes;
    p->smem = info.tile.smem;
    p->scratch = size_t(info.scratch);
    return cudaSuccess;
  } else {
    return plan_wide<T, true>(B, T_, F, cin, cout, kt, kf, dt, p);
  }
}

template <typename T, bool WIDE>
void launch_kf(const WgradPlan& p, int kf, const T* y, const T* d, float* partials,
               cudaStream_t stream) {
  switch (kf) {
    case 1: conv_wgrad_kf1_kernel<T, WIDE><<<p.blocks, kThreads, p.smem, stream>>>(y, d, partials, p.cols); break;
    case 3: conv_wgrad_kernel<T, 3, WIDE><<<p.blocks, kThreads, p.smem, stream>>>(y, d, partials, p.work); break;
    default: conv_wgrad_kernel<T, 5, WIDE><<<p.blocks, kThreads, p.smem, stream>>>(y, d, partials, p.work); break;
  }
}

template <typename T>
cudaError_t launch_wgrad(const void* y, const void* d, void* dw, void* scratch, int B, int T_,
                         int F, int cin, int cout, int kt, int kf, int dt, cudaStream_t stream) {
  if (sizeof(T) == 2 && !(cin == kC && cout == kC)) {
    return wide::conv_wgrad_wide_launch(y, d, dw, static_cast<float*>(scratch), B, T_, F, cin, cout, kt, kf, dt,
                                        stream);
  }
  WgradPlan p;
  cudaError_t err = plan<T>(B, T_, F, cin, cout, kt, kf, dt, &p);
  if (err != cudaSuccess) return err;
  const T* y_ = static_cast<const T*>(y);
  const T* d_ = static_cast<const T*>(d);
  float* partials = static_cast<float*>(scratch);
  if constexpr (sizeof(T) == 2) {
    launch_kf<T, false>(p, kf, y_, d_, partials, stream);  // other widths: conv_wgrad_wide.cu
  } else if (p.wide) {
    launch_kf<T, true>(p, kf, y_, d_, partials, stream);
  } else {
    launch_kf<T, false>(p, kf, y_, d_, partials, stream);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_taps_kernel<<<dim3((p.segs.width + 31) / 32, p.groups), dim3(32, 4), 0, stream>>>(
      partials, p.segs, static_cast<float*>(dw));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_prologue(const void* x, const void* scal, void* y, int B, int T_, int F, int C,
                            int act, cudaStream_t stream) {
  if (act != kMish && act != kRelu) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long n8 = (long long)B * T_ * F * (C / 8);
  // one wave: 8 blocks of 256 threads fill an SM's 2048 thread slots
  const long long want = (n8 + kThreads - 1) / kThreads;
  const int blocks = int(want < 8LL * sms ? want : 8LL * sms);
  const T* x_ = static_cast<const T*>(x);
  const float* s_ = static_cast<const float*>(scal);
  T* y_ = static_cast<T*>(y);
  if (C == kC) {
    wgrad_prologue_kernel<T, false><<<blocks, kThreads, 0, stream>>>(x_, s_, y_, n8, act, C);
  } else {
    wgrad_prologue_kernel<T, true><<<blocks, kThreads, 0, stream>>>(x_, s_, y_, n8, act, C);
  }
  return cudaGetLastError();
}

// One wave of draw_prologue_kernel: the blocks the card holds at once, or
// fewer if the tensor needs fewer, in a multiple of the blocks whose threads
// make a whole number of C / 8 channel groups.
template <typename T>
cudaError_t launch_draw(const void* dy, const void* x, const void* scal, void* d_raw, int B, int T_,
                        int F, int C, int act, cudaStream_t stream) {
  if (act != kMish && act != kRelu) return cudaErrorInvalidValue;
  const size_t smem = size_t(kDrawRows) * C * sizeof(float);  // 4.6 KB at C = 192
  int per_sm = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, draw_prologue_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long n8 = (long long)B * T_ * F * (C / 8);
  const int c8s = C / 8;
  int g = kThreads;  // gcd(kThreads, c8s): the grid's blocks come in steps of c8s / g
  for (int b = c8s; b != 0;) {
    const int t = g % b;
    g = b;
    b = t;
  }
  const int step = c8s / g;
  const long long want = (n8 + kThreads - 1) / kThreads;
  const long long resident = (long long)per_sm * sms;
  long long blocks = want < resident ? want : resident;
  blocks = blocks > step ? blocks - blocks % step : step;
  draw_prologue_kernel<T><<<int(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(scal),
      static_cast<T*>(d_raw), n8, act, C);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function returns its
// cudaError_t; 0 is success.  `bf16` selects bf16 activations, otherwise
// fp32; scal (the chain's [8, C] table: row 0 inv, row 1 shift), dw and
// scratch are fp32.  Activations are y [B, T, F, Cin] and d [B, T, F, Cout],
// dw [kt, kf, Cin, Cout], channel counts a multiple of 8 (bf16) or 4 (fp32).
// `scratch` holds the per-block partial sums (conv_wgrad_launch_config gives
// its size).

// dW of the conv whose (already activated) input is y and output cotangent d.
extern "C" int conv_wgrad(const void* y, const void* d, void* dw, void* scratch, int B, int T,
                          int F, int cin, int cout, int kt, int kf, int dt, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_wgrad<__nv_bfloat16>(y, d, dw, scratch, B, T, F, cin, cout, kt, kf, dt, s)
              : launch_wgrad<float>(y, d, dw, scratch, B, T, F, cin, cout, kt, kf, dt, s);
}

// y = round(act(float(x) * inv[c] + shift[c])), act 1 mish or 2 relu, C a
// multiple of 8; also the input of conv_bn_act_fwd (conv_fwd.cu) on a layer
// with a prologue.
extern "C" int conv_wgrad_prologue(const void* x, const void* scal, void* y, int B, int T, int F,
                                   int C, int act, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || F <= 0 || C <= 0 || C % 8) return cudaErrorInvalidValue;
  return bf16 ? launch_prologue<__nv_bfloat16>(x, scal, y, B, T, F, C, act, s)
              : launch_prologue<float>(x, scal, y, B, T, F, C, act, s);
}

// d_raw = round(inv (dy act'(z) - mean(dz) - x^ mean(dz x^))) with z = x inv
// + shift, x^ = (x - mean) r (scal rows 0-5), the BatchNorm + activation
// backward of the raw conv output x under the cotangent dy; act 1 mish or 2
// relu, C a multiple of 8.  Before conv_dgrad it is the prologue=True branch
// of the TPU's _dgrad_kernel, before conv_wgrad its rhs_prologue branch.
extern "C" int conv_draw_prologue(const void* dy, const void* x, const void* scal, void* d_raw, int B,
                                  int T, int F, int C, int act, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || F <= 0 || C <= 0 || C % 8) return cudaErrorInvalidValue;
  return bf16 ? launch_draw<__nv_bfloat16>(dy, x, scal, d_raw, B, T, F, C, act, s)
              : launch_draw<float>(dy, x, scal, d_raw, B, T, F, C, act, s);
}

// Launch shape of the weight-gradient kernel on the current card: blocks
// (never more than `resident`, the blocks the card holds at once), threads,
// dynamic shared memory, fp32 scratch elements, registers a thread and
// local (spilled) bytes a thread.
extern "C" int conv_wgrad_launch_config(int B, int T, int F, int cin, int cout, int kt, int kf,
                                        int dt, int bf16, int* blocks, int* threads,
                                        long long* smem, long long* scratch, int* resident,
                                        int* registers, int* local_bytes) {
  WgradPlan p;
  cudaError_t err = bf16 ? plan<__nv_bfloat16>(B, T, F, cin, cout, kt, kf, dt, &p)
                         : plan<float>(B, T, F, cin, cout, kt, kf, dt, &p);
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
