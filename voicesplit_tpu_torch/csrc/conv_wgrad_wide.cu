// The weight gradient of conv_wgrad.cu at other widths than 64 channels,
// bf16 (Cin or Cout != 64; fp32 keeps conv_wgrad.cu's pair route on CUDA
// cores, the tests' instantiation): conv_dilated_wgrad and conv_wgrad after
// its prologue pass, replacing the same TPU kernels
// (voicesplit_tpu/ops/conv_pallas.py _wgrad_kernel :234, conv_fused.py
// _wgrad_kernel :524) with the same arithmetic (exact products of the
// operands, fp32 sums), one wave of balanced runs and partial rows added in
// a fixed order, in double: no float atomics, the same bits twice.
//
//   dW[i, j, c, co] = sum_{b,t,f} y[b, t + i*dt - pad_t, f + j - pad_f, c] * d[b, t, f, co]
//
// What bounds it (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s): a (5,5)
// layer at [2, 301, 601, 128] is 296 GFLOP against 185 MB, bound by
// operations (0.30 ms).
//
// Why not conv_wgrad.cu's pair route: it worked each (64-wide
// input slab, 64-wide output group) pair as the C = 64 problem, staging each
// y and d tile once per pair (four times at 128 channels), and multiplied
// with mma.sync.m16n8k16, two ldmatrix a product.  Here:
//
//   Products.  wgmma.m64nNk16: M = 64 input channels of one (slab,
//   frequency tap j) "tile", N = the output group (a built width of
//   conv_wide.cuh, at most 128), K = positions.  Both operands from shared
//   memory: A = y^T, the slab's y tile read MN-major (rows of 64 channels)
//   from the row shift j on (the hardware swizzles by address, as in
//   conv_fwd_wide.cu); B = d, MN-major in 64-column atoms.  An item's
//   products are one commit group.
//
//   Segments.  dW of one time tap is n_slab * kf tiles of 64 x N, and it
//   does not fit a block's registers (5 x 16,384 fp32 at 128 x 128, (5,5)),
//   so the tap's tile list (slab-major, then j) is cut into segments of at
//   most 2 * tw tiles (tw a warpgroup: two at n128, 128 fp32 a thread; three
//   spilled 96 bytes), balanced, and few enough slabs for the ring.  An item
//   is (output group, time tap, segment, row (b, t), 128 positions): it
//   stages the segment's slabs of y (128 + kf - 1 positions with the halo)
//   and the group's N channels of d once, and the two warpgroups compute
//   the segment's tiles from them, the first warpgroup the first half.  So
//   y crosses from L2 once per segment that touches its slab, and d once
//   per segment: at 128 channels (5,5) three segments a tap (3, 3 and 4
//   tiles; two slabs at most), against the pair route's four stagings of d
//   and y each.  Rows whose tap falls outside [0, T) are not items.
//
//   Loads, sums.  A three-stage ring, two items ahead, filled by the Tensor
//   Memory Accelerator (conv_tma.cuh; zeros outside the tensor are the
//   halo), one mbarrier a stage; lane 0 of a warp a box.  Items are walked
//   with a cursor (advance_wgrad): decoding each from its number took a
//   sixth of an item.  After an item's products are issued,
//   the block waits for the previous item's and refills its stage while
//   this item's run.  The block holds its segment's tiles in registers over
//   its run and writes them as its partial row g + segment when the run
//   moves to the next segment and at its end (rows are unique: runs are
//   contiguous and segment-major); reduce_segments_kernel adds each
//   segment's rows in a fixed order, in double, into dW (0 for a tap
//   without rows).
//
//   What holds it back (scripts/port_conv_phases.py; PERF.md): a (5,5)
//   item at 128 channels takes about twice its products' time at peak;
//   issuing them waits on the tensor cores' queue, and the copies' issue
//   and the walk take most of the rest.  Three n128 tiles a warpgroup (two
//   segments a tap) spill.  At kf = 1 an item holds few tiles (one a slab),
//   so its staged bytes serve few products.
//
//   (7,1): the same body with kf = 1, a segment being a run of input slabs
//   of one time tap.  conv_wgrad.cu's kf = 1 kernel holds all kt taps in
//   registers and slides a window of input rows; at N = 128 kt x 64 x N
//   fp32 would take 224 registers a thread, so (7,1) stages each row once
//   per tap here.

#include "conv_tile.cuh"
#include "conv_tma.cuh"
#include "conv_wgmma.cuh"
#include "conv_wide.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTF = 128;  // positions an item

struct WideWgradWork {
  int B, T, F, dt, pad_t, n_ft, blocks, kt, cin, cout;
  int n_tiles, n_seg, seg_tiles;  // tiles of a tap, segments of a tap, tiles of the largest segment
  int stage_bytes;
  int t_lo[kMaxTaps], n_rows[kMaxTaps];  // tap i's rows: t in [t_lo, t_lo + n_rows) per b
  int first[kMaxTaps + 1];               // tap i's items within one output group
  int per_grp, items;                    // (the planner keeps them in int)
};

struct WideWgradItem {
  int og, i, s, b, t, f0;
  int seg;  // (og kt + i) n_seg + s
};

__device__ __forceinline__ WideWgradItem decode_wgrad(const WideWgradWork& w, int item) {
  const int og = item / w.per_grp;
  int rem = item - og * w.per_grp;
  int i = 0;
  while (rem >= w.first[i + 1]) ++i;  // a tap without rows has first[i] == first[i + 1]
  rem -= w.first[i];
  const int cnt = (w.first[i + 1] - w.first[i]) / w.n_seg;  // items of one segment of tap i
  const int s = rem / cnt;
  const int l = rem - s * cnt;
  const int row = l / w.n_ft;
  return {og, i, s, row / w.n_rows[i], w.t_lo[i] + row % w.n_rows[i], (l - row * w.n_ft) * kTF,
          (og * w.kt + i) * w.n_seg + s};
}

// The item after `it` in the numbering (positions, then t, then b, then
// segment, tap with rows, group): a few compares, where decode_wgrad's
// divisions and its walk over the taps cost about a thousand cycles.
__device__ __forceinline__ void advance_wgrad(const WideWgradWork& w, WideWgradItem& it) {
  it.f0 += kTF;
  if (it.f0 < w.n_ft * kTF) return;
  it.f0 = 0;
  if (++it.t < w.t_lo[it.i] + w.n_rows[it.i]) return;
  if (++it.b < w.B) {
    it.t = w.t_lo[it.i];
    return;
  }
  it.b = 0;
  if (++it.s == w.n_seg) {
    it.s = 0;
    do {
      if (++it.i == w.kt) {
        it.i = 0;
        ++it.og;
      }
    } while (w.n_rows[it.i] == 0);
  }
  it.t = w.t_lo[it.i];
  it.seg = (it.og * w.kt + it.i) * w.n_seg + it.s;
}

// Write a warpgroup's tiles [0, count) of the held segment (its local tiles
// first, first + 1, ...) into the partial row `part` ([seg_tiles][64][N])
// and zero all its accumulators.
template <int TW, int N>
__device__ __forceinline__ void flush_tiles(float (&acc)[TW][N / 8][4], float* __restrict__ part, int first,
                                            int count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3, c = 16 * (warp & 3) + gr;
#pragma unroll
  for (int l = 0; l < TW; ++l) {
    if (l < count) {
      float* const o = part + (size_t(first + l) * kC + c) * N + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(acc[l][nt][0], acc[l][nt][1]);
        *reinterpret_cast<float2*>(o + 8 * N + 8 * nt) = make_float2(acc[l][nt][2], acc[l][nt][3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) acc[l][nt][0] = acc[l][nt][1] = acc[l][nt][2] = acc[l][nt][3] = 0.0f;
  }
}

// One item's products of a warpgroup holding C of its TW tiles (A = the
// tiles' y^T at yt[l], B = d at d_s), all kTF / 16 k16 steps (positions
// past F are zeros), in one commit group.  Each count has a branch of its
// own with its products and commit, and no step count depends on the data:
// products or a commit on a path ptxas cannot prove uniform make it
// serialize every wgmma of the kernel (C7520).  A warpgroup without tiles
// (C = 0) commits nothing and waits for all of its products instead.
template <int C, int TW, int N>
__device__ __forceinline__ void wgrad_products(int count, float (&acc)[TW][N / 8][4], const uint32_t (&yt)[TW],
                                               uint32_t d_s) {
  if constexpr (C == 0) {
    wgmma_wait<0>();
  } else if (count == C) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTF / 16; ++ks) {
      const uint64_t bd = b_desc_mn(d_s + ks * 16 * kC * 2, kTF * kC * 2);
#pragma unroll
      for (int l = 0; l < C; ++l) WgmmaSS<N, 1>::run(acc[l], b_desc_mn(yt[l] + ks * 16 * kC * 2, kC * kC * 2), bd);
    }
    wgmma_commit();
  } else {
    wgrad_products<C - 1, TW, N>(count, acc, yt, d_s);
  }
}

// grid (blocks); partials [blocks + segments][seg_tiles][64][N], row g +
// segment of block g
template <int KF, int N>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgrad_wide_kernel(const __grid_constant__ CUtensorMap tm_y, const __grid_constant__ CUtensorMap tm_d,
                       float* __restrict__ partials, const WideWgradWork work) {
  constexpr int TW = wide::wgrad_tiles_per_warpgroup(N);
  constexpr int NSM = (N + 63) / 64 * 64;
  constexpr int kYRows = kTF + KF - 1;
  constexpr int pad_f = (KF - 1) / 2;
  constexpr size_t kDBytes = size_t(NSM) * kTF * 2;
  constexpr int kYSlab = (kYRows * kC * 2 + int(wide::kAlign) - 1) / int(wide::kAlign) * int(wide::kAlign);
                                                      // bytes of a slab of y: 1024-byte aligned
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int g = blockIdx.x;

  __shared__ WideWgradWork w;  // indexed by tap below: shared, not the parameter space
  if (tid == 0) w = work;
  __syncthreads();
  const int it0 = int((long long)g * w.items / w.blocks);
  const int n = int((long long)(g + 1) * w.items / w.blocks - it0);
  const int row_elems = w.seg_tiles * kC * N;  // a partial row

  // [kStages] stages of [d: NSM / 64 atoms][128 positions][64], then
  // [slabs][128 + KF - 1 positions][64] of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + wide::kAlign - 1) & ~uintptr_t(wide::kAlign - 1));
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  // a barrier a stage; item k fills stage k % 3, phase k / 3
  __shared__ __align__(8) uint64_t bars[wide::kStages];
  if (tid == 0) {
    for (int b = 0; b < wide::kStages; ++b) mbar_init(smem_addr(bars + b));
    mbar_init_fence();
  }
  __syncthreads();

  // an item's tiles into a stage: d, 128 positions x the group's N
  // channels in 64-column atoms (lane 0 of warp a, atom a); y, the
  // segment's slabs of 64 channels x 128 + KF - 1 positions from f0 -
  // pad_f (lane 0 of warp 4 + slab), zeros outside; thread 0 arms the barrier
  auto load_item = [&](int stage, const WideWgradItem& it) {
    const int lo = it.s * w.n_tiles / w.n_seg, hi = (it.s + 1) * w.n_tiles / w.n_seg;
    const int cs_lo = lo / KF, slabs = (hi - 1) / KF - cs_lo + 1;
    const uint32_t bar = smem_addr(bars + stage), d_s = ring_s + stage * w.stage_bytes;
    if (tid == 0) mbar_expect(bar, NSM * kTF * 2 + slabs * kYRows * kC * 2);
    if (lane != 0) return;
    if (warp < NSM / 64) {
      tma_load_4d(d_s + warp * (kTF * kC * 2), &tm_d, it.og * N + 64 * warp, it.f0, it.t, it.b, bar);
    } else if (warp >= 4 && warp - 4 < slabs) {
      const int sl = warp - 4;
      tma_load_4d(d_s + uint32_t(kDBytes) + sl * kYSlab, &tm_y, (cs_lo + sl) * kC, it.f0 - pad_f,
                  it.t + it.i * w.dt - w.pad_t, it.b, bar);
    }
  };

  float acc[TW][N / 8][4];
#pragma unroll
  for (int l = 0; l < TW; ++l) {
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) acc[l][nt][0] = acc[l][nt][1] = acc[l][nt][2] = acc[l][nt][3] = 0.0f;
  }
  // item k (computed) and the next item to load, walked with
  // advance_wgrad from the run's first
  WideWgradItem it = decode_wgrad(w, it0), next = it;
  for (int s = 0; s < wide::kStages - 1 && s < n; ++s, advance_wgrad(w, next)) load_item(s, next);
  int held = -1, held_first = 0, held_count = 0;  // the segment whose tiles the registers hold
  for (int k = 0; k < n; ++k, advance_wgrad(w, it)) {
    mbar_wait(smem_addr(bars + k % wide::kStages), (k / wide::kStages) & 1);  // item k has landed

    const int lo = it.s * w.n_tiles / w.n_seg, hi = (it.s + 1) * w.n_tiles / w.n_seg;
    const int h0 = (hi - lo + 1) / 2;  // the first warpgroup's tiles
    const int my_first = wg == 0 ? 0 : h0, my_count = wg == 0 ? h0 : hi - lo - h0;
    if (it.seg != held) {
      wgmma_wait<0>();  // the held segment's products are done
      if (held >= 0) flush_tiles<TW, N>(acc, partials + (size_t(g) + held) * row_elems, held_first, held_count);
      held = it.seg;
      held_first = my_first;
      held_count = my_count;
    }
    // A = y^T of each tile: its slab of y (MN-major: rows of 64 channels),
    // starting at the frequency tap's row shift j, 128 j bytes into the
    // swizzle pattern; B = d, the same for every tile; the item's products
    // in one commit group (wgrad_products)
    const int cs_lo = lo / KF;
    const uint32_t d_s = ring_s + (k % wide::kStages) * w.stage_bytes;
    const uint32_t y_s = d_s + uint32_t(kDBytes);
    uint32_t yt[TW];
#pragma unroll
    for (int l = 0; l < TW; ++l) {
      const int tau = lo + my_first + (l < my_count ? l : 0);
      const int cs = tau / KF;
      yt[l] = y_s + (cs - cs_lo) * kYSlab + (tau - cs * KF) * (kC * 2);
    }
    wgrad_products<TW, TW, N>(my_count, acc, yt, d_s);
    // item k - 1's products are done everywhere: its stage takes item k + 2
    // while item k's run
    wgmma_wait<1>();
    __syncthreads();
    if (k + wide::kStages - 1 < n) {
      load_item((k + wide::kStages - 1) % wide::kStages, next);
      advance_wgrad(w, next);
    }
  }
  wgmma_wait<0>();
  if (held >= 0) flush_tiles<TW, N>(acc, partials + (size_t(g) + held) * row_elems, held_first, held_count);
}

// The segments' description for the reduction (conv_wide.cuh's tile).
struct SegDesc {
  int first[kMaxTaps + 1];
  int per_grp, items;
  int blocks, kt, kf, n_seg, n_tiles, cin, cout, n, width;  // width: floats of a partial row
};

// dW [kt][kf][cin][cout] from the segments' partial rows: segment sg (grid
// y) = (og kt + i) n_seg + s, column (local tile L, c, co) of its rows added
// in a fixed order, in double (0 for a segment without items), into tap
// (i, j) input channel 64 cs + c and output channel og N + co of the
// segment's tile lo + L = cs kf + j, if inside.  grid (width / 32,
// segments), block (32, 4).
__global__ void reduce_segments_kernel(const float* __restrict__ in, const SegDesc r, float* __restrict__ dw) {
  __shared__ double part[4][32];
  const int sg = blockIdx.y, col = blockIdx.x * 32 + threadIdx.x;
  const int og = sg / (r.kt * r.n_seg), rem = sg - og * (r.kt * r.n_seg);
  const int i = rem / r.n_seg, s = rem - i * r.n_seg;
  int lo_tap = 0, hi_tap = 0;
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {  // constant indices: no local copy of the parameter
    if (k == i) {
      lo_tap = r.first[k];
      hi_tap = r.first[k + 1];
    }
  }
  const int cnt = (hi_tap - lo_tap) / r.n_seg;
  const long long lo_item = (long long)og * r.per_grp + lo_tap + (long long)s * cnt, hi_item = lo_item + cnt;
  // block g's run is [g N / G, (g+1) N / G): item m is in block ((m + 1) G - 1) / N
  auto block_of = [&](long long m) { return int(((m + 1) * r.blocks - 1) / r.items); };
  int lo = 0, hi = 0;
  if (hi_item > lo_item) {
    lo = block_of(lo_item) + sg;
    hi = block_of(hi_item - 1) + sg + 1;
  }
  double a = 0.0;
  if (col < r.width) {
    for (int row = lo + threadIdx.y; row < hi; row += 4) a += double(in[size_t(row) * r.width + col]);
  }
  part[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && col < r.width) {
    const int L = col / (kC * r.n), c = (col / r.n) % kC, co = col % r.n;
    const int tau = s * r.n_tiles / r.n_seg + L, tau_hi = (s + 1) * r.n_tiles / r.n_seg;
    const int cs = tau / r.kf, j = tau - cs * r.kf;
    const int ci = cs * kC + c, cj = og * r.n + co;
    if (tau < tau_hi && ci < r.cin && cj < r.cout) {
      dw[(size_t(i * r.kf + j) * r.cin + ci) * r.cout + cj] =
          float((part[0][threadIdx.x] + part[1][threadIdx.x]) + (part[2][threadIdx.x] + part[3][threadIdx.x]));
    }
  }
}

using WgradKernel = void (*)(const CUtensorMap, const CUtensorMap, float*, const WideWgradWork);

template <int KF>
WgradKernel kernel_n(int n) {
  switch (n) {
    case 64: return conv_wgrad_wide_kernel<KF, 64>;
    case 96: return conv_wgrad_wide_kernel<KF, 96>;
    case 128: return conv_wgrad_wide_kernel<KF, 128>;
    default: return nullptr;
  }
}

WgradKernel find_kernel(int kf, int n) {
  switch (kf) {
    case 1: return kernel_n<1>(n);
    case 3: return kernel_n<3>(n);
    case 5: return kernel_n<5>(n);
    default: return nullptr;
  }
}

cudaError_t plan(int B, int T_, int F, int cin, int cout, int kt, int kf, int dt, wide::WgradWideInfo* info,
                 WideWgradWork* w, SegDesc* segs, WgradKernel* kernel) {
  if (bad_shape(B, T_, F, kt, kf, dt) || cin <= 0 || cout <= 0 || cin % 8 || cout % 8) {
    return cudaErrorInvalidValue;
  }
  wide::WgradTile& t = info->tile;
  if (!wide::wgrad_tile(cin, cout, kf, &t)) return cudaErrorInvalidValue;
  *kernel = find_kernel(kf, t.n);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = occupancy(*kernel, t.smem, &info->resident, &info->registers, &info->local_bytes);
  if (err != cudaSuccess) return err;
  w->B = B;
  w->T = T_;
  w->F = F;
  w->dt = dt;
  w->kt = kt;
  w->cin = cin;
  w->cout = cout;
  w->pad_t = (kt - 1) * dt / 2;
  w->n_ft = (F + kTF - 1) / kTF;
  w->n_tiles = (cin + kC - 1) / kC * kf;
  w->n_seg = t.segs;
  w->seg_tiles = t.seg_tiles;
  w->stage_bytes = int(t.stage);
  long long first = 0;
  w->first[0] = 0;
  for (int i = 0; i < kMaxTaps; ++i) {
    const int off = i * dt - w->pad_t;
    const int lo = off < 0 ? -off : 0, hi = off > 0 ? T_ - off : T_;
    w->t_lo[i] = lo;
    w->n_rows[i] = (i < kt && hi > lo) ? hi - lo : 0;
    first += (long long)B * w->n_rows[i] * w->n_ft * t.segs;
    if (first * t.groups >= (1LL << 31)) return cudaErrorInvalidValue;  // the kernel counts items in int
    w->first[i + 1] = int(first);
  }
  w->per_grp = w->first[kt];
  w->items = w->per_grp * t.groups;
  // the centre tap always has rows; no block may be empty (its row would
  // fall inside a segment's range unwritten)
  info->blocks = w->blocks = int(w->items < info->resident ? w->items : info->resident);
  const int n_segments = t.groups * kt * t.segs;
  const int width = t.seg_tiles * kC * t.n;
  info->scratch = (long long)(info->blocks + n_segments) * width;
  for (int i = 0; i <= kMaxTaps; ++i) segs->first[i] = w->first[i];
  segs->per_grp = w->per_grp;
  segs->items = w->items;
  segs->blocks = info->blocks;
  segs->kt = kt;
  segs->kf = kf;
  segs->n_seg = t.segs;
  segs->n_tiles = w->n_tiles;
  segs->cin = cin;
  segs->cout = cout;
  segs->n = t.n;
  segs->width = width;
  return cudaSuccess;
}

}  // namespace

namespace wide {

cudaError_t conv_wgrad_wide_plan(int B, int T, int F, int cin, int cout, int kt, int kf, int dt,
                                 WgradWideInfo* info) {
  WideWgradWork w;
  SegDesc segs;
  WgradKernel kernel;
  return plan(B, T, F, cin, cout, kt, kf, dt, info, &w, &segs, &kernel);
}

cudaError_t conv_wgrad_wide_launch(const void* y, const void* d, void* dw, float* partials, int B, int T,
                                   int F, int cin, int cout, int kt, int kf, int dt, cudaStream_t stream) {
  WgradWideInfo info;
  WideWgradWork w;
  SegDesc segs;
  WgradKernel kernel;
  cudaError_t err = plan(B, T, F, cin, cout, kt, kf, dt, &info, &w, &segs, &kernel);
  if (err != cudaSuccess) return err;
  // y and d as boxes of 64 channels x the item's positions of one row
  CUtensorMap tm_y, tm_d;
  err = activation_map(&tm_y, y, B, T, F, cin, kTF + kf - 1);
  if (err != cudaSuccess) return err;
  err = activation_map(&tm_d, d, B, T, F, cout, kTF);
  if (err != cudaSuccess) return err;
  kernel<<<info.blocks, kThreads, info.tile.smem, stream>>>(tm_y, tm_d, partials, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_segments = info.tile.groups * kt * info.tile.segs;
  reduce_segments_kernel<<<dim3((segs.width + 31) / 32, n_segments), dim3(32, 4), 0, stream>>>(
      partials, segs, static_cast<float*>(dw));
  return cudaGetLastError();
}

}  // namespace wide

// The weight-gradient tile of conv_wgrad_wide.cu for bf16 at (cin, cout, kf)
// on no card (the table alone): n, groups, tiles a warpgroup, segments of a
// tap, tiles of the largest segment, slabs staged, positions an item,
// dynamic shared memory.
extern "C" int conv_wgrad_wide_tile(int cin, int cout, int kf, int* n, int* groups, int* tw, int* segs,
                                    int* seg_tiles, int* slabs, int* tf, long long* smem) {
  wide::WgradTile t;
  if (cin <= 0 || cout <= 0 || cin % 8 || cout % 8 || kf <= 0 || kf % 2 == 0 || kf > kMaxTaps ||
      !wide::wgrad_tile(cin, cout, kf, &t)) {
    return cudaErrorInvalidValue;
  }
  *n = t.n;
  *groups = t.groups;
  *tw = t.tw;
  *segs = t.segs;
  *seg_tiles = t.seg_tiles;
  *slabs = t.slabs;
  *tf = t.tf;
  *smem = static_cast<long long>(t.smem);
  return cudaSuccess;
}

// Registers and local (spilled) bytes a thread of the weight gradient's
// wide instantiation (kf, n), from the built library without a launch.
extern "C" int conv_wgrad_wide_attributes(int kf, int n, int* registers, int* local_bytes) {
  const auto kernel = find_kernel(kf, n);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  return cudaSuccess;
}
