// Forward LSTM recurrences for Hopper (sm_90a): one and two directions.
//
// Replaces the TPU kernels in voicesplit_tpu/ops/lstm_pallas.py:
//   lstm_fwd   <- _fwd_kernel  (:71, launched by _fwd :98):  one direction
//                 from a caller-supplied (h0, c0);
//   bilstm_fwd <- _fwd2_kernel (:251, launched by _fwd2 :284): both
//                 directions in one pass, rows [0,B) forward time with
//                 W_hh_f, rows [B,2B) the time-reversed input with W_hh_b,
//                 zero initial state.
//
// Per step t, for every row r and hidden unit j (gate order [i, f, g, o]):
//   pre   = float(xp[t, r, :]) + round(h[t-1, r, :]) . W_hh[:, gate cols]
//   i,f,o = sigmoid(pre), g = tanh(pre)
//   c     = f * c + i * g,   h = o * tanh(c)
// where round() casts h to the operand type (bf16 or fp32) as the Pallas
// kernel does before its matrix product, and every product accumulates in
// fp32.  Outputs hs, cs [T, R, H] and the activated gates [T, R, 4H] are
// fp32, as on the TPU.
//
// Three routes, chosen from the shape and the card before anything launches
// (lstm_launch_config reports which): the cluster walk wherever one cluster
// holds the shape, else in bf16 the split walk wherever a pair of clusters
// holds it and the card holds all its clusters at once, else the grid route.
//
// lstm_fwd_kernel, the cluster walk, for every shape it holds (bf16:
// H <= 512; rows and shared memory as below).  One thread-block cluster of
// C = 16 blocks (non-portable size) of 384 threads per direction and row
// group; clusters never talk to each other.  Why: the design before it
// (kept below as the grid route) staged all of h[t-1] from L2 into each of
// 100 blocks and crossed a grid.sync() every step: 3.3 us a step.
//   Ownership.  Block k owns the U = ceil(H / C) units J_k (U = 25 at
//   H = 400; blocks past ceil(H / U) own none and skip the walk, and no
//   block counts on bytes from them) and holds, for the whole walk, the
//   columns {g H + j : j in J_k, g = 0..3} of its direction's W_hh for all
//   H rows: exactly the pre-activations it needs, so no block computes
//   another's gates.  The backward walk (lstm_bwd.cu) owns the same columns.
//   Per step t, block k:
//   1. waits on its own mbarrier for all of h[t-1] of its rows (h0 at t = 0,
//      staged before the walk);
//   2. computes its 4U pre-activations of each row and the cell update of
//      its units (c carried in registers; the step's xp loaded into
//      registers during the step before);
//   3. writes hs, cs and the gates of its units (fp32; consecutive threads
//      take consecutive units, so each gate's stores are coalesced);
//   4. sends its [rows][U] slice of h[t], rounded to the operand type and
//      padded with zeros to UP units, to every block that owns units
//      (itself included), as 16-byte st.async stores, each counting its
//      bytes on the receiver's mbarrier; then loads the next step's xp.
//   The h all-gather.  A receive slot holds K = senders x UP operand values
//   a row (zeros where no unit is) and the product runs over K with W_hh's
//   rows laid out the same way.  Two slots, each with its mbarrier: h[t]
//   goes to slot t mod 2 and is read at step t+1.  A sender writes a slot
//   again only two steps later, after it has received the receiver's h of
//   the step between, which the receiver sends after it has finished
//   reading the slot (a __syncthreads lies between) and armed its barrier
//   again for the slot's next phase; so no slot is overwritten while it is
//   read, and no byte counts on a phase that is not its own.  The armed
//   count is rows x senders x UP x the operand's size: every owner receives
//   from every sender.  A wait that never ends traps (a fault, not a hang).
//   Products.  bf16: wgmma.m64n8k16.  The 4U owned columns are two 64-row
//   A tiles; warpgroup g of the three holds k-steps g, g + 3, ..., g + 30 of
//   both as A fragments in registers for the whole walk (loaded once with
//   ldmatrix; 88 registers), so the W_hh a step multiplies never crosses
//   shared memory.  B is 8 rows of h read from the slot by descriptor: a
//   bf16 slot is laid out as 8 x 8 core matrices (K-major, no swizzle), of
//   which each 16-byte piece a sender stores is one row.  Each warpgroup's
//   partial product goes to shared memory (over the staged columns) and the
//   cell update adds the three in order.  fp32: CUDA-core FMAs over the
//   columns in shared memory, eight threads a dot product (each a fixed
//   slice of K, added by shuffles in a fixed order), 1, 2, 4 or 8 rows at a
//   time; no tensor cores, which would round fp32 operands to TF32.
//   Row groups.  A direction's rows go to G clusters of at most the rows a
//   cluster holds (rows x U <= 2 x 384 (row, unit) pairs; shared memory),
//   spread evenly; clusters past the ones the card holds at once (7 on an
//   H100) wait to be scheduled.
//   Shared memory a block at H = 400: bf16 150,032 B up to 8 rows (W_hh's
//   columns [128][520], reused for the partials; slots [2][8 x 512]),
//   183,824 B at 24 rows, up to 30 rows; fp32 186,576 B (1 row) to 215,696
//   B (8 rows; columns [100][456], read every step), up to 8 rows.
//
// lstm_fwd_split_kernel, the split walk (lstm_fwd_split and bilstm_fwd_split
// in chip_smoke.py's kernels line), for bf16 shapes one cluster cannot hold
// (H = 800, configs/voicesplit_wide.json: a block of 16 would own 50 units,
// 200 x 800 columns, 320 KB): two clusters of 16 blocks per direction and
// row group, clusters 2p and 2p + 1 for pair p.
//   Ownership.  U = 32 units a block: ceil(H / 32) owners (25 at H = 800),
//   the first ceil(owners / 2) in the pair's first cluster (13), the rest in
//   its second (12; blocks past them own none and only meet at the cluster
//   barriers).  Owner m holds the 4U = 128 columns {g H + j : j in [32 m,
//   32 m + 32)} of W_hh for all rows, exactly two 64-column wgmma tiles,
//   over K = owners x 32 = 800 (no padding between owners).
//   W_hh.  A k-step of 16 rows of both tiles is 8 KB; K is 50 k-steps.
//   Warpgroup wg multiplies the virtual k-steps v = wg + 3 i, i < 17 (zero
//   past K), v standing for k-step (v + first local k-step) mod 50, so that
//   each cluster's own units come first.  Its first 10 are A fragments in
//   registers (80 registers of 168 at 384 threads, loaded once), the other
//   7 are read by wgmma from shared memory through descriptors: atoms of
//   64 columns x 4 k-steps with the 128-byte swizzle, 2 atoms a tile and
//   warpgroup (96 KB; the canonical
//   layout without a swizzle gave the same bits and, while the wgmma were
//   still serialized, the same time; the two were not timed apart after).
//   The h exchange.  Within a cluster as on the cluster walk: each owner
//   sends its [rows][32] slice of h[t], rounded, as 16-byte st.async stores
//   counted on the receiver's mbarrier, into receive slot t mod 2 (core
//   matrices [rows / 8][K / 8][8][8], wgmma's K-major B).  Across the pair,
//   through L2 (lstm_cluster.cuh): the last warp writes the same slice into
//   the pair's global slot t mod 2 (the same layout), then adds one to its
//   cluster's counter (red.release.gpu); at step t + 1 thread 0 of each
//   block of the other cluster waits for that counter to reach (t + 1) x
//   the cluster's owners (ld.acquire.gpu; a wait that never ends traps),
//   then copies the other cluster's units of each 8-row tile into its own
//   slot with one bulk copy (cp.async.bulk) counted on a second mbarrier of
//   the slot.  The global slots are reused by the same argument as the
//   receive slots: a block writes slot t mod 2 again only after it has
//   received every block's h[t+1], which each block sends after reading
//   h[t].  Counters and slots are zeroed on the stream before the launch.
//   A step.  Wait for this cluster's h[t-1]; issue the first 8 virtual
//   k-steps of each warpgroup (24 k-steps, local in either cluster) as
//   wgmma; wait for the other cluster's h[t-1] (counter, bulk copy); issue
//   the other 9; the warpgroups' partials add in order in the cell update,
//   as on the cluster walk; send h[t].  No C++ branch lies between two
//   wgmma in flight: ptxas fences and serializes every wgmma of a kernel in
//   which one does (C7520), which tripled the product's time.  The waits
//   keep their loops inside asm (lstm_cluster.cuh), k-step offsets are
//   selects, and step 0 passes the remote wait as a completed phase.
//   Co-residency.  The clusters of a pair wait on each other, so the launch
//   needs every cluster resident at once: the route is taken only where
//   cudaOccupancyMaxActiveClusters covers all 2 x directions x row groups
//   clusters (7 on an H100: B = 1, 2 and two directions at B = 8 need 2, 2
//   and 4), and the launch is cooperative (cudaLaunchAttributeCooperative
//   beside the cluster dimension), so the runtime refuses rather than
//   starts part of it.  Rows: at most 16 a pair (two 8-row tiles).
//   Shared memory at H = 800, bf16: 137,760 B up to 8 rows (W_hh atoms 96
//   KB + 1 KB for their alignment, slots 25.6 KB, partials 12 KB), 176,160 B
//   at 9-16 rows, whose two row tiles multiply one after the other (the
//   second without a wait); 168 registers, no spill up to 8 rows (280 bytes
//   a thread at 9-16, a shape no path takes).  H <= 736 would leave fewer
//   than 24 local k-steps in a cluster and H > 800 more than 51 k-steps:
//   there, the grid route.
//
// lstm_fwd_grid_kernel, the grid route (lstm_fwd_grid and bilstm_fwd_grid in
// chip_smoke.py's kernels line), for the shapes neither walk holds (fp32 at
// H = 800, whose W_hh is 10.24 MB a direction, and at H = 768, the GE2E
// speaker encoder's 16 to 96 rows; a split walk whose clusters are not all
// resident at once, such as two directions of 24 rows): a persistent
// cooperative grid.  Block b owns U = ceil(H / #SMs) units (6 at H = 768 on
// 132 SMs, 128 blocks; 7 at H = 800, 115), all co-resident (checked before
// the launch), and keeps their 4U gate columns of each W_hh in shared
// memory, k contiguous.  A step: h[t-1] streams from L2 through the block in
// chunks by cp.async, the next chunk in flight while the current one
// multiplies; each thread accumulates a register tile of pre-activations
// over its warp's quads of k (lstm_grid.cuh): up to 12 rows x 8 units of one
// gate (96 rows a pass, chunks of 64 k, 16 FMAs a 128-bit shared load), or,
// for one or two rows, one column a lane over chunks of 832 k, so that W is
// read once a step and a step waits on one chunk; the eight warps' partials
// add in warp order in the cell update; one grid-wide barrier
// (cooperative_groups::this_grid().sync()) ends the step.  Why: the port's
// first grid kernel gave each dot product to 8 lanes with one accumulator a
// lane, two shared loads an FMA, W's rows H floats apart in the same banks
// and h staged by plain loads between barriers: at [80, 96], H = 768, 72% of
// a step in the product and 25% in the staging, 16.8 ms in all against
// cuDNN's 3.75.  Shared memory at the GE2E step's 96 rows: 150,144 B (the
// partials reuse the chunks' bytes); two directions in fp32 at H = 800, 8
// rows a pass: 229,952 B.  Where a shape's tile does not fit, a smaller one
// does wherever the first grid kernel did; a shape neither route holds is
// refused before the launch.
//
// Sum order, fixed, so the same inputs give the same bits: wgmma's own
// order within a warpgroup (on the split walk its virtual k-steps in
// order), then the three partials in order (bf16); each lane's slice of K
// in order, then a fixed shuffle tree (fp32); on the grid route each warp's
// quads of k in order, then the warps' partials in warp order.  No float
// atomics; the split walk's counters only count.
//
// What bounds them on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense),
// counting each input byte read once and each output byte written once:
//   lstm_fwd,  B = 1, T = 301, H = 400, bf16: ~5.1 MB and 0.39 GFLOP
//              -> memory-bound, ~1.5 us; launched twice per B=1 serve call
//              and per B=2 train step.
//   bilstm_fwd, B = 8 (16 rows), bf16: ~64 MB and 6.2 GFLOP
//              -> memory-bound, ~19 us; launched once per B=8 call or step.
// The real limit of the walk is neither: it is the T = 301 dependent steps,
// each a wait for h, a product of 8 rows (a wgmma of N = 8 costs about its
// fixed minimum whatever its FLOPs), the cell update and one all-gather
// through distributed shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "conv_tile.cuh"     // kThreads, to_float, align16, ldmatrix, mma.sync
#include "lstm_cluster.cuh"  // kCluster, the cluster primitives, owned columns, row groups
#include "lstm_grid.cuh"     // the grid route's product

namespace cg = cooperative_groups;

namespace {

// sigmoid(x) = (1 + tanh(x / 2)) / 2: one tanh, no division
__device__ __forceinline__ float sigmoid(float x) { return fmaf(0.5f, tanhf(0.5f * x), 0.5f); }

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// ---------------------------------------------------------------------------
// The cluster walk
// ---------------------------------------------------------------------------

constexpr int kWalkThreads = 384;  // threads of a walk block
constexpr int kWarps = kWalkThreads / 32;
constexpr int kPairs = 2;          // (row, unit) pairs of a thread at most
constexpr int kLanes = 8;          // CUDA-core product: threads of one dot product
// bf16: the W_hh columns stay in registers as wgmma A fragments, warpgroup g
// holding k-steps g, g + 3, ..., g + 30 of both 64-column tiles of owned
// columns: 4U <= 128 (H <= 512) and K <= 3 x 11 x 16 = 528
constexpr int kWarpGroups = kWarps / 4;
constexpr int kMTiles = 2;
constexpr int kKSteps = 11;

// Where h[r][k] (row r of the cluster, k = m UP + u for unit u of block m)
// lies in a receive slot, in elements.  bf16: 8 x 8 core matrices
// [r / 8][k / 8][r % 8][k % 8] (wgmma's K-major B without swizzle; a 16-byte
// piece of a block's units is a row of one); fp32: rows [r][k] of ld.
template <typename T>
__device__ __forceinline__ int slot_at(int r, int k, int KP, int ld) {
  if constexpr (sizeof(T) == 2) {
    return ((r >> 3) * (KP >> 3) + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
  } else {
    return r * ld + k;
  }
}

// Launch shape of the walk for `rows` rows a cluster (T elements unless
// said): W_hh's owned columns w_s [q_padded][ldw] (column q = g U + u, row
// k = m UP + u' for unit m U + u', zero elsewhere); receive slots
// [2][rows_padded][ldh]; this step's h to send [rows_padded][UP]; two
// mbarriers.  K = senders x UP is padded to kp.
//   bf16: w_s staged once for the register-held fragments (q_padded = 128,
//         ldw = kp + 8: ldmatrix meets no bank conflict); then the same
//         bytes hold each warpgroup's partial product [3][rows_padded][4U]
//         (fp32); rows padded to whole n8 tiles; slots of core matrices
//         (slot_at), ldh = kp.
//   fp32: w_s read every step and the product [rows_padded][4U] (fp32);
//         ldw = ldh = kp + 8: the eight lanes of a dot product and the four
//         dot products of a warp meet no bank conflict; rows padded to the
//         rows of a dot product (1, 2, 4 or 8).
struct FwdShape {
  int units, unit_pad, kp, ldw, ldh, rows_chunk, rows_padded, q_padded;
  size_t smem;
};

template <typename T>
FwdShape fwd_shape(int rows, int H) {
  constexpr bool kTensorCore = sizeof(T) == 2;
  FwdShape s;
  s.units = (H + kCluster - 1) / kCluster;
  const int per16 = 16 / int(sizeof(T));  // operand values in 16 bytes
  s.unit_pad = (s.units + per16 - 1) / per16 * per16;
  const int senders = (H + s.units - 1) / s.units;
  const int step = kTensorCore ? 16 : 8;
  s.kp = (senders * s.unit_pad + step - 1) / step * step;
  s.ldw = s.kp + 8;
  s.ldh = kTensorCore ? s.kp : s.kp + 8;
  s.rows_chunk = kTensorCore || rows >= 8 ? 8 : rows >= 4 ? 4 : rows >= 2 ? 2 : 1;
  s.rows_padded = (rows + s.rows_chunk - 1) / s.rows_chunk * s.rows_chunk;
  size_t w_bytes, pre_bytes;
  if (kTensorCore) {
    s.q_padded = 64 * kMTiles;
    w_bytes = std::max(size_t(s.q_padded) * s.ldw * sizeof(T),
                       size_t(kWarpGroups) * s.rows_padded * 4 * s.units * sizeof(float));
    pre_bytes = 0;
  } else {
    s.q_padded = 4 * s.units;
    w_bytes = size_t(s.q_padded) * s.ldw * sizeof(T);
    pre_bytes = size_t(s.rows_padded) * 4 * s.units * sizeof(float);
  }
  s.smem = align16(w_bytes) + align16(size_t(2) * s.rows_padded * s.ldh * sizeof(T)) +
           align16(size_t(s.rows_padded) * s.unit_pad * sizeof(T)) + align16(pre_bytes) + 16;
  return s;
}

// Whether the walk's registers cover `rows` rows a cluster (shared memory
// aside).
template <typename T>
bool fwd_walk_fits(const FwdShape& s, int rows) {
  if (rows * s.units > kPairs * kWalkThreads) return false;
  return sizeof(T) != 2 || (4 * s.units <= 64 * kMTiles && s.kp <= 16 * kKSteps * kWarpGroups);
}

// Grid D * G * kCluster blocks in clusters of kCluster; cluster c walks row
// group c % G of direction c / G: the direction's rows [g BC, g BC + Br),
// Br = min(BC, B - g BC).  RC rows of the product at a time.
template <typename T, int RC>
__global__ void __launch_bounds__(kWalkThreads, 1)
lstm_fwd_kernel(const T* __restrict__ xp,      // [T, R, 4H]
                const T* __restrict__ w0,      // [H, 4H], rows [0, B)
                const T* __restrict__ w1,      // [H, 4H], rows [B, 2B) (D == 2)
                const float* __restrict__ h0,  // [R, H] or null (zero state)
                const float* __restrict__ c0,  // [R, H] or null (zero state)
                float* __restrict__ hs,        // [T, R, H]
                float* __restrict__ cs,        // [T, R, H]
                float* __restrict__ gates,     // [T, R, 4H]
                int T_, int B, int H, int G, int BC, int U, int UP, int KP, int LDW, int LDH,
                int RP) {
  constexpr bool kTensorCore = sizeof(T) == 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = int(cluster.block_rank());
  const int c_id = int(blockIdx.x) / kCluster;
  const int d = c_id / G;
  const int row0 = d * B + (c_id % G) * BC;     // the cluster's first row in the arrays
  const int Br = min(BC, B - (c_id % G) * BC);  // and its rows
  const int R = int(gridDim.x) / (kCluster * G) * B;  // rows of the arrays, all directions
  const int G4 = 4 * H;
  const int NQ = 4 * U;  // columns a block owns (zero past its units)
  const int u0 = k * U;
  const int Uk = max(0, min(U, H - u0));  // units this block owns
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, and warp in it
  const T* __restrict__ W = d ? w1 : w0;
  constexpr int kPer16 = 16 / int(sizeof(T));  // operand values in a 16-byte piece
  // Blocks [0, senders) own units and receive all of h from each other
  // every step; the others skip the walk.
  const int senders = (H + U - 1) / U;
  const uint32_t step_bytes = uint32_t(senders * Br * UP) * sizeof(T);
  const int slot = RP * LDH;  // elements of one receive slot

  const int QP = kTensorCore ? 64 * kMTiles : NQ;  // rows of w_s
  const int KS = KP / 16;                           // bf16: k-steps of the product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // W_hh's columns w_s [QP][LDW]; bf16: then the warpgroups' partial
  // products part [kWarpGroups][RP][NQ] (fp32) in the same bytes
  T* w_s = reinterpret_cast<T*>(smem_raw);
  float* part = reinterpret_cast<float*>(smem_raw);
  const size_t w_cols = size_t(QP) * LDW * sizeof(T);
  const size_t w_part = kTensorCore ? size_t(kWarpGroups) * RP * NQ * sizeof(float) : 0;
  const size_t w_bytes = w_cols > w_part ? w_cols : w_part;
  T* recv = reinterpret_cast<T*>(smem_raw + align16(w_bytes));
  T* stage = recv + 2 * slot;  // [RP][UP]
  // fp32: the product [RP][NQ]
  float* pre = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(stage) +
                                        align16(size_t(RP) * UP * sizeof(T)));
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(pre) + (kTensorCore ? 0 : align16(size_t(RP) * NQ * sizeof(float))));
  // zeros: what no one sends (padding units, rows past Br, K past
  // senders x UP) must multiply as 0
  for (int e = tid; e < 2 * slot + RP * UP; e += nt) recv[e] = from_float<T>(0.0f);
  __syncthreads();
  // W_hh[unit of k, column q] at [q][k]
  stage_owned_columns(w_s, QP, LDW, W, H, U, u0, Uk, [U, UP](int a, int b, int& j, int& q) {
    q = a;
    j = b % UP < U ? b / UP * U + b % UP : -1;
  });
  // slot 1 holds h[-1] = round(h0) for step 0
  if (h0 != nullptr && Uk > 0) {
    for (int e = tid; e < Br * H; e += nt) {
      const int r = e / H, j = e % H;
      recv[slot + slot_at<T>(r, j / U * UP + j % U, KP, LDH)] = from_float<T>(h0[size_t(row0 + r) * H + j]);
    }
  }
  if (tid == 0) {
    bar_init(bars);
    bar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // slot t & 1 receives h[t] for t <= T-2: arm the first two
    if (Uk > 0 && T_ >= 2) bar_expect(bars, step_bytes);
    if (Uk > 0 && T_ >= 3) bar_expect(bars + 1, step_bytes);
  }

  // this thread's (row, unit) pairs e = tid + p nt, r << 16 | u (-1: none),
  // their cell state and the step's four xp values (kept in the operand
  // type until the cell update, so that nothing waits for the loads before)
  int ru[kPairs];
  float c[kPairs];
  T xv[kPairs][4];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int e = tid + p * nt, r = e / U, u = e % U;
    ru[p] = e < Br * U && u < Uk ? r << 16 | u : -1;
    c[p] = (ru[p] >= 0 && c0 != nullptr) ? c0[size_t(row0 + r) * H + u0 + u] : 0.0f;
  }
  auto prefetch = [&](int t) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (ru[p] < 0) continue;
      const T* x = xp + (size_t(t) * R + row0 + (ru[p] >> 16)) * G4 + u0 + (ru[p] & 0xffff);
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[p][g] = x[g * H];
    }
  };
  prefetch(0);
  // bf16: warpgroup g's k-steps g + 3 i of both 64-column tiles as A
  // fragments, this warp's 16 columns of each (ldmatrix from w_s, once;
  // zeros past K), multiplied every step without a branch
  uint32_t wa[kMTiles][kKSteps][4];
  if constexpr (kTensorCore) {
    __syncthreads();  // w_s staged
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int i = 0; i < kKSteps; ++i) {
        const int ks = wg + i * kWarpGroups;
        wa[mt][i][0] = wa[mt][i][1] = wa[mt][i][2] = wa[mt][i][3] = 0u;
        if (ks < KS) {
          ldmatrix_x4(wa[mt][i], w_s + (mt * 64 + wq * 16 + (lane & 15)) * LDW + ks * 16 + (lane >> 4) * 8);
        }
      }
    }
  }
  cluster.sync();  // every block runs, with its barriers armed, its slots set up and W_hh read

  const int group = tid / kLanes, gl = tid % kLanes, groups = nt / kLanes;
  const int items = NQ * (RP / RC);  // (column, row chunk) dot products
  uint32_t parity = 0;  // bit x: parity of slot x's phase to wait for
  for (int t = 0; Uk > 0 && t < T_; ++t) {
    const int in_slot = (t + 1) & 1;  // h[t-1]
    if (t > 0) {
      bar_wait(bars + in_slot, (parity >> in_slot) & 1);
      parity ^= 1u << in_slot;
      // the slot's next phase receives h[t+1]
      if (tid == 0 && t + 1 <= T_ - 2) bar_expect(bars + in_slot, step_bytes);
    }
    const T* hin = recv + in_slot * slot;
    if constexpr (kTensorCore) {
      // 2: part[g][r][q] = sum over warpgroup g's k-steps of round(h[r][k])
      // W[k][q]: wgmma.m64n8k16, A = the W_hh fragments, B = 8 rows of h
      // from the slot's core matrices (a k-step past K multiplies k-step 0
      // by zero fragments)
      fence_proxy_async();  // h came by st.async; wgmma reads it through the async proxy
      float* pw = part + wg * RP * NQ;
      for (int r0 = 0; r0 < RP; r0 += 8) {
        float acc[kMTiles][4] = {};  // written only by wgmma after this
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < kKSteps; ++i) {
          const int ks = wg + i * kWarpGroups;
          const uint64_t desc = b_desc(hin + slot_at<T>(r0, (ks < KS ? ks : 0) * 16, KP, LDH));
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) wgmma_m64n8k16(acc[mt], wa[mt][i], desc, i > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        // acc[mt][e]: column mt 64 + wq 16 + gr + (e >> 1) 8, row r0 + 2 tig + (e & 1)
        const int r = r0 + 2 * tig;
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = mt * 64 + wq * 16 + gr + h * 8;
            if (q >= NQ) continue;
            if (r < Br) pw[r * NQ + q] = acc[mt][2 * h];
            if (r + 1 < Br) pw[(r + 1) * NQ + q] = acc[mt][2 * h + 1];
          }
        }
      }
    } else {
      // 2: pre[r][q] = sum_k round(h[r][k]) W[k][q], same trip count in
      // every thread (the shuffles need the whole warp)
      for (int ib = 0; ib < items; ib += groups) {
        const int it = ib + group;
        const bool active = it < items;
        const int q = it % NQ, r0 = it / NQ * RC;
        float acc[RC];
#pragma unroll
        for (int i = 0; i < RC; ++i) acc[i] = 0.0f;
        if (active) {
          const T* w = w_s + q * LDW;
          for (int kk = gl; kk < KP; kk += kLanes) {
            const float wv = to_float(w[kk]);
#pragma unroll
            for (int i = 0; i < RC; ++i) acc[i] = fmaf(to_float(hin[(r0 + i) * LDH + kk]), wv, acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 4);
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
        }
        if (active && gl == 0) {
#pragma unroll
          for (int i = 0; i < RC; ++i) {
            if (r0 + i < Br) pre[(r0 + i) * NQ + q] = acc[i];
          }
        }
      }
    }
    __syncthreads();  // the product complete
    // 2, 3: the cell update of the pairs; h rounded into the send stage
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (ru[p] < 0) continue;
      const int r = ru[p] >> 16, u = ru[p] & 0xffff, j = u0 + u;
      float pg[4];  // the four gates' products
      if constexpr (kTensorCore) {
        // the warpgroups' partials, loaded together, then added in order
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float v[kWarpGroups];
#pragma unroll
          for (int w = 0; w < kWarpGroups; ++w) v[w] = part[(w * RP + r) * NQ + g * U + u];
          pg[g] = v[0];
#pragma unroll
          for (int w = 1; w < kWarpGroups; ++w) pg[g] += v[w];
        }
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g) pg[g] = pre[r * NQ + g * U + u];
      }
      const float i = sigmoid(to_float(xv[p][0]) + pg[0]);
      const float f = sigmoid(to_float(xv[p][1]) + pg[1]);
      const float g = tanhf(to_float(xv[p][2]) + pg[2]);
      const float o = sigmoid(to_float(xv[p][3]) + pg[3]);
      c[p] = f * c[p] + i * g;
      const float h = o * tanhf(c[p]);
      const size_t row = size_t(t) * R + row0 + r;
      hs[row * H + j] = h;
      cs[row * H + j] = c[p];
      float* gt = gates + row * G4 + j;
      gt[0] = i;
      gt[H] = f;
      gt[2 * H] = g;
      gt[3 * H] = o;
      stage[r * UP + u] = from_float<T>(h);
    }
    __syncthreads();  // the stage is complete; every read of the product and of slot in_slot is done
    // 4: h[t] to every owner's slot t & 1 (the last step's h is not needed)
    if (t < T_ - 1) {
      const int pieces = Br * (UP / kPer16);  // 16-byte pieces to each owner
      const uint32_t bar_off = uint32_t(t & 1) * 8;
      for (int e = tid; e < senders * pieces; e += nt) {
        const int m = e / pieces, pc = e % pieces;
        const int r = pc / (UP / kPer16), col = pc % (UP / kPer16) * kPer16;
        const float4 v = *reinterpret_cast<const float4*>(stage + r * UP + col);
        T* dst = recv + (t & 1) * slot + slot_at<T>(r, k * UP + col, KP, LDH);
        send4(cluster_addr(dst, m), v, cluster_addr(bars, m) + bar_off);
      }
    }
    if (t + 1 < T_) prefetch(t + 1);  // loads while h travels
  }
  cluster.sync();  // no block leaves while a peer may still write to it
}

// ---------------------------------------------------------------------------
// The split walk
// ---------------------------------------------------------------------------

// k-steps of each 64-column tile that a warpgroup holds in registers; one
// more spills (120 bytes a thread at 11, and the walk ran 17% slower)
constexpr int kSplitRegKSteps = 10;
// k-steps a warpgroup multiplies, registers and shared memory together: a
// compile-time count, so that no wgmma sits on a branch (ptxas serializes
// wgmma issued on a path it cannot prove uniform); K is padded with zero
// k-steps up to 3 x this: H <= 800 (50 k-steps)
constexpr int kSplitKStepsWG = 17;
// k-steps a warpgroup multiplies before it waits for the other cluster's h:
// its first 8, virtual k-steps 0 .. 23, which are this cluster's own units
// in either cluster of a pair of at least 24 owners (H > 736)
constexpr int kSplitLocalWG = 8;
constexpr int kSplitMinOwners = 2 * kSplitLocalWG * kWarpGroups / (kSplitUnits / 16);

// Launch shape of the split walk for `rows` rows a pair (bf16): `owners`
// blocks of kSplitUnits units (`first` of them in the pair's first cluster,
// the rest in its second), K = owners x 32 (`kp`, no padding between
// blocks' units) in `ksteps` k-steps of 16, of which 3 x reg_wg in registers
// and the rest in shared memory (each warpgroup kSplitKStepsWG in all, zero
// past K); rows padded to whole 8-row tiles.
// Shared memory: W_hh's columns of the shared-memory k-steps a_s
// [3 warpgroups][2 tiles][atoms of 4 k-steps] (sw128_at; 1024-byte aligned,
// so 1024 bytes more are asked for), receive slots
// [2][rows_padded x kp] (core matrices, as the cluster walk's), the
// warpgroups' partial products [3][rows_padded][128] (fp32), this step's h
// to send [rows_padded][32] and four mbarriers.  Global exchange memory:
// two counters and two slots [2][rows_padded x kp] a pair.
struct SplitShape {
  int owners, first, kp, ksteps, reg_wg, rows_padded;
  size_t smem, pair_elems;
};

SplitShape split_shape(int rows, int H) {
  SplitShape s;
  s.owners = (H + kSplitUnits - 1) / kSplitUnits;
  s.first = (s.owners + 1) / 2;
  s.kp = s.owners * kSplitUnits;
  s.ksteps = s.kp / 16;
  s.rows_padded = (rows + 7) / 8 * 8;
  s.reg_wg = kSplitRegKSteps;
  s.pair_elems = size_t(2) * s.rows_padded * s.kp;
  const int atoms = (kSplitKStepsWG - s.reg_wg + 3) / 4;  // a warpgroup's, each tile
  s.smem = 1024 + size_t(kWarpGroups) * kMTiles * atoms * kAtomBytes + s.pair_elems * 2 +
           size_t(kWarpGroups) * s.rows_padded * 4 * kSplitUnits * 4 + size_t(s.rows_padded) * kSplitUnits * 2 +
           4 * 8;
  return s;
}

// Grid 2 D G kCluster blocks in clusters of kCluster; clusters 2p and 2p + 1
// walk pair p: row group p % G of direction p / G, the direction's rows
// [g BC, g BC + Br), Br = min(BC, B - g BC).  RT 8-row tiles of h.
template <int RT>
__global__ void __launch_bounds__(kSplitThreads, 1)
lstm_fwd_split_kernel(const __nv_bfloat16* __restrict__ xp,  // [T, R, 4H]
                      const __nv_bfloat16* __restrict__ w0,  // [H, 4H], rows [0, B)
                      const __nv_bfloat16* __restrict__ w1,  // [H, 4H], rows [B, 2B) (D == 2)
                      const float* __restrict__ h0,          // [R, H] or null (zero state)
                      const float* __restrict__ c0,          // [R, H] or null (zero state)
                      float* __restrict__ hs,                // [T, R, H]
                      float* __restrict__ cs,                // [T, R, H]
                      float* __restrict__ gates,             // [T, R, 4H]
                      unsigned int* counters,                // exchange memory, zeroed
                      __nv_bfloat16* xbuf,                   // [pairs][2][RP x KP]
                      int T_, int B, int H, int G, int BC, int NO, int N0, int KP) {
  using T = __nv_bfloat16;
  constexpr int U = kSplitUnits, NQ = 4 * kSplitUnits, RP = 8 * RT;
  constexpr int KR = kSplitRegKSteps, KW = kSplitKStepsWG;  // in registers, then KW - KR in shared memory
  cg::cluster_group cluster = cg::this_cluster();
  const int k = int(cluster.block_rank());
  const int c_id = int(blockIdx.x) / kCluster;
  const int pair = c_id / 2, half = c_id % 2;
  const int d = pair / G, grp = pair % G;
  const int row0 = d * B + grp * BC;     // the pair's first row in the arrays
  const int Br = min(BC, B - grp * BC);  // and its rows
  const int R = int(gridDim.x) / (2 * kCluster * G) * B;  // rows of the arrays, all directions
  const int G4 = 4 * H;
  // owners [0, N0) in the pair's first cluster, [N0, NO) in its second; a
  // block of rank k owns units [32 m, 32 m + 32) of owner index m
  const int n_mine = half ? NO - N0 : N0, n_other = half ? N0 : NO - N0;
  const int base_mine = half ? N0 : 0, base_other = half ? 0 : N0;
  const int m = k < n_mine ? base_mine + k : -1;
  const int u0 = max(m, 0) * U;
  const int Uk = m < 0 ? 0 : max(0, min(U, H - u0));
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;
  const T* __restrict__ W = d ? w1 : w0;
  const int KS = KP / 16;
  const int slot = RP * KP;  // elements of one receive slot
  // Warpgroup wg multiplies the virtual k-steps v = wg + 3 i, i < KW, which
  // are k-step (v + ks_lo) mod KS of K (none past KS): this cluster's own
  // units first, so that i < kSplitLocalWG needs only this cluster's h.
  const int ks_lo = base_mine * (U / 16);
  auto ks_of = [&](int i) {  // -1: past K
    const int v = wg + kWarpGroups * i;
    return v < KS ? (v + ks_lo) % KS : -1;
  };
  unsigned int* my_count = counters + (2 * pair + half) * kCounterStride;
  const unsigned int* other_count = counters + (2 * pair + 1 - half) * kCounterStride;
  T* xb = xbuf + size_t(pair) * 2 * slot;  // the pair's two slots in global memory
  const uint32_t local_bytes = uint32_t(n_mine * Br * U) * sizeof(T);
  const uint32_t tile_bytes = uint32_t(n_other * U / 8) * 128;  // the other cluster's units, one tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kAtoms = (KW - KR + 3) / 4;  // a warpgroup's atoms of each tile
  unsigned char* a_s = smem_raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023)) & 1023);
  T* recv = reinterpret_cast<T*>(a_s + kWarpGroups * kMTiles * kAtoms * kAtomBytes);  // [2][slot]
  float* part = reinterpret_cast<float*>(recv + 2 * slot);           // [3][RP][NQ]
  T* stage = reinterpret_cast<T*>(part + kWarpGroups * RP * NQ);     // [RP][U]
  uint64_t* bars = reinterpret_cast<uint64_t*>(stage + RP * U);      // local [2], remote [2]
  // A[q][kk] = W_hh[kk, g H + u0 + u] for owned column q = g U + u; zero
  // past H and past the block's units
  auto w_at = [&](int q, int kk) -> unsigned short {
    const int u = q % U;
    return kk < H && u < Uk ? __bfloat16_as_ushort(W[size_t(kk) * G4 + (q / U) * H + u0 + u]) : 0;
  };
  if (m >= 0) {
    for (int e = tid; e < 2 * slot; e += nt) recv[e] = from_float<T>(0.0f);
    for (int e = tid; e < RP * U; e += nt) stage[e] = from_float<T>(0.0f);
    // each warpgroup's shared-memory k-steps i = KR + j, both tiles: atom
    // j / 4 of (warpgroup, tile), its k-step j % 4 (zeros past K and in
    // the atoms' unused k-steps)
    for (int e = tid; e < kWarpGroups * kMTiles * kAtoms * 4096; e += nt) {
      const int atom = e >> 12, o = e & 4095;  // elements of an atom, in (q, c) order
      const int w = atom / (kMTiles * kAtoms), mt = atom / kAtoms % kMTiles, j = atom % kAtoms * 4 + (o & 63) / 16;
      const int q = o >> 6, c = o & 63;
      const int v = w + kWarpGroups * (KR + j);
      const int kk = ((v + ks_lo) % KS) * 16 + c % 16;
      *reinterpret_cast<unsigned short*>(a_s + atom * kAtomBytes + sw128_at(q, c)) =
          v < KS && j < KW - KR ? w_at(mt * 64 + q, kk) : 0;
    }
    __syncthreads();
    // slot 1 holds h[-1] = round(h0) for step 0, all units
    if (h0 != nullptr) {
      for (int e = tid; e < Br * H; e += nt) {
        const int r = e / H, j = e % H;
        recv[slot + slot_at<T>(r, j, KP, KP)] = from_float<T>(h0[size_t(row0 + r) * H + j]);
      }
    }
  }
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // local slot t & 1 receives this cluster's h[t] for t <= T-2: arm the
    // first two; a remote barrier is armed when its copy is issued
    if (m >= 0 && T_ >= 2) bar_expect(bars, local_bytes);
    if (m >= 0 && T_ >= 3) bar_expect(bars + 1, local_bytes);
  }

  // the register k-steps i < KR of both tiles as A fragments, this warp's
  // 16 columns of each, straight from W_hh (once; zeros past K)
  uint32_t wa[kMTiles][KR][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const int ks = ks_of(i);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int q = mt * 64 + wq * 16 + gr + (rr & 1) * 8;
        const int kk = ks * 16 + 2 * tig + (rr >> 1) * 8;
        const uint32_t lo = ks >= 0 ? w_at(q, kk) : 0, hi = ks >= 0 ? w_at(q, kk + 1) : 0;
        wa[mt][i][rr] = lo | (hi << 16);
      }
    }
  }

  // this thread's (row, unit) pairs e = tid + p nt, r << 16 | u (-1: none),
  // their cell state and the step's four xp values
  int ru[kPairs];
  float c[kPairs];
  T xv[kPairs][4];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int e = tid + p * nt, r = e / U, u = e % U;
    ru[p] = e < Br * U && u < Uk ? r << 16 | u : -1;
    c[p] = (ru[p] >= 0 && c0 != nullptr) ? c0[size_t(row0 + r) * H + u0 + u] : 0.0f;
  }
  auto prefetch = [&](int t) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (ru[p] < 0) continue;
      const T* x = xp + (size_t(t) * R + row0 + (ru[p] >> 16)) * G4 + u0 + (ru[p] & 0xffff);
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[p][g] = x[g * H];
    }
  };
  prefetch(0);
  fence_proxy_async();  // a_s and h0 written here; wgmma reads them through the async proxy
  cluster.sync();  // every block runs, with its barriers armed and its slots set up

  // this warpgroup's atoms of W_hh's columns (its shared-memory k-steps)
  const uint64_t a_base = a_desc(a_s + wg * kMTiles * kAtoms * kAtomBytes, 0);
  uint32_t parity = 0;  // bit x: parity of barrier x's phase to wait for
  for (int t = 0; m >= 0 && t < T_; ++t) {
    const int in_slot = (t + 1) & 1;  // h[t-1]
    if (t > 0) {
      bar_wait(bars + in_slot, (parity >> in_slot) & 1);
      parity ^= 1u << in_slot;
      // the slot's next phase receives h[t+1]
      if (tid == 0 && t + 1 <= T_ - 2) bar_expect(bars + in_slot, local_bytes);
    }
    T* hin = recv + in_slot * slot;
    fence_proxy_async();  // h came by st.async; wgmma reads it through the async proxy
    // 2: the product, for each 8-row tile of h each warpgroup its virtual
    // k-steps in order into one set of accumulators; before i =
    // kSplitLocalWG of the first tile, the other cluster's h[t-1] is copied
    // in.  No wgmma sits on a branch (a k-step past K multiplies zero
    // fragments by k-step 0; the tiles are unrolled).
    //
    // The other cluster's h[t-1]: published in the pair's global slot once
    // all its owners have counted; one bulk copy a tile of 8 rows, issued
    // by thread 0 (no C++ branch: see fetch_after_count).  Where not `go`
    // (step 0, whose h0 is all here, and the second row tile, whose h came
    // with the first) it fetches nothing and waits for the phase that has
    // completed last.
    auto remote = [&](bool go) {
      const int rb = 2 + in_slot;
      const size_t off0 = size_t(in_slot) * slot + size_t(base_other) * U * 8, off1 = off0 + size_t(KP) * 8;
      fetch_after_count(tid == 0 && go, other_count, uint32_t(t) * uint32_t(n_other), bars + rb, tile_bytes,
                        RT, recv + off0, xb + off0, recv + off1, xb + off1);
      bar_wait_asm(bars + rb, ((parity >> rb) & 1) ^ uint32_t(!go));
      parity ^= uint32_t(go) << rb;
    };
    const uint64_t h_desc = b_desc(hin);
    float* pw = part + wg * RP * NQ;
    // one row tile after the other (unrolled: as a loop ptxas serializes the
    // wgmma; two tiles spill 256 bytes a thread)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      float acc[kMTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
      // virtual k-step i of row tile rt into the accumulators.  Descriptors
      // as base + offset, the offset without a branch: a branch between two
      // wgmma makes ptxas fence every wgmma after it (WARPGROUP.ARRIVE),
      // which tripled the product's time.
      auto product = [&](int i) {
        const int v = wg + kWarpGroups * i;
        int ks = v + ks_lo;
        ks = ks >= KS ? ks - KS : ks;
        ks = v < KS ? ks : 0;
        // slot_at(rt 8, ks 16) in 16-byte units: rt KP + ks 16
        const uint64_t db = h_desc + uint64_t(rt * KP + ks * 16);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          if (i < KR) {
            wgmma_m64n8k16(acc[mt], wa[mt][i < KR ? i : 0], db, 1);
          } else {
            const int j = i < KR ? 0 : i - KR;
            wgmma_m64n8k16_ss(acc[mt], a_base + uint64_t(((mt * kAtoms + j / 4) * kAtomBytes + j % 4 * 32) >> 4), db);
          }
        }
      };
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kSplitLocalWG; ++i) product(i);
      remote(t > 0 && rt == 0);
      wgmma_fence();
#pragma unroll
      for (int i = kSplitLocalWG; i < KW; ++i) product(i);
      wgmma_commit();
      wgmma_wait<0>();
      // acc[mt][e]: column mt 64 + wq 16 + gr + (e >> 1) 8, row rt 8 + 2 tig + (e & 1)
      const int r = rt * 8 + 2 * tig;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = mt * 64 + wq * 16 + gr + h * 8;
          if (r < Br) pw[r * NQ + q] = acc[mt][2 * h];
          if (r + 1 < Br) pw[(r + 1) * NQ + q] = acc[mt][2 * h + 1];
        }
      }
    }
    __syncthreads();  // the product complete
    // 2, 3: the cell update of the pairs; h rounded into the send stage
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (ru[p] < 0) continue;
      const int r = ru[p] >> 16, u = ru[p] & 0xffff, j = u0 + u;
      float pg[4];  // the warpgroups' partials, added in order
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float v[kWarpGroups];
#pragma unroll
        for (int w = 0; w < kWarpGroups; ++w) v[w] = part[(w * RP + r) * NQ + g * U + u];
        pg[g] = v[0];
#pragma unroll
        for (int w = 1; w < kWarpGroups; ++w) pg[g] += v[w];
      }
      const float i = sigmoid(to_float(xv[p][0]) + pg[0]);
      const float f = sigmoid(to_float(xv[p][1]) + pg[1]);
      const float g = tanhf(to_float(xv[p][2]) + pg[2]);
      const float o = sigmoid(to_float(xv[p][3]) + pg[3]);
      c[p] = f * c[p] + i * g;
      const float h = o * tanhf(c[p]);
      const size_t row = size_t(t) * R + row0 + r;
      hs[row * H + j] = h;
      cs[row * H + j] = c[p];
      float* gt = gates + row * G4 + j;
      gt[0] = i;
      gt[H] = f;
      gt[2 * H] = g;
      gt[3 * H] = o;
      stage[r * U + u] = from_float<T>(h);
    }
    __syncthreads();  // the stage is complete; every read of the product and of slot in_slot is done
    // 4: h[t] (the last step's is not needed): warps 0-10 to this cluster's
    // owners' slot t & 1 by st.async; the last warp to the pair's global
    // slot t & 1, then one count on this cluster's counter
    if (t < T_ - 1) {
      constexpr int kPieces = U / 8;  // 16-byte pieces of a row
      const int pieces = Br * kPieces;
      T* out = recv + (t & 1) * slot;
      if (warp < kWarps - 1) {
        const uint32_t bar_off = uint32_t(t & 1) * 8;
        for (int e = tid; e < n_mine * pieces; e += nt - 32) {
          const int to = e / pieces, pc = e % pieces;
          const int r = pc / kPieces, col = pc % kPieces * 8;
          const float4 v = *reinterpret_cast<const float4*>(stage + r * U + col);
          send4(cluster_addr(out + slot_at<T>(r, m * U + col, KP, KP), to), v, cluster_addr(bars, to) + bar_off);
        }
      } else {
        T* gout = xb + (t & 1) * slot;
        for (int pc = lane; pc < pieces; pc += 32) {
          const int r = pc / kPieces, col = pc % kPieces * 8;
          *reinterpret_cast<float4*>(gout + slot_at<T>(r, m * U + col, KP, KP)) =
              *reinterpret_cast<const float4*>(stage + r * U + col);
        }
        __syncwarp();
        if (lane == 0) counter_release_add(my_count);
      }
    }
    if (t + 1 < T_) prefetch(t + 1);  // loads while h travels
  }
  cluster.sync();  // no block leaves while a peer may still write to it
}

// ---------------------------------------------------------------------------
// The grid route
// ---------------------------------------------------------------------------

// A pass's tile shape: lanes along the rows (8, the four lanes of a row
// its four gates; or 1, each lane a column), row slots of a lane and k of a
// staged chunk of h.  A launch takes the first shape (in this order) whose
// rows hold a direction's, or a later one where that does not fit in shared
// memory; (1, 1) fits wherever the port's first grid kernel did.
struct GridPass {
  int lr, ri, kc;
};
constexpr GridPass kGridPasses[] = {{8, 12, 64}, {8, 6, 64}, {8, 4, 64}, {8, 2, 384}, {8, 1, 768},
                                    {8, 1, 64}, {1, 2, 832}, {1, 1, 832}};
constexpr int kGridPassCount = int(sizeof(kGridPasses) / sizeof(GridPass));

// Floats of the grid route's scratch for passes of `rows_pass` rows of a
// direction's B and chunks of kc k over H: the chunks of h [buffers]
// [rows_pass][grid_lda(kc)], then, in the same bytes once the product is
// done, the warps' partials [kGridWarps][min(rows_pass, B)][4 min(U,
// kGridUnits)].
__host__ __device__ constexpr size_t grid_scratch(int B, int H, int U, int rows_pass, int kc) {
  const size_t chunks = size_t(grid_buffers(H, kc)) * rows_pass * grid_lda<float>(kc);
  const size_t partials = size_t(kGridWarps) * (rows_pass < B ? rows_pass : B) * 4 * (U < kGridUnits ? U : kGridUnits);
  return chunks > partials ? chunks : partials;
}

// Shared memory of the grid route for D directions of B rows, U units a
// block and tile shape `pass`: W_hh's columns [D][4U][grid_ld(H)] (T), the
// scratch and c [D B][U] (fp32).
template <typename T>
constexpr size_t grid_smem_bytes(int D, int B, int H, int U, GridPass pass) {
  return align16(size_t(D) * 4 * U * grid_ld(H) * sizeof(T)) +
         (grid_scratch(B, H, U, pass.lr * pass.ri, pass.kc) + size_t(D) * B * U) * sizeof(float);
}

// Block b owns units [b U, b U + U) (fewer in the last block) and keeps
// their 4U columns of each direction's W_hh in shared memory, column
// u 4 + g of direction d for gate g of unit u, k contiguous.  Per step t,
// for each direction, block of at most kGridUnits units and pass of at most
// LR RI rows: h[t-1] of the pass's rows (h0 at t = 0) streams through in
// chunks of KC k (cp.async, the next chunk in flight while the current one
// multiplies; lstm_grid.cuh), each thread's tile of pre-activations (LR = 8:
// its gate of up to 8 units, rows lr + 8 i; LR = 1: its column, every row)
// accumulates in registers over its warp's quads, the warps' partials add
// in warp order in the cell update, which writes hs, cs and the gates of
// the pass.  Then one grid-wide barrier.  vec: h's rows take 16-byte copies
// (H a multiple of 4).
template <typename T, int D, int LR, int RI, int KC>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_grid_kernel(const T* __restrict__ xp,     // [T, R, 4H]
                     const T* __restrict__ w0,     // [H, 4H], rows [0, B)
                     const T* __restrict__ w1,     // [H, 4H], rows [B, 2B) (D == 2)
                     const float* __restrict__ h0, // [R, H] or null (zero state)
                     const float* __restrict__ c0, // [R, H] or null (zero state)
                     float* hs,                    // [T, R, H]; read back across blocks
                     float* __restrict__ cs,       // [T, R, H]
                     float* __restrict__ gates,    // [T, R, 4H]
                     int T_, int B, int H, int U, int vec) {
  constexpr int RB = LR * RI, LDA = grid_lda<float>(KC);
  constexpr int CJ = 4 * kGridUnits * LR / 32;  // columns a lane
  cg::grid_group grid = cg::this_grid();
  const int R = D * B, G4 = 4 * H, LDW = grid_ld(H);
  const int u0 = blockIdx.x * U, Ub = min(U, H - u0);  // this block's units
  const int NCB = 4 * min(U, kGridUnits);               // partial columns of a row
  const int RP = min(RB, B);                            // partial rows
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // [D][4U][LDW]
  float* a_s = reinterpret_cast<float*>(smem_raw + align16(size_t(D) * 4 * U * LDW * sizeof(T)));  // [2][RB][LDA]
  float* part = a_s;                                  // [kGridWarps][RP][NCB], after the product
  float* c_s = a_s + grid_scratch(B, H, U, RB, KC);   // [R][U]

  // W_hh[k, g H + j] at w_s[d][(j - u0) 4 + g][k]; zeros past H (the last
  // quad of k) and past the block's units
  for (int e = tid; e < D * 4 * U * LDW; e += kThreads) w_s[e] = from_float<T>(0.0f);
  __syncthreads();
  for (int e = tid; e < D * H * 4 * Ub; e += kThreads) {
    const int u = e % Ub, g = e / Ub % 4, k = e / (4 * Ub) % H, d = e / (4 * Ub * H);
    w_s[(size_t(d) * 4 * U + u * 4 + g) * LDW + k] = (d ? w1 : w0)[size_t(k) * G4 + g * H + u0 + u];
  }
  for (int e = tid; e < R * U; e += kThreads) {
    const int r = e / U, u = e % U;
    c_s[e] = c0 != nullptr && u < Ub ? c0[size_t(r) * H + u0 + u] : 0.0f;
  }
  __syncthreads();

  const int chunks = grid_chunks(H, KC);
  for (int t = 0; t < T_; ++t) {
    const float* h_prev = t > 0 ? hs + size_t(t - 1) * R * H : h0;
    for (int d = 0; d < D; ++d) {
      for (int ub = 0; ub < Ub; ub += kGridUnits) {
        const int Uc = min(kGridUnits, Ub - ub);
        const T* w = w_s + (size_t(d) * 4 * U + ub * 4) * LDW;
        for (int r0 = 0; r0 < B; r0 += RB) {
          const int rows = min(RB, B - r0);
          const float* src = h_prev != nullptr ? h_prev + size_t(d * B + r0) * H : nullptr;
          // 2: pre[r][u 4 + g] = sum_k round(h[t-1][r][k]) W[k][g H + u0 + ub + u]
          float acc[RI][CJ];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
#pragma unroll
            for (int j = 0; j < CJ; ++j) acc[i][j] = 0.0f;
          }
          // this lane's column slots: its gate of each unit (LR = 8), or its
          // own column (LR = 1)
          const int jn = LR == 8 ? Uc : grid_lane_columns<LR>(4 * Uc);
          grid_stage<float, KC>(a_s, RB, src, H, rows, 0, H, vec, w0);
          cp_async_commit();
          for (int ch = 0; ch < chunks; ++ch) {
            cp_async_wait<0>();
            __syncthreads();  // chunk ch staged; every warp is done with chunk ch - 1
            if (ch + 1 < chunks) {
              grid_stage<float, KC>(a_s + ((ch + 1) & 1) * RB * LDA, RB, src, H, rows, (ch + 1) * KC, H, vec, w0);
              cp_async_commit();
            }
            const int nq = (min(KC, H - ch * KC) + 3) / 4;
            grid_product<LR, KC>(acc, a_s + (ch & 1) * RB * LDA, w + ch * KC, LDW, jn, nq);
          }
          __syncthreads();  // every warp is done with the chunks, whose bytes take the partials
          grid_partials<LR>(part, acc, RP, NCB, rows, jn);
          __syncthreads();  // the product complete
          // 3: the cell update of the pass's rows and the unit block's units
          for (int e = tid; e < rows * Uc; e += kThreads) {
            const int r = e / Uc, u = e % Uc, j = u0 + ub + u, rg = d * B + r0 + r;
            const size_t row = size_t(t) * R + rg;
            const T* x = xp + row * G4;
            const float i = sigmoid(to_float(x[j]) + grid_sum(part, RP, NCB, r, u * 4));
            const float f = sigmoid(to_float(x[H + j]) + grid_sum(part, RP, NCB, r, u * 4 + 1));
            const float g = tanhf(to_float(x[2 * H + j]) + grid_sum(part, RP, NCB, r, u * 4 + 2));
            const float o = sigmoid(to_float(x[3 * H + j]) + grid_sum(part, RP, NCB, r, u * 4 + 3));
            float* cp = c_s + rg * U + ub + u;
            const float c = f * *cp + i * g;
            const float h = o * tanhf(c);
            *cp = c;
            hs[row * H + j] = h;
            cs[row * H + j] = c;
            float* gt = gates + row * G4;
            gt[j] = i;
            gt[H + j] = f;
            gt[2 * H + j] = g;
            gt[3 * H + j] = o;
          }
          __syncthreads();  // the partials read before the next pass stages into their bytes
        }
      }
    }
    grid.sync();  // the whole h[t] is visible before step t + 1 reads it
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

struct FwdArgs {
  const void *xp, *w0, *w1, *h0, *c0;
  void *hs, *cs, *gates;
  int steps, B, H;
  void* exchange;          // the split walk's exchange memory (zeroed here before its launch)
  size_t exchange_bytes;   // its size
};

enum Route : int { kGrid = 0, kWalk = 1, kSplit = 2 };

// The route and launch on this card for D directions of B rows each.
struct FwdLaunch {
  int route;           // kWalk (the cluster walk), kSplit (the split walk) or kGrid
  ClusterLaunch info;  // walks: row groups, shared memory, clusters; registers of any route
  FwdShape shape;      // the cluster walk
  SplitShape split;    // the split walk
  size_t exchange;     // the split walk: bytes of exchange memory it needs
  int grid_blocks, grid_units;  // grid route: blocks, units a block
  size_t grid_smem;
  int grid_resident;   // grid route: blocks the card holds at once
};

// The walk's occupancy on this card into `info`, and its launch when `a` is
// given and the card holds a cluster.
template <typename T, int RC>
cudaError_t walk(const FwdShape& s, int D, const FwdArgs* a, cudaStream_t stream, ClusterLaunch* info) {
  auto kernel = lstm_fwd_kernel<T, RC>;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, D * info->groups, kWalkThreads, stream, &config, &attr, info);
  // a launch shape only, or no cluster fits the card: nothing launched
  if (err != cudaSuccess || a == nullptr || info->clusters < 1) return err;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(a->xp),
                           static_cast<const T*>(a->w0), static_cast<const T*>(a->w1),
                           static_cast<const float*>(a->h0), static_cast<const float*>(a->c0),
                           static_cast<float*>(a->hs), static_cast<float*>(a->cs),
                           static_cast<float*>(a->gates), a->steps, a->B, a->H, info->groups,
                           info->rows, s.units, s.unit_pad, s.kp, s.ldw, s.ldh, s.rows_padded);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The split walk's occupancy on this card into `fl->info`, and its launch
// when `a` is given and the card holds all its clusters at once: the
// exchange memory zeroed on `stream`, then the walk.
template <int RT>
cudaError_t split_walk(FwdLaunch* fl, int D, const FwdArgs* a, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const SplitShape& s = fl->split;
  const int pairs = D * fl->info.groups;
  auto kernel = lstm_fwd_split_kernel<RT>;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attrs[2];
  cudaError_t err = cluster_config(kernel, 2 * pairs, kSplitThreads, stream, &config, attrs, &fl->info);
  // a launch shape only, or the card does not hold every cluster at once:
  // nothing launched
  if (err != cudaSuccess || a == nullptr || fl->info.clusters < 2 * pairs) return err;
  if (a->exchange == nullptr || a->exchange_bytes < fl->exchange) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(a->exchange, 0, fl->exchange, stream);
  if (err != cudaSuccess) return err;
  unsigned char* ex = static_cast<unsigned char*>(a->exchange);
  return split_launch(kernel, &config, attrs, static_cast<const T*>(a->xp), static_cast<const T*>(a->w0),
                      static_cast<const T*>(a->w1), static_cast<const float*>(a->h0),
                      static_cast<const float*>(a->c0), static_cast<float*>(a->hs), static_cast<float*>(a->cs),
                      static_cast<float*>(a->gates), reinterpret_cast<unsigned int*>(ex),
                      reinterpret_cast<T*>(ex + split_counter_bytes(pairs)), a->steps, a->B, a->H,
                      fl->info.groups, fl->info.rows, s.owners, s.first, s.kp);
}

// The grid route's launch on this card into `fl`, and the launch when a->xp
// is set: one block per U = ceil(H / SMs) units, all resident at once (else
// cudaErrorCooperativeLaunchTooLarge, before anything launches); the tile
// shape the first of kGridPasses whose rows hold a direction's, or a later
// one where that does not fit in shared memory.
template <typename T, int D, int I = 0>
void grid_kernel(int at, decltype(&lstm_fwd_grid_kernel<T, D, 1, 1, 64>)* kernel) {
  if constexpr (I < kGridPassCount) {
    constexpr GridPass p = kGridPasses[I];
    if (at == I) {
      *kernel = lstm_fwd_grid_kernel<T, D, p.lr, p.ri, p.kc>;
    } else {
      grid_kernel<T, D, I + 1>(at, kernel);
    }
  }
}

template <typename T, int D>
cudaError_t grid_route(FwdLaunch* fl, const FwdArgs* a, cudaStream_t stream) {
  int sms = 0, optin = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const int B = a->B, H = a->H;
  const int U = (H + sms - 1) / sms;  // at most one block per SM
  fl->grid_units = U;
  fl->grid_blocks = (H + U - 1) / U;
  auto rows_of = [](int i) { return kGridPasses[i].lr * kGridPasses[i].ri; };
  int at = 0;  // the first of the shapes with the fewest rows that hold B
  for (int i = 1; i < kGridPassCount; ++i) {
    if (rows_of(i) >= B && rows_of(i) < rows_of(at)) at = i;
  }
  while (at + 1 < kGridPassCount && grid_smem_bytes<T>(D, B, H, U, kGridPasses[at]) > size_t(optin)) ++at;
  fl->grid_smem = grid_smem_bytes<T>(D, B, H, U, kGridPasses[at]);
  decltype(&lstm_fwd_grid_kernel<T, D, 1, 1, 64>) kernel = nullptr;
  grid_kernel<T, D>(at, &kernel);
  err = occupancy(kernel, fl->grid_smem, &fl->grid_resident, &fl->info.registers, &fl->info.local_bytes);
  if (err == cudaErrorInvalidConfiguration) {  // not one block fits an SM
    fl->grid_resident = 0;
    err = cudaSuccess;
  }
  if (err != cudaSuccess || a->xp == nullptr) return err;  // the launch shape only
  if (fl->grid_resident < fl->grid_blocks) return cudaErrorCooperativeLaunchTooLarge;
  const T* xp_t = static_cast<const T*>(a->xp);
  const T* w0_t = static_cast<const T*>(a->w0);
  const T* w1_t = static_cast<const T*>(a->w1);
  const float* h0_t = static_cast<const float*>(a->h0);
  const float* c0_t = static_cast<const float*>(a->c0);
  float* hs_t = static_cast<float*>(a->hs);
  float* cs_t = static_cast<float*>(a->cs);
  float* gates_t = static_cast<float*>(a->gates);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  int steps = a->steps, rows = B, hidden = H, units = U;
  int vec = H % 4 == 0 && aligned(a->hs) && aligned(a->h0);
  void* args[] = {&xp_t, &w0_t, &w1_t, &h0_t, &c0_t, &hs_t, &cs_t, &gates_t,
                  &steps, &rows, &hidden, &units, &vec};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(fl->grid_blocks), dim3(kThreads), args,
                                    fl->grid_smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Chooses the route from the shape and the card before anything launches:
// the cluster walk wherever a cluster holds a row and the card holds a
// cluster; else, in bf16, the split walk wherever a pair holds a row and the
// card holds all its clusters at once; else the grid route.  Then launches
// it when a->xp is set, else only fills `fl`.
template <typename T, int D>
cudaError_t launch(const FwdArgs* a, cudaStream_t stream, FwdLaunch* fl) {
  *fl = {};
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const int H = a->H;
  auto fits = [&](int rows) {
    const FwdShape s = fwd_shape<T>(rows, H);
    return s.smem <= size_t(optin) && fwd_walk_fits<T>(s, rows);
  };
  const FwdArgs* run = a->xp != nullptr ? a : nullptr;
  if (row_groups(a->B, kPairs * kWalkThreads, fits, &fl->info.groups, &fl->info.rows)) {
    fl->shape = fwd_shape<T>(fl->info.rows, H);
    fl->info.smem = fl->shape.smem;
    switch (fl->shape.rows_chunk) {
      case 1: err = walk<T, 1>(fl->shape, D, run, stream, &fl->info); break;
      case 2: err = walk<T, 2>(fl->shape, D, run, stream, &fl->info); break;
      case 4: err = walk<T, 4>(fl->shape, D, run, stream, &fl->info); break;
      default: err = walk<T, 8>(fl->shape, D, run, stream, &fl->info); break;
    }
    if (err != cudaSuccess) return err;
    if (fl->info.clusters >= 1) {
      fl->route = kWalk;
      return cudaSuccess;
    }
  }
  if constexpr (sizeof(T) == 2) {
    auto split_fits = [&](int rows) {
      const SplitShape s = split_shape(rows, H);
      return s.owners >= kSplitMinOwners && kWarpGroups * kSplitKStepsWG >= s.ksteps && s.smem <= size_t(optin);
    };
    fl->info = {};
    if (row_groups(a->B, kSplitMaxRows, split_fits, &fl->info.groups, &fl->info.rows)) {
      fl->split = split_shape(fl->info.rows, H);
      fl->info.smem = fl->split.smem;
      const int pairs = D * fl->info.groups;
      fl->exchange = split_counter_bytes(pairs) + size_t(pairs) * fl->split.pair_elems * sizeof(T);
      err = fl->split.rows_padded > 8 ? split_walk<2>(fl, D, run, stream) : split_walk<1>(fl, D, run, stream);
      if (err != cudaSuccess) return err;
      if (fl->info.clusters >= 2 * pairs) {
        fl->route = kSplit;
        return cudaSuccess;
      }
    }
    fl->info = {};
    fl->exchange = 0;
  }
  fl->route = kGrid;
  return grid_route<T, D>(fl, a, stream);
}

template <int D>
cudaError_t launch(const FwdArgs& a, int bf16, void* stream, FwdLaunch* fl) {
  if (a.steps <= 0 || a.B <= 0 || a.H <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, D>(&a, s, fl) : launch<float, D>(&a, s, fl);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function returns its
// cudaError_t; 0 is success.  `bf16` selects bf16 operands (xp, W_hh),
// otherwise fp32.  h0 / c0 / hs / cs / gates are fp32.  `route`, where
// given, receives the route launched: 1 the cluster walk, 2 the split walk,
// 0 the grid route.  `exchange` is scratch memory of `exchange_bytes` bytes
// (at least what lstm_fwd_exchange_bytes reports for the shape; null where
// that is 0), which the split walk uses and zeroes on the stream first.

// One direction: xp [T, B, 4H], whh [H, 4H], h0 and c0 [B, H].
extern "C" int lstm_fwd(const void* xp, const void* whh, const void* h0, const void* c0,
                        void* hs, void* cs, void* gates, int T, int B, int H, int bf16,
                        void* exchange, long long exchange_bytes, void* stream, int* route) {
  const FwdArgs a{xp, whh, nullptr, h0, c0, hs, cs, gates, T, B, H, exchange, size_t(exchange_bytes)};
  FwdLaunch fl;
  const cudaError_t err = launch<1>(a, bf16, stream, &fl);
  if (route != nullptr) *route = fl.route;
  return err;
}

// Both directions, zero initial state: xp [T, 2B, 4H], rows [B, 2B) already
// time-reversed; whh_f and whh_b [H, 4H].
extern "C" int bilstm_fwd(const void* xp, const void* whh_f, const void* whh_b, void* hs,
                          void* cs, void* gates, int T, int B, int H, int bf16, void* exchange,
                          long long exchange_bytes, void* stream, int* route) {
  const FwdArgs a{xp, whh_f, whh_b, nullptr, nullptr, hs, cs, gates, T, B, H, exchange, size_t(exchange_bytes)};
  FwdLaunch fl;
  const cudaError_t err = launch<2>(a, bf16, stream, &fl);
  if (route != nullptr) *route = fl.route;
  return err;
}

namespace {
cudaError_t fwd_config(int D, int B, int H, int bf16, FwdLaunch* fl) {
  if (D != 1 && D != 2) return cudaErrorInvalidValue;
  const FwdArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, B, H, nullptr, 0};
  return D == 1 ? launch<1>(a, bf16, nullptr, fl) : launch<2>(a, bf16, nullptr, fl);
}
}  // namespace

// Bytes of exchange memory the two functions above need for D directions of
// B rows each on this card (0 but on the split walk).
extern "C" int lstm_fwd_exchange_bytes(int D, int B, int H, int bf16, long long* bytes) {
  FwdLaunch fl;
  const cudaError_t err = fwd_config(D, B, H, bf16, &fl);
  *bytes = static_cast<long long>(fl.exchange);
  return err;
}

// The launch the two functions above make for D directions of B rows each
// on this card: route (1 the cluster walk, 2 the split walk, 0 the grid
// route), blocks, units a block, dynamic shared memory in bytes; the walks'
// cluster size, threads a block, clusters the card holds at once, registers
// and spilled bytes a thread, row groups a direction (one cluster each on
// the cluster walk, a pair of clusters on the split walk) and rows a group
// (the grid route: 0 cluster, 256 threads, the blocks it holds at once in
// `clusters`, no row groups).
extern "C" int lstm_launch_config(int D, int B, int H, int bf16, int* route, int* blocks,
                                  int* units, long long* smem, int* cluster, int* threads,
                                  int* clusters, int* registers, int* local_bytes, int* groups,
                                  int* rows) {
  FwdLaunch fl;
  const cudaError_t err = fwd_config(D, B, H, bf16, &fl);
  if (err != cudaSuccess) return err;
  *route = fl.route;
  *registers = fl.info.registers;
  *local_bytes = fl.info.local_bytes;
  if (fl.route != kGrid) {
    const bool split = fl.route == kSplit;
    *blocks = D * fl.info.groups * kCluster * (split ? 2 : 1);
    *units = split ? kSplitUnits : fl.shape.units;
    *smem = static_cast<long long>(fl.info.smem);
    *cluster = kCluster;
    *threads = kWalkThreads;
    *clusters = fl.info.clusters;
    *groups = fl.info.groups;
    *rows = fl.info.rows;
  } else {
    *blocks = fl.grid_blocks;
    *units = fl.grid_units;
    *smem = static_cast<long long>(fl.grid_smem);
    *cluster = 0;
    *threads = kThreads;
    *clusters = fl.grid_resident;
    *groups = *rows = 0;
  }
  return cudaSuccess;
}

// The text of a cudaError_t, for every wrapper of this library.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
