// Backward LSTM recurrences for Hopper (sm_90a): one and two directions.
//
// Replaces the TPU kernels in voicesplit_tpu/ops/lstm_pallas.py:
//   lstm_bwd   <- _bwd_kernel  (:135, launched by _bwd :197): one direction,
//                 the reverse walk starting from the final-state cotangents
//                 (dhf, dcf); gives dxp, dW_hh, dh0 and dc0;
//   bilstm_bwd <- _bwd2_kernel (:317, launched by _bwd2 :387): both
//                 directions of _fwd2_kernel in one pass, rows [0,B) with
//                 W_hh_f and rows [B,2B) (already time-reversed) with
//                 W_hh_b, zero initial state and zero final cotangents;
//                 gives dxp and one dW_hh per direction.
//
// Per reverse step t, for every row r and hidden unit j (gate order
// [i, f, g, o], activated gates saved by the forward):
//   c     = f * c[t-1] + i * g,   tc = tanh(c)
//   dh    = dhs[t] + dh_rec,      dct = dh * o * (1 - tc^2) + dc
//   dgates = [dct g i(1-i), dct c[t-1] f(1-f), dct i (1-g^2), dh tc o(1-o)]
//   dc    <- dct * f
//   dh_rec <- round(dgates) . W_hh[j, :]^T            (all 4H columns)
// and, off the sequential chain, for each direction d over its rows:
//   dW_d[j, q] = sum_{t, r} round(h[t-1, r, j]) * round(dgates[t, r, q])
// where round() casts to the operand type (bf16 or fp32) as the Pallas
// kernel does before its matrix products (lstm_pallas.py:176, :359), and
// every product accumulates in fp32.  dxp = dgates in the operand type;
// dW_hh is fp32.  h[t-1] and c[t-1] are read in place from the forward's
// hs and cs (h0 and c0 at t = 0), so the shifted copies the JAX wrapper
// builds are not needed.  One C call launches two kernels: the reverse
// walk, then the dW_hh product over what the walk wrote.  The walk takes one
// of three routes, chosen from the shape and the card before anything
// launches (lstm_bwd_launch_config reports which): the cluster walk wherever
// a cluster holds one row and the card holds a cluster (every shape of the
// model at H = 400), else in bf16 the split walk wherever a pair of clusters
// holds a row and the card holds all its clusters at once (H = 800), else
// the grid route (fp32 at H = 800).
//
// lstm_bwd_kernel, the cluster walk: one thread-block cluster of C = 16
// blocks per direction and row group (non-portable cluster size), clusters
// that never talk to each other: no cooperative launch, no grid-wide
// barrier.  The cluster primitives, the staging of a block's W_hh columns
// and the row groups are lstm_cluster.cuh's, shared with the forward walk
// (lstm_fwd.cu).  Why:
// the design before it (one cooperative grid of 100 blocks, a grid.sync()
// a step, all R x 4H dgates of a step staged from L2 into every block, and
// dW_hh accumulated in the walk) took 6.7 us a step at B = 2.
//   Ownership.  Block k owns the U = ceil(H / C) units J_k (U = 25 at
//   H = 400; the blocks past ceil(H / U) own none and skip the walk) and
//   holds, for the whole walk, the COLUMNS {j, H+j, 2H+j, 3H+j : j in J_k}
//   of its direction's W_hh for all H rows: exactly the dgates columns it
//   computes itself, so no step stages dgates at all.
//   Per step t, block k:
//   1. waits for the partials dh_rec of its units from every owning block
//      (an mbarrier of its own, armed for the bytes it expects), and adds
//      them in rank order to dhs[t];
//   2. computes its 4U columns of dgates[t] (dc carried in registers),
//      writes them to dxp[t] and, rounded, to shared memory;
//   3. computes the partial P_k[r, j] = sum_{q owned} round(dgates[r, q])
//      W[j, q] for all H units j and its direction's rows r, stages it by
//      owner and sends each owner m its [B][U] rows as 16-byte st.async
//      stores into m's receive slot [k][r][u], each counting its bytes on
//      m's mbarrier;
//   4. loads step t-1's gates, c[t-2] and dhs[t-1] of its (row, unit) pairs
//      into registers while the partials travel: they do not depend on the
//      recurrence.
//   A block waits only for what it needs, when it needs it: no block waits
//   for all sixteen to reach a barrier.  Two receive slots, each with its
//   mbarrier: step t's partials go to slot t mod 2 and are summed at step
//   t-1.  A sender writes a slot again only two steps later, after it has
//   received the receiver's partials of the step between, which the
//   receiver sends after it has summed the slot and armed its barrier
//   again; so no slot is overwritten while it is read, and no partial
//   counts on a phase that is not its own.  A wait that never ends traps
//   (a fault, not a hang).  After step 0 (one direction) dh0 is the sum of
//   the last partials and dc0 the carried dc.
//   Products.  bf16: mma.sync.m16n8k16 with W_hh as A: each of the 12
//   warps keeps three 16-unit tiles of its block's columns (7 k-steps of
//   16, 4U <= 112) in registers for the whole walk, loaded once with
//   ldmatrix; B is 8 rows of dgates; every tile and k-step is multiplied
//   without a branch (zero fragments where there is nothing), even and odd
//   k-steps in two accumulators.  The W_hh a step multiplies thus never
//   crosses shared memory (reading it there every step cost more than the
//   products).  fp32: CUDA-core FMAs over the columns in shared memory, one
//   thread per unit j, 2, 4 or 8 rows in registers.  No tensor cores are
//   used for fp32 operands (TF32 would round them).
//
// lstm_dwhh_kernel, dW_hh after the walk: one product of M = H by N = 4H
// with depth K = T * B per direction over the saved hs (h0 at t = 0) and
// dxp, so the walk carries no dW work on its sequential chain.  Blocks of
// 64 units x 64 gate columns, grid (ceil(H/64), ceil(4H/64), D): 175 blocks
// a direction at H = 400.  Each block walks K in chunks of 64 rows; every
// thread loads its 16-byte pieces of the next chunk into registers while
// the block multiplies the current one, h rounded to the operand type on
// its way into shared memory; mma.sync.m16n8k16 with ldmatrix.trans of
// both operands (the fragment code of conv_wgrad.cu), fp32 accumulate.
// fp32 operands take lstm_dwhh_f32_kernel, a register-tiled GEMM on CUDA
// cores (not TF32): tiles of 96 units x 128 columns, 12 x 8 outputs a
// thread, K in chunks of 16 rows, two in flight by cp.async.  Why: the
// fp32 branch of the kernel above (1 unit x 16 columns a thread, 17 scalar
// shared loads per 16 FMAs) took 5.38 ms at the GE2E step's [80, 96], H =
// 768, 6.7 TFLOP/s, where torch.matmul of the same product takes 0.86.
//
// Sum order, fixed, so the same inputs give the same bits: dh_rec of a unit
// is its partials added in rank order 0 .. senders - 1, each partial its
// block's owned columns summed by mma.sync (bf16) or in the order (gate,
// unit) (fp32), on the split walk by wgmma over the k-steps in order; on
// the grid route each warp's quads of columns in order, then the warps'
// partials in warp order; dW_hh[j, q] belongs to one block of the dW
// kernel, which sums its K rows in increasing (t, r) order (mma.sync: 16 at
// a time).  No float atomics;
// the split walk's counters only count.
//
// Row groups.  A direction's B rows go to G clusters of at most the rows
// one holds (rows x U <= 2 x 384 (row, unit) pairs and shared memory: at
// H = 400 23 rows in bf16, 11 in fp32), spread evenly (24 rows: two
// clusters of 12 in bf16, three of 8 in fp32); the grid is D x G clusters,
// and those past the ones the card holds at once (7 on an H100) wait to be
// scheduled.  dW_hh sums over all rows after the walk, as before.
//
// Shared memory of the walk, per block at H = 400 (C = 16, U = 25): W_hh
// columns [H][4U padded] (bf16 97 KB, staged once for the fragments; fp32
// 166 KB, read every step), rounded dgates (two buffers), receive slots
// [2][C][rows][U padded to 28] and the staged partials [C][rows][28]
// (fp32):
//   lstm_bwd   B = 2: 110,608 B bf16, 172,368 B fp32;
//   bilstm_bwd B = 8: 142,864 B bf16, 209,424 B fp32 (227 KB available);
//              B = 24: 168,208 B bf16 (12 rows a cluster), 209,424 B fp32.
// Limits, checked before the launch: bf16 needs 4U <= 112 (H <= 448); both
// need one row of shared memory.  At H = 800 neither fits (bf16 4U = 200;
// fp32 640 KB of columns): those shapes take the split walk (bf16) or the
// grid route.
//
// lstm_bwd_split_kernel, the split walk (lstm_bwd_split and
// bilstm_bwd_split in chip_smoke.py's kernels line), for bf16 shapes one
// cluster cannot hold: two clusters of 16 blocks per direction and row
// group, owning the units and columns of the forward's split walk
// (lstm_fwd.cu: 25 owners of 32 units at H = 800, 13 in the first cluster).
//   A step s.  Wait for the partials of step s+1 (this cluster's by
//   st.async on one mbarrier of slot (s+1) mod 2; the other cluster's: its
//   counter, then one bulk copy counted on a second mbarrier, as the
//   forward's exchange, lstm_cluster.cuh), add each unit's 25 partials in
//   rank order 0 .. 24 to dhs[s], compute the block's 128 dgates columns
//   into dxp and, rounded, into shared memory as the product's B operand;
//   multiply P[j, r] = sum_q W_hh[j, q] round(dgates[r, q]) for every unit
//   j; stage P by owner in the receive slot this step has read (no block
//   writes it before this block has sent), send each owner its [rows][32]
//   slice: this cluster's by 16-byte st.async into slot s mod 2 (warps
//   0-7), the other cluster's into the pair's global slot s mod 2 (warps
//   8-11, then one count, red.release.gpu).  The waits come before any
//   wgmma of the step, so none sits between two in flight.  Step 0's
//   partials give dh0 (two directions exchange them all the same: a walk
//   that left before spilled).
//   Products.  wgmma.m64n8k16 with A = W_hh[j, owned q] (64 units by 16
//   columns) and B = the 8 rows of dgates: 13 tiles of 64 units by 8
//   k-steps.  Warpgroup wg multiplies tiles wg + 3 c, c < 5 (slots past the
//   13th tile multiply the last tile's and drop the result, so that every
//   warpgroup runs the same wgmma), k-steps outer: c = 0 from registers (32
//   registers), c = 1 .. 4 from swizzled atoms in shared memory (160 KB for
//   10 tiles).  Two register tiles a warpgroup spilled 128 bytes a thread.
//   Rows: at most 8 a pair; more take more row groups where the card holds
//   their clusters (one direction at 9-16 rows: four clusters), else the
//   grid route (two directions at 9 rows: eight clusters).
//   Shared memory at H = 800: 218,144 B (atoms 160 KB + 1 KB for their
//   alignment, dgates 2 KB, receive slots 2 x 25.6 KB); 154 registers, no
//   spill.  Exchange memory: 1.28 MB a pair (global slots [2][receiver][25
//   senders][8][32] fp32), whose counters are zeroed before the launch.
//
// lstm_bwd_grid_kernel, the grid route (lstm_bwd_grid and bilstm_bwd_grid in
// chip_smoke.py's kernels line; fp32 at configs/voicesplit_wide.json's
// lstm_dim 800 and at the GE2E speaker encoder's H = 768, 96 rows a training
// step): a persistent cooperative grid, with dW_hh taken off it.  Block b
// owns U = ceil(H / #SMs) units (6 at H = 768 on 132 SMs: 128 blocks; 7 at
// H = 800: 115; one an SM, all resident at once, which the launch checks
// first: more blocks than the card holds is refused, not hung) and keeps its
// U rows of each W_hh [U][4H] in shared memory.  Per reverse step the rows
// of dgates[t+1] (from dxp, which every block wrote before the last
// barrier) stream through from L2 in chunks by cp.async, the next chunk in
// flight while the current one multiplies; each thread accumulates dh_rec
// of its rows and units over its warp's quads of columns (lstm_grid.cuh): 3
// rows x all units (96-row passes, lanes along the rows, chunks of 64
// columns), 3 rows x every fourth unit (24-row passes), or its own unit of
// one or two rows over whole rows of dgates; the warps' partials add in
// warp order where the block computes its units' 4U columns of dgates into
// dxp; one grid.sync() ends the step.  Why: the port's first grid kernel
// staged dgates by 4-byte plain loads between barriers and gave each dot
// product to a warp with two shared loads an FMA: at [80, 96], H = 768, 75%
// of a step in the product and 22% in the staging.  Now the staging of all
// R x 4H dgates of a step into every block (151 MB from L2 a step at the
// GE2E shape) takes the larger share.  Owning the columns instead and
// exchanging each block's partial dh_rec of every unit through L2 (half the
// bytes, all to all) was slower on the card: whichever side of the exchange
// is scattered, reads or writes, costs more than the contiguous broadcast of
// dgates.  Shared memory at the GE2E shape: 146,784 B; W_hh's rows stay in
// shared memory wherever they fit beside the chunks (two directions in fp32
// at H = 800 too: 231,072 B), else they are staged with dgates chunk by
// chunk, chosen from the shape.
// dW_hh is lstm_dwhh_kernel's (lstm_dwhh_f32_kernel's in fp32), after the
// walk, as on the cluster walk: the same dxp gives the same dW_hh bits on
// either route.
//
// What bounds them on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense),
// counting each input byte read once and each output byte written once,
// both products at the bf16 rate:
//   lstm_bwd,  B = 2, T = 301, H = 400, bf16: ~12.5 MB and 1.54 GFLOP
//              -> memory-bound, ~3.7 us; launched twice per training step.
//   bilstm_bwd, B = 8 (16 rows), bf16: ~77 MB and 12.3 GFLOP
//              -> memory-bound, ~23 us; launched once per training step.
//   dW_hh alone: ~5.5 MB / 0.77 GFLOP at B = 2 and ~28 MB / 6.2 GFLOP at
//              B = 8 (both directions), memory-bound at ~1.6 and ~8.4 us.
//   H = 800 (split walk), bf16: lstm_bwd B = 2 ~33 MB / 6.2 GFLOP, ~9.8 us;
//              bilstm_bwd B = 8 ~169 MB / 49 GFLOP, ~51 us (memory-bound).
// The real limit of the walk is neither: it is the T = 301 dependent
// steps, each a wait for the partials, the step's elementwise work, a
// small product and one exchange through distributed shared memory (on the
// split walk also one through L2, whose latency a step waits out whole); on
// the grid route each step's staging of all dgates from L2, its CUDA-core
// product and the grid barrier.

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

// ---------------------------------------------------------------------------
// The reverse walk
// ---------------------------------------------------------------------------

constexpr int kWalkThreads = 384; // threads of a walk block: 12 warps, up to 168 registers each
// bf16: the W_hh columns a warp multiplies stay in its registers as mma.sync
// A fragments, kMTiles tiles of 16 units by at most kMaxKS k-steps of 16
// owned columns: 4U <= 112 columns (H <= 448) and H <= 12 x 3 x 16 = 576
constexpr int kMTiles = 3;
constexpr int kMaxKS = 7;
constexpr int kPairs = 2;        // (row, unit) pairs of a thread at most

// Launch shape of the walk for B rows a cluster.  q, the columns a block
// owns (4U, zero past its units), is padded to `k_padded`; rows of `ld`
// elements; W_hh columns [h_padded][ld] (T).
//   bf16: W_hh's columns staged once for the register-held fragments;
//         rounded dgates [2][rows_padded = B to whole n8 tiles][ld] (the
//         mma's B operand, two buffers by step parity; ld = k_padded + 8, at
//         least 7 k-steps, so that the 32-bit loads of a fragment meet no
//         bank conflict).
//   fp32: W_hh's columns read every step (ld an odd number of 16-byte
//         units: the 16-byte loads of consecutive rows meet no bank
//         conflict); rounded dgates [2][k_padded][rows_padded = B to the row
//         chunk].
// Both: receive slots [2][C][B][U4] and the partials to send [C][B][U4]
// (fp32, U4 = U to whole 16 bytes), and two mbarriers.
struct WalkShape {
  int units, rows_chunk, rows_padded, k_padded, ld, h_padded;
  size_t smem;
};

template <typename T>
WalkShape walk_shape(int B, int H) {
  constexpr bool kTensorCore = sizeof(T) == 2;
  WalkShape w;
  w.units = (H + kCluster - 1) / kCluster;
  const int u4 = (w.units + 3) / 4 * 4;
  const size_t tail = size_t(3) * kCluster * B * u4 * sizeof(float) + 16;
  size_t dg;
  if (kTensorCore) {
    w.h_padded = (H + 15) / 16 * 16;  // whole m16 tiles of units
    w.rows_chunk = 8;
    w.rows_padded = (B + 7) / 8 * 8;
    w.k_padded = (4 * w.units + 15) / 16 * 16;
    // every k-step of the register-held fragments reads inside a row
    w.ld = (w.k_padded > 16 * kMaxKS ? w.k_padded : 16 * kMaxKS) + 8;
    dg = size_t(2) * w.rows_padded * w.ld * sizeof(T);
  } else {
    w.h_padded = (H + 7) / 8 * 8;
    // rows of the partial product kept in registers at a time
    w.rows_chunk = B >= 5 ? 8 : B >= 3 ? 4 : 2;
    w.rows_padded = (B + w.rows_chunk - 1) / w.rows_chunk * w.rows_chunk;
    w.k_padded = (4 * w.units + 3) / 4 * 4;
    w.ld = w.k_padded + ((w.k_padded / 4) % 2 == 0 ? 4 : 0);
    dg = size_t(2) * w.k_padded * w.rows_padded * sizeof(float);
  }
  w.smem = align16(size_t(w.h_padded) * w.ld * sizeof(T)) + align16(dg) + tail;
  return w;
}

// Whether the walk's registers cover this shape (shared memory aside).
template <typename T>
bool walk_fits(const WalkShape& w, int B, int H) {
  if (B * w.units > kPairs * kWalkThreads) return false;
  if (sizeof(T) == 2) {
    return (H + 15) / 16 <= kMTiles * (kWalkThreads / 32) && w.k_padded / 16 <= kMaxKS;
  }
  return true;
}

// Grid D * G * kCluster blocks in clusters of kCluster; cluster c walks
// row group c % G of direction c / G: the direction's rows [g BC, g BC +
// Br), Br = min(BC, B - g BC).  RC rows of the fp32 partial product at a
// time.
template <typename T, int D, int RC>
__global__ void __launch_bounds__(kWalkThreads, 1)
lstm_bwd_kernel(const T* __restrict__ w0,        // [H, 4H], rows [0, B)
                const T* __restrict__ w1,        // [H, 4H], rows [B, 2B) (D == 2)
                const float* __restrict__ gates, // [T, R, 4H] activated
                const float* __restrict__ cs,    // [T, R, H]
                const float* __restrict__ c0,    // [R, H] or null (zero state)
                const float* __restrict__ dhs,   // [T, R, H]
                const float* __restrict__ dhf,   // [R, H] or null (zero)
                const float* __restrict__ dcf,   // [R, H] or null (zero)
                T* __restrict__ dxp,             // [T, R, 4H]
                float* __restrict__ dh0,         // [R, H] or null
                float* __restrict__ dc0,         // [R, H] or null
                int T_, int B, int H, int G, int BC, int U, int RP, int KP, int LD, int HP) {
  constexpr bool kTensorCore = sizeof(T) == 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = int(cluster.block_rank());
  const int c_id = int(blockIdx.x) / kCluster;
  const int d = c_id / G;
  const int row0 = d * B + (c_id % G) * BC;  // the cluster's first row in the arrays
  const int Br = min(BC, B - (c_id % G) * BC);  // and its rows
  const int R = D * B;           // rows of the arrays, all directions
  const int G4 = 4 * H;          // gate columns of one row
  const int NQ = 4 * U;          // columns a block owns (zero past its units)
  const int u0 = k * U;
  const int Uk = max(0, min(U, H - u0));  // units this block owns
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = nt >> 5;
  const int gr = lane >> 2, tig = lane & 3;
  const T* __restrict__ W = d ? w1 : w0;
  const int U4 = (U + 3) / 4 * 4;      // a row of a block's units, in whole 16 bytes
  const int slot = kCluster * Br * U4;  // floats of one receive slot [C][Br][U4]
  // Blocks [0, senders) own units.  The others hold only zero columns: they
  // send nothing, receive nothing and skip the walk.  A block receives the
  // partials of its units from every sender each step.
  const int senders = (H + U - 1) / U;
  const uint32_t slot_bytes = Uk > 0 ? uint32_t(senders * Br * U4) * 4 : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // W_hh columns w_s [HP][LD] (T: bf16 only until its fragments are in
  // registers); rounded dgates, bf16 dg_a [2][RP][LD] (T), fp32 dg_s
  // [2][KP][RP]; the receive slots [2][C][Br][U4], the partials to send
  // [C][Br][U4] and two mbarriers
  const int dg_stride = kTensorCore ? RP * LD : KP * RP;  // elements of one dgates buffer
  T* w_s = reinterpret_cast<T*>(smem_raw);
  unsigned char* dg_raw = smem_raw + align16(size_t(HP) * LD * sizeof(T));
  T* dg_a = reinterpret_cast<T*>(dg_raw);
  float* dg_s = reinterpret_cast<float*>(dg_raw);
  const size_t dg_bytes = size_t(2) * dg_stride * (kTensorCore ? sizeof(T) : sizeof(float));
  float* recv = reinterpret_cast<float*>(dg_raw + align16(dg_bytes));
  float* stage = recv + 2 * slot;  // this step's partials by owner [C][Br][U4]
  uint64_t* bars = reinterpret_cast<uint64_t*>(stage + slot);
  for (int e = tid; e < int(dg_bytes / 4); e += nt) reinterpret_cast<float*>(dg_raw)[e] = 0.0f;
  // W_hh[j, column of owned q] at [j][q]
  stage_owned_columns(w_s, HP, LD, W, H, U, u0, Uk, [](int a, int b, int& j, int& q) {
    j = a;
    q = b;
  });
  if (tid == 0) {
    bar_init(bars);
    bar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // slot s & 1 receives step s's partials: arm the first two steps
    bar_expect(bars + ((T_ - 1) & 1), slot_bytes);
    if (T_ >= 2) bar_expect(bars + ((T_ - 2) & 1), slot_bytes);
  }
  __syncthreads();

  // bf16: warp w multiplies the 16-unit tiles w, w + warps, ...; their W_hh
  // columns as A fragments (ldmatrix from w_s, once), and the owner and
  // place of each of its units, owner << 16 | place (-1: none)
  uint32_t wa[kMTiles][kMaxKS][4];
  int to[kMTiles][2];
  bool tile_on[kMTiles];  // warp-uniform: mma.sync needs the whole warp
  if constexpr (kTensorCore) {
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      const int m0 = (warp + mt * warps) * 16;
      tile_on[mt] = m0 < H;
#pragma unroll
      for (int ks = 0; ks < kMaxKS; ++ks) {
        // zeros for a tile past H (and, from w_s, for k-steps past 4U): the
        // walk multiplies every tile and k-step without a branch
        wa[mt][ks][0] = wa[mt][ks][1] = wa[mt][ks][2] = wa[mt][ks][3] = 0u;
        if (tile_on[mt]) ldmatrix_x4(wa[mt][ks], w_s + (m0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = m0 + gr + h * 8;
        to[mt][h] = j < H ? (j / U) << 16 | (j % U) : -1;
      }
    }
  }

  // this thread's (row, unit) pairs e = tid + p nt, r << 16 | u (-1: none),
  // and their registers
  int ru[kPairs];
  float gi[kPairs], gf[kPairs], gg[kPairs], go[kPairs], cp[kPairs], dd[kPairs], dc[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int e = tid + p * nt, r = e / U, u = e % U;
    ru[p] = e < Br * U && u < Uk ? r << 16 | u : -1;
    dc[p] = (ru[p] >= 0 && dcf != nullptr) ? dcf[size_t(row0 + r) * H + u0 + u] : 0.0f;
  }
  // step s's inputs of the pairs, none of which depends on the recurrence
  auto prefetch = [&](int s) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (ru[p] < 0) continue;
      const int r = ru[p] >> 16, j = u0 + (ru[p] & 0xffff);
      const size_t row = size_t(s) * R + row0 + r;
      const float* gt = gates + row * G4;
      gi[p] = gt[j];
      gf[p] = gt[H + j];
      gg[p] = gt[2 * H + j];
      go[p] = gt[3 * H + j];
      if (s > 0) {
        cp[p] = cs[(row - R) * H + j];
      } else {
        cp[p] = c0 != nullptr ? c0[size_t(row0 + r) * H + j] : 0.0f;
      }
      dd[p] = dhs[row * H + j];
    }
  };
  prefetch(T_ - 1);
  cluster.sync();  // every block runs, with its barriers armed and W_hh set up

  uint32_t parity = 0;  // bit x: parity of slot x's phase to wait for
  for (int s = Uk > 0 ? T_ - 1 : -1; s >= 0; --s) {
    const int in_slot = (s + 1) & 1;  // step s+1's partials
    if (s < T_ - 1) {
      bar_wait(bars + in_slot, (parity >> in_slot) & 1);
      parity ^= 1u << in_slot;
      // the slot's next phase receives step s-1's partials
      if (tid == 0 && s >= 1) bar_expect(bars + in_slot, slot_bytes);
    }
    const float* in = recv + in_slot * slot;
    T* dga = dg_a + (s & 1) * dg_stride;
    float* dgs = dg_s + (s & 1) * dg_stride;
    // 1, 2: own columns of dgates[s]
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (ru[p] < 0) continue;
      const int r = ru[p] >> 16, u = ru[p] & 0xffff, j = u0 + u;
      float rec = 0.0f;
      if (s == T_ - 1) {
        if (dhf != nullptr) rec = dhf[size_t(row0 + r) * H + j];
      } else {
        // the partials of (r, u), one a sender, added in rank order
        for (int m = 0; m < senders; ++m) rec += in[(m * Br + r) * U4 + u];
      }
      const float i = gi[p], f = gf[p], g = gg[p], o = go[p], c_prev = cp[p];
      const float dh = dd[p] + rec;
      const float tc = tanhf(f * c_prev + i * g);
      const float dout = dh * tc;
      const float dct = dh * o * (1.0f - tc * tc) + dc[p];
      dc[p] = dct * f;
      const T v[4] = {from_float<T>(dct * g * i * (1.0f - i)),
                      from_float<T>(dct * c_prev * f * (1.0f - f)),
                      from_float<T>(dct * i * (1.0f - g * g)),
                      from_float<T>(dout * o * (1.0f - o))};
      T* dx = dxp + (size_t(s) * R + row0 + r) * G4 + j;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        dx[gate * H] = v[gate];
        if constexpr (kTensorCore) {
          dga[r * LD + gate * U + u] = v[gate];
        } else {
          dgs[(gate * U + u) * RP + r] = to_float(v[gate]);
        }
      }
    }
    // dgates[s] complete; every warp is also past step s+1's product, whose
    // buffer step s-1 writes
    __syncthreads();

    // 3: partial dh_rec of every unit from the owned columns, sent to its
    // owner's slot s & 1 (after step 0 only one direction needs it: dh0)
    if (s > 0 || D == 1) {
      const uint32_t out = uint32_t((s & 1) * slot) * 4;  // the slot, in bytes
      const uint32_t bar_off = uint32_t(s & 1) * 8;
      if constexpr (kTensorCore) {
        // P^T[j, r] = sum_q W[j, q] dg[r, q]: mma.sync.m16n8k16 with A = the
        // W_hh fragments in registers and B = 8 rows of dgates (32-bit
        // loads: [n][k] is the "col" B); the warp's tiles interleave
        for (int r0 = 0; r0 < RP; r0 += 8) {
          // even and odd k-steps in two accumulators, added at the end:
          // two chains of dependent products, not one
          float acc[2][kMTiles][4];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
#pragma unroll
            for (int mt = 0; mt < kMTiles; ++mt) acc[c][mt][0] = acc[c][mt][1] = acc[c][mt][2] = acc[c][mt][3] = 0.0f;
          }
#pragma unroll
          for (int ks = 0; ks < kMaxKS; ++ks) {
            const T* brow = dga + (r0 + gr) * LD + ks * 16 + 2 * tig;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + 8);
#pragma unroll
            for (int mt = 0; mt < kMTiles; ++mt) mma_bf16(acc[ks & 1][mt], wa[mt][ks], b0, b1);
          }
          // acc[.][mt][e]: unit m0 + gr + (e >> 1) 8, row r0 + 2 tig + (e & 1)
          const int r = r0 + 2 * tig;
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int own = to[mt][h];
              if (own < 0 || r >= Br) continue;
              float* st = stage + ((own >> 16) * Br + r) * U4 + (own & 0xffff);
              st[0] = acc[0][mt][2 * h] + acc[1][mt][2 * h];
              if (r + 1 < Br) st[U4] = acc[0][mt][2 * h + 1] + acc[1][mt][2 * h + 1];
            }
          }
        }
      } else {
        // CUDA cores: thread jj, RC rows in registers, 4 columns a load
        for (int jj = tid; jj < H; jj += nt) {
          float* st = stage + (jj / U) * Br * U4 + jj % U;
          const T* wrow = w_s + size_t(jj) * LD;
          for (int r0 = 0; r0 < Br; r0 += RC) {
            float acc[RC];
#pragma unroll
            for (int i = 0; i < RC; ++i) acc[i] = 0.0f;
            for (int q = 0; q < KP; q += 4) {
              const float4 w = *reinterpret_cast<const float4*>(wrow + q);
              const float wv[4] = {to_float(w.x), to_float(w.y), to_float(w.z), to_float(w.w)};
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float* gq = dgs + (q + c) * RP + r0;
                float gv[RC];
                if constexpr (RC == 2) {
                  const float2 a = *reinterpret_cast<const float2*>(gq);
                  gv[0] = a.x;
                  gv[1] = a.y;
                } else {
#pragma unroll
                  for (int i = 0; i < RC; i += 4) {
                    const float4 a = *reinterpret_cast<const float4*>(gq + i);
                    gv[i] = a.x;
                    gv[i + 1] = a.y;
                    gv[i + 2] = a.z;
                    gv[i + 3] = a.w;
                  }
                }
#pragma unroll
                for (int i = 0; i < RC; ++i) acc[i] = fmaf(gv[i], wv[c], acc[i]);
              }
            }
#pragma unroll
            for (int i = 0; i < RC; ++i) {
              if (r0 + i < Br) st[(r0 + i) * U4] = acc[i];
            }
          }
        }
      }
      // every owner's rows [Br][U4] go out as 16-byte pieces
      __syncthreads();
      const int pieces = Br * U4 / 4;  // of one owner
      for (int e = tid; e < senders * pieces; e += nt) {
        const int m = e / pieces, c = e % pieces;
        const float4 v = *reinterpret_cast<const float4*>(stage + m * Br * U4 + c * 4);
        send4(cluster_addr(recv + k * Br * U4 + c * 4, m) + out, v, cluster_addr(bars, m) + bar_off);
      }
    }
    // 4: the next step's inputs load while the partials travel
    if (s > 0) prefetch(s - 1);
  }

  if (D == 1 && Uk > 0) {
    bar_wait(bars, parity & 1);  // step 0's partials, in slot 0
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (ru[p] < 0) continue;
      const int r = ru[p] >> 16, u = ru[p] & 0xffff;
      float rec = 0.0f;
      for (int m = 0; m < senders; ++m) rec += recv[(m * Br + r) * U4 + u];
      dh0[size_t(row0 + r) * H + u0 + u] = rec;
      dc0[size_t(row0 + r) * H + u0 + u] = dc[p];
    }
  }
  cluster.sync();  // no block leaves while a peer may still write to it
}

// ---------------------------------------------------------------------------
// dW_hh after the walk
// ---------------------------------------------------------------------------

constexpr int kDwTile = 64;   // units j and gate columns q of a block's dW tile
constexpr int kDwK = 64;      // rows (t, r) staged per chunk
template <typename T> struct DwLd {  // tile row stride in shared memory: + 16 bytes
  static constexpr int value = kDwTile + 16 / int(sizeof(T));
};

// dW_d[j, q] = sum over k = (t, r) of round(h_prev[t, r, j]) * dxp[t, r, q]
// for the B rows r of direction d = blockIdx.z, bf16 operands on mma.sync;
// grid (ceil(H/64), ceil(4H/64), D).  A thread stages 16-byte pieces of a
// chunk: 4 units of h (fp32) and 16 bytes of dxp, whole vectors when kVec
// (H a multiple of 4 and 16-byte aligned rows), else element by element.
// Each piece's row k is kept as (t, r) and moves by kDwK rows a chunk, so
// the walk over K divides nothing.  fp32 operands: lstm_dwhh_f32_kernel.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
lstm_dwhh_kernel(const float* __restrict__ hs,  // [T, R, H]
                 const float* __restrict__ h0,  // [R, H] or null (zero state)
                 const T* __restrict__ dxp,     // [T, R, 4H]
                 float* __restrict__ dw0,       // [H, 4H], rows [0, B)
                 float* __restrict__ dw1,       // [H, 4H], rows [B, 2B) (D == 2)
                 int T_, int B, int D, int H) {
  static_assert(sizeof(T) == 2, "bf16 operands");
  constexpr int LD = DwLd<T>::value;
  constexpr int DV = 16 / int(sizeof(T));                       // dxp elements a piece
  constexpr int kHPer = kDwK * kDwTile / 4 / kThreads;          // h pieces a thread: 4
  constexpr int kDPer = kDwK * kDwTile / DV / kThreads;         // dxp pieces: 2
  constexpr int kHRows = kThreads / (kDwTile / 4), kDRows = kThreads / (kDwTile / DV);
  __shared__ __align__(16) T h_s[kDwK * LD];  // round(h_prev)[k][j]
  __shared__ __align__(16) T d_s[kDwK * LD];  // dgates[k][q]
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * kDwTile, q0 = blockIdx.y * kDwTile;
  const int R = D * B, G4 = 4 * H, K = T_ * B;
  const int tid = threadIdx.x;
  const int hc = (tid % (kDwTile / 4)) * 4, dcol = (tid % (kDwTile / DV)) * DV;

  // rows (t, r) of the pieces, and how far a chunk moves them
  int ht[kHPer], hr[kHPer], dt[kDPer], dr[kDPer];
#pragma unroll
  for (int i = 0; i < kHPer; ++i) {
    const int k = tid / (kDwTile / 4) + i * kHRows;
    ht[i] = k / B;
    hr[i] = k % B;
  }
#pragma unroll
  for (int i = 0; i < kDPer; ++i) {
    const int k = tid / (kDwTile / DV) + i * kDRows;
    dt[i] = k / B;
    dr[i] = k % B;
  }
  const int move_t = kDwK / B, move_r = kDwK % B;
  auto advance = [&](int& t, int& r) {
    t += move_t;
    r += move_r;
    if (r >= B) {
      r -= B;
      ++t;
    }
  };

  float hv[kHPer][4];
  uint4 dv[kDPer];
  // the pieces of the current rows into registers; zeros outside
  auto fetch = [&]() {
#pragma unroll
    for (int i = 0; i < kHPer; ++i) {
      const float* src = nullptr;
      if (ht[i] < T_) {
        if (ht[i] > 0) {
          src = hs + (size_t(ht[i] - 1) * R + d * B + hr[i]) * H;
        } else if (h0 != nullptr) {
          src = h0 + size_t(d * B + hr[i]) * H;
        }
      }
      const int j = j0 + hc;
      if constexpr (kVec) {
        const float4 v = (src != nullptr && j < H) ? *reinterpret_cast<const float4*>(src + j)
                                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        hv[i][0] = v.x;
        hv[i][1] = v.y;
        hv[i][2] = v.z;
        hv[i][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[i][e] = (src != nullptr && j + e < H) ? src[j + e] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < kDPer; ++i) {
      const T* src = dt[i] < T_ ? dxp + (size_t(dt[i]) * R + d * B + dr[i]) * G4 : nullptr;
      const int q = q0 + dcol;
      if constexpr (kVec) {
        dv[i] = (src != nullptr && q < G4) ? *reinterpret_cast<const uint4*>(src + q)
                                           : make_uint4(0u, 0u, 0u, 0u);
      } else {
        __align__(16) T tmp[DV];
#pragma unroll
        for (int e = 0; e < DV; ++e) tmp[e] = (src != nullptr && q + e < G4) ? src[q + e] : from_float<T>(0.0f);
        dv[i] = *reinterpret_cast<const uint4*>(tmp);
      }
    }
  };

  // warp (wm, wn) owns units [16 wm, +16) x columns [32 wn, +32):
  // acc[n8 tile][4]
  float acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;

  fetch();
  for (int k0 = 0; k0 < K; k0 += kDwK) {
    __syncthreads();  // everyone is done with the previous chunk
#pragma unroll
    for (int i = 0; i < kHPer; ++i) {
      T* dst = h_s + (tid / (kDwTile / 4) + i * kHRows) * LD + hc;
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = from_float<T>(hv[i][e]);
    }
#pragma unroll
    for (int i = 0; i < kDPer; ++i) {
      *reinterpret_cast<uint4*>(d_s + (tid / (kDwTile / DV) + i * kDRows) * LD + dcol) = dv[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kHPer; ++i) advance(ht[i], hr[i]);
#pragma unroll
    for (int i = 0; i < kDPer; ++i) advance(dt[i], dr[i]);
    if (k0 + kDwK < K) fetch();  // in flight while this chunk multiplies
#pragma unroll
    for (int ks = 0; ks < kDwK / 16; ++ks) {
      uint32_t bf[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldmatrix_x4_trans(bf[np], d_s + (ks * 16 + (lane & 15)) * LD + wn * 32 + np * 16 +
                                      (lane >> 4) * 8);
      }
      // A[m = unit][k = row] from h_s[row][unit]
      uint32_t a[4];
      ldmatrix_x4_trans(a, h_s + (ks * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LD + wm * 16 +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_bf16(acc[nt], a, bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
  }

  float* dw = d ? dw1 : dw0;
  const int gr = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int q = q0 + wn * 32 + nt * 8 + 2 * tig;  // even, and 4H is even: q + 1 < 4H too
    const int j = j0 + wm * 16 + gr;
    if (q >= G4) continue;
    if (j < H) *reinterpret_cast<float2*>(dw + size_t(j) * G4 + q) = make_float2(acc[nt][0], acc[nt][1]);
    if (j + 8 < H) {
      *reinterpret_cast<float2*>(dw + size_t(j + 8) * G4 + q) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// dW_hh in fp32: the same product on CUDA cores (TF32 would round the
// operands), as a register-tiled GEMM.  Block tiles of 96 units x 128 gate
// columns (192 blocks a direction at the GE2E encoder's H = 768), 128 threads
// (8 along the units, 16 along the columns) of 12 x 8 outputs each: units
// tm 4 + 32 i + {0..3} (i < 3), columns tn 4 + 64 i + {0..3} (i < 2).  K =
// T B rows (t, r) walked in chunks of 16, a ring of three, two in flight by
// cp.async while one multiplies (kVec: H a multiple of 4 and 16-byte aligned
// rows; else plain loads), k-major tiles [16][96 + 4] and [16][128 + 4]: a
// thread's five 128-bit loads a row of K feed its 96 FMAs.  Tiles of 64 x
// 128, 64 x 192, 128 x 128 and 96 x 192 measured slower on the card.  Each
// output adds its K rows in increasing (t, r) order.
constexpr int kDwfTMI = 3, kDwfTNI = 2;  // float4 groups of units and of columns a thread
constexpr int kDwfK = 16, kDwfThreads = 128, kDwfStages = 3;
constexpr int kDwfM = 32 * kDwfTMI, kDwfN = 64 * kDwfTNI;  // a block's tile: 96 x 128
constexpr size_t kDwfSmem = size_t(kDwfStages) * kDwfK * (kDwfM + 4 + kDwfN + 4) * sizeof(float);

template <bool kVec>
__global__ void __launch_bounds__(kDwfThreads)
lstm_dwhh_f32_kernel(const float* __restrict__ hs,   // [T, R, H]
                     const float* __restrict__ h0,   // [R, H] or null (zero state)
                     const float* __restrict__ dxp,  // [T, R, 4H]
                     float* __restrict__ dw0,        // [H, 4H], rows [0, B)
                     float* __restrict__ dw1,        // [H, 4H], rows [B, 2B) (D == 2)
                     int T_, int B, int D, int H) {
  constexpr int TMI = kDwfTMI, TNI = kDwfTNI, M = kDwfM, N = kDwfN, LDA = M + 4, LDB = N + 4;
  static_assert(kDwfK * M / 4 % kDwfThreads == 0 && kDwfK * N / 4 % kDwfThreads == 0, "whole pieces a thread");
  extern __shared__ __align__(16) float dwf_raw[];
  float* a_s = dwf_raw;                              // [kDwfStages][kDwfK][LDA]: h_prev[k][j]
  float* b_s = dwf_raw + kDwfStages * kDwfK * LDA;   // [kDwfStages][kDwfK][LDB]: dxp[k][q]
  const int d = blockIdx.z, j0 = blockIdx.x * M, q0 = blockIdx.y * N;
  const int R = D * B, G4 = 4 * H, K = T_ * B;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;

  // rows [k0, k0 + 16) into ring place buf, in 16-byte pieces (zeros past
  // K, H and 4H, and for the zero state); one group of copies, empty past K
  auto piece = [&](float* dst, const float* src, int x0, int n) {
    if constexpr (kVec) {
      const bool in = src != nullptr && x0 < n;
      cp_async16(dst, in ? src + x0 : hs, in ? 16 : 0);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) dst[x] = src != nullptr && x0 + x < n ? src[x0 + x] : 0.0f;
    }
  };
  auto stage = [&](int k0, int buf) {
    if (k0 >= K) {
      cp_async_commit();
      return;
    }
#pragma unroll
    for (int i = 0; i < kDwfK * M / 4 / kDwfThreads; ++i) {  // h
      const int e = tid + i * kDwfThreads, kk = e / (M / 4), c = e % (M / 4) * 4;
      const int k = k0 + kk, t = k / B, r = k % B;
      const float* src = nullptr;
      if (k < K && t > 0) {
        src = hs + (size_t(t - 1) * R + d * B + r) * H;
      } else if (k < K && h0 != nullptr) {
        src = h0 + size_t(d * B + r) * H;
      }
      piece(a_s + (buf * kDwfK + kk) * LDA + c, src, j0 + c, H);
    }
#pragma unroll
    for (int i = 0; i < kDwfK * N / 4 / kDwfThreads; ++i) {  // dxp
      const int e = tid + i * kDwfThreads, kk = e / (N / 4), c = e % (N / 4) * 4;
      const int k = k0 + kk;
      const float* src = k < K ? dxp + (size_t(k / B) * R + d * B + k % B) * G4 : nullptr;
      piece(b_s + (buf * kDwfK + kk) * LDB + c, src, q0 + c, G4);
    }
    cp_async_commit();
  };

  float acc[4 * TMI][4 * TNI];
#pragma unroll
  for (int m = 0; m < 4 * TMI; ++m) {
#pragma unroll
    for (int n = 0; n < 4 * TNI; ++n) acc[m][n] = 0.0f;
  }
  const int chunks = (K + kDwfK - 1) / kDwfK;
  for (int c = 0; c < kDwfStages - 1; ++c) stage(c * kDwfK, c);
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kDwfStages - 2>();
    __syncthreads();  // chunk ch staged; every thread is done with chunk ch - 1
    stage((ch + kDwfStages - 1) * kDwfK, (ch + kDwfStages - 1) % kDwfStages);
    const float* at = a_s + ch % kDwfStages * kDwfK * LDA + tm * 4;
    const float* bt = b_s + ch % kDwfStages * kDwfK * LDB + tn * 4;
#pragma unroll
    for (int kk = 0; kk < kDwfK; ++kk) {
      float a[4 * TMI], b[4 * TNI];
#pragma unroll
      for (int i = 0; i < TMI; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(at + kk * LDA + 32 * i);
        a[4 * i] = v.x, a[4 * i + 1] = v.y, a[4 * i + 2] = v.z, a[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TNI; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(bt + kk * LDB + 64 * i);
        b[4 * i] = v.x, b[4 * i + 1] = v.y, b[4 * i + 2] = v.z, b[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < 4 * TMI; ++m) {
#pragma unroll
        for (int n = 0; n < 4 * TNI; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
      }
    }
  }

  float* dw = d ? dw1 : dw0;
#pragma unroll
  for (int m = 0; m < 4 * TMI; ++m) {
    const int j = j0 + tm * 4 + 32 * (m / 4) + m % 4;
    if (j >= H) continue;
#pragma unroll
    for (int i = 0; i < TNI; ++i) {
      const int q = q0 + tn * 4 + 64 * i;  // 4H is a multiple of 4: a piece is all in or all out
      if (q < G4) {
        *reinterpret_cast<float4*>(dw + size_t(j) * G4 + q) =
            make_float4(acc[m][4 * i], acc[m][4 * i + 1], acc[m][4 * i + 2], acc[m][4 * i + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The split walk
// ---------------------------------------------------------------------------

constexpr int kBwdWarpGroups = kWalkThreads / 128;
// 64-unit tiles of the product a warpgroup multiplies: tiles wg + 3 c, c <
// kBwdTileSlots (15 slots for the 13 tiles of H = 800; a slot past the last
// tile multiplies and drops its result, so that no wgmma sits on a branch),
// the first kBwdRegTiles of them from registers (all 8 k-steps: 32
// registers; two spilled 128 bytes a thread), the others from shared memory
constexpr int kBwdTileSlots = 5;
constexpr int kBwdRegTiles = 1;
constexpr int kBwdSplitMaxRows = 8;  // rows a pair holds (one 8-row tile)
constexpr int kSplitPairs = 1;       // (row, unit) pairs of a thread: 8 x 32 <= 384

// Launch shape of the backward split walk for `rows` rows a pair (bf16):
// `owners` blocks of kSplitUnits units, `first` of them in the pair's first
// cluster; `mtiles` 64-unit tiles of the product (units past H zero).
// Shared memory: W_hh's columns of the shared-memory tiles as swizzled
// atoms (lstm_cluster.cuh) [mtiles - 3 kBwdRegTiles][2 atoms of 4 k-steps]
// (1024-byte aligned), this step's dgates as the product's B operand
// [8][128] (bf16, core matrices), receive slots [2][owners][8][32] (fp32;
// step s stages the partials it sends in slot (s + 1) & 1, which it has
// read and no block writes before it has sent them), four mbarriers.  Exchange
// memory: two counters a pair, then a pair's global slots [2][receiver
// owner][sender owner][8][32] (fp32).
struct BwdSplitShape {
  int owners, first, mtiles;
  size_t smem, pair_bytes;
};

BwdSplitShape bwd_split_shape(int H) {
  BwdSplitShape s;
  s.owners = (H + kSplitUnits - 1) / kSplitUnits;
  s.first = (s.owners + 1) / 2;
  s.mtiles = (H + 63) / 64;
  const int smem_tiles = s.mtiles - kBwdWarpGroups * kBwdRegTiles;
  const size_t slot = size_t(s.owners) * kBwdSplitMaxRows * kSplitUnits * 4;
  s.smem = 1024 + size_t(smem_tiles > 0 ? smem_tiles : 0) * 2 * kAtomBytes +
           size_t(kBwdSplitMaxRows) * 4 * kSplitUnits * 2 + 2 * slot + 4 * 8;
  s.pair_bytes = 2 * size_t(s.owners) * slot;
  return s;
}

bool bwd_split_fits(const BwdSplitShape& s, int rows, size_t optin) {
  return rows <= kBwdSplitMaxRows && s.owners >= 2 && s.first <= kCluster &&
         s.mtiles > kBwdWarpGroups * kBwdRegTiles && s.mtiles <= kBwdWarpGroups * kBwdTileSlots &&
         s.smem <= optin;
}

// Grid 2 D G kCluster blocks in clusters of kCluster; clusters 2p and 2p + 1
// walk pair p: row group p % G of direction p / G, the direction's rows
// [g BC, g BC + Br), Br = min(BC, B - g BC).
template <int D>
__global__ void __launch_bounds__(kWalkThreads, 1)
lstm_bwd_split_kernel(const __nv_bfloat16* __restrict__ w0,  // [H, 4H], rows [0, B)
                      const __nv_bfloat16* __restrict__ w1,  // [H, 4H], rows [B, 2B) (D == 2)
                      const float* __restrict__ gates,       // [T, R, 4H] activated
                      const float* __restrict__ cs,          // [T, R, H]
                      const float* __restrict__ c0,          // [R, H] or null (zero state)
                      const float* __restrict__ dhs,         // [T, R, H]
                      const float* __restrict__ dhf,         // [R, H] or null (zero)
                      const float* __restrict__ dcf,         // [R, H] or null (zero)
                      __nv_bfloat16* __restrict__ dxp,       // [T, R, 4H]
                      float* __restrict__ dh0,               // [R, H] or null
                      float* __restrict__ dc0,               // [R, H] or null
                      unsigned int* counters,                // exchange memory: counters zeroed
                      float* xbuf,                           // [pairs][2][NO][NO][8][32]
                      int T_, int B, int H, int G, int BC, int NO, int N0, int MT) {
  using T = __nv_bfloat16;
  constexpr int U = kSplitUnits, NQ = 4 * kSplitUnits, RP = kBwdSplitMaxRows;
  constexpr int KS = NQ / 16;  // k-steps of the product: the owned columns
  cg::cluster_group cluster = cg::this_cluster();
  const int k = int(cluster.block_rank());
  const int c_id = int(blockIdx.x) / kCluster;
  const int pair = c_id / 2, half = c_id % 2;
  const int d = pair / G, grp = pair % G;
  const int row0 = d * B + grp * BC;
  const int Br = min(BC, B - grp * BC);
  const int R = D * B;
  const int G4 = 4 * H;
  const int n_mine = half ? NO - N0 : N0, n_other = half ? N0 : NO - N0;
  const int base_mine = half ? N0 : 0, base_other = half ? 0 : N0;
  const int m = k < n_mine ? base_mine + k : -1;  // owner index (-1: none)
  const int u0 = max(m, 0) * U;
  const int Uk = m < 0 ? 0 : max(0, min(U, H - u0));
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;
  const T* __restrict__ W = d ? w1 : w0;
  const int part = RP * U;           // floats of one sender's partials in a slot
  const int slot = NO * part;        // floats of one receive slot [NO][RP][U]
  unsigned int* my_count = counters + (2 * pair + half) * kCounterStride;
  const unsigned int* other_count = counters + (2 * pair + 1 - half) * kCounterStride;
  float* xb = xbuf + size_t(pair) * 2 * NO * slot;  // the pair's global slots [2][receiver][slot]
  const uint32_t local_bytes = uint32_t(n_mine * Br * U) * 4;
  const uint32_t remote_bytes = uint32_t(n_other * part) * 4;
  const int smem_tiles = MT - kBwdWarpGroups * kBwdRegTiles;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* a_s = smem_raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023)) & 1023);
  T* dgb = reinterpret_cast<T*>(a_s + size_t(smem_tiles) * 2 * kAtomBytes);  // [RP][NQ] core matrices
  float* recv = reinterpret_cast<float*>(dgb + RP * NQ);  // [2][NO][RP][U]
  uint64_t* bars = reinterpret_cast<uint64_t*>(recv + 2 * slot);  // local [2], remote [2]
  // A[j][q] = W_hh[j, g H + u0 + u] for owned column q = g U + u (zero past
  // H and past the block's units)
  auto w_at = [&](int j, int q) -> unsigned short {
    const int u = q % U;
    return j < H && u < Uk ? __bfloat16_as_ushort(W[size_t(j) * G4 + (q / U) * H + u0 + u]) : 0;
  };
  if (m >= 0) {
    for (int e = tid; e < RP * NQ; e += nt) dgb[e] = from_float<T>(0.0f);
    // tiles 3 kBwdRegTiles + st: two atoms of 4 k-steps each
    for (int e = tid; e < smem_tiles * 2 * 4096; e += nt) {
      const int atom = e >> 12, o = e & 4095;
      const int jj = o >> 6, c = o & 63;
      const int j = (kBwdWarpGroups * kBwdRegTiles + atom / 2) * 64 + jj, q = (atom % 2) * 64 + c;
      *reinterpret_cast<unsigned short*>(a_s + atom * kAtomBytes + sw128_at(jj, c)) = w_at(j, q);
    }
  }
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // local slot s & 1 receives step s's partials: arm the first two
    if (m >= 0) bar_expect(bars + ((T_ - 1) & 1), local_bytes);
    if (m >= 0 && T_ >= 2) bar_expect(bars + ((T_ - 2) & 1), local_bytes);
  }

  // the register tiles wg + 3 c, c < kBwdRegTiles, all k-steps, as A
  // fragments: this warp's 16 units of each
  uint32_t wa[kBwdRegTiles][KS][4];
#pragma unroll
  for (int c = 0; c < kBwdRegTiles; ++c) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int j = (wg + kBwdWarpGroups * c) * 64 + wq * 16 + gr + (rr & 1) * 8;
        const int q = ks * 16 + 2 * tig + (rr >> 1) * 8;
        wa[c][ks][rr] = uint32_t(w_at(j, q)) | (uint32_t(w_at(j, q + 1)) << 16);
      }
    }
  }
  // the shared-memory tile slots' atoms, formed at each use from one
  // address (a slot past the last tile reads the last tile's and drops the
  // result; descriptors held in registers spilled)
  const uint32_t a_addr = static_cast<uint32_t>(__cvta_generic_to_shared(a_s));
  const uint64_t dg_desc = b_desc(dgb);

  // this thread's (row, unit) pair e = tid (at most 8 rows x 32 units, one
  // a thread), r << 16 | u (-1: none), and its registers
  int ru[kSplitPairs];
  float gi[kSplitPairs], gf[kSplitPairs], gg[kSplitPairs], go[kSplitPairs], cp[kSplitPairs], dd[kSplitPairs], dc[kSplitPairs];
#pragma unroll
  for (int p = 0; p < kSplitPairs; ++p) {
    const int e = tid + p * nt, r = e / U, u = e % U;
    ru[p] = e < Br * U && u < Uk ? r << 16 | u : -1;
    dc[p] = (ru[p] >= 0 && dcf != nullptr) ? dcf[size_t(row0 + r) * H + u0 + u] : 0.0f;
  }
  auto prefetch = [&](int s) {
#pragma unroll
    for (int p = 0; p < kSplitPairs; ++p) {
      if (ru[p] < 0) continue;
      const int r = ru[p] >> 16, j = u0 + (ru[p] & 0xffff);
      const size_t row = size_t(s) * R + row0 + r;
      const float* gt = gates + row * G4;
      gi[p] = gt[j];
      gf[p] = gt[H + j];
      gg[p] = gt[2 * H + j];
      go[p] = gt[3 * H + j];
      if (s > 0) {
        cp[p] = cs[(row - R) * H + j];
      } else {
        cp[p] = c0 != nullptr ? c0[size_t(row0 + r) * H + j] : 0.0f;
      }
      dd[p] = dhs[row * H + j];
    }
  };
  prefetch(T_ - 1);
  fence_proxy_async();  // a_s and dgb written here; wgmma reads them through the async proxy
  cluster.sync();  // every block runs, with its barriers armed

  uint32_t parity = 0;  // bit x: parity of barrier x's phase to wait for
  // the partials of step `s` in slot s & 1: this cluster's by st.async,
  // the other cluster's by one bulk copy once its owners have counted s's
  auto receive = [&](int s) {
    const int sl = s & 1;
    bar_wait(bars + sl, (parity >> sl) & 1);
    parity ^= 1u << sl;
    // the slot's next phase receives step s - 2's partials
    if (tid == 0 && s >= 2) bar_expect(bars + sl, local_bytes);
    const int rb = 2 + sl;
    if (tid == 0) {
      counter_wait(other_count, uint32_t(T_ - s) * uint32_t(n_other));
      bar_expect(bars + rb, remote_bytes);
      const size_t off = size_t(base_other) * part;
      bulk_copy_g2s(recv + sl * slot + off, xb + (size_t(sl) * NO + m) * slot + off, remote_bytes, bars + rb);
    }
    bar_wait(bars + rb, (parity >> rb) & 1);
    parity ^= 1u << rb;
    return recv + sl * slot;
  };
  for (int s = m >= 0 ? T_ - 1 : -1; s >= 0; --s) {
    const float* in = s < T_ - 1 ? receive(s + 1) : nullptr;
    // 1, 2: own columns of dgates[s]
#pragma unroll
    for (int p = 0; p < kSplitPairs; ++p) {
      if (ru[p] < 0) continue;
      const int r = ru[p] >> 16, u = ru[p] & 0xffff, j = u0 + u;
      float rec = 0.0f;
      if (s == T_ - 1) {
        if (dhf != nullptr) rec = dhf[size_t(row0 + r) * H + j];
      } else {
        // the partials of (r, u), one a sender, added in rank order
        for (int x = 0; x < NO; ++x) rec += in[x * part + r * U + u];
      }
      const float i = gi[p], f = gf[p], g = gg[p], o = go[p], c_prev = cp[p];
      const float dh = dd[p] + rec;
      const float tc = tanhf(f * c_prev + i * g);
      const float dout = dh * tc;
      const float dct = dh * o * (1.0f - tc * tc) + dc[p];
      dc[p] = dct * f;
      const T v[4] = {from_float<T>(dct * g * i * (1.0f - i)),
                      from_float<T>(dct * c_prev * f * (1.0f - f)),
                      from_float<T>(dct * i * (1.0f - g * g)),
                      from_float<T>(dout * o * (1.0f - o))};
      T* dx = dxp + (size_t(s) * R + row0 + r) * G4 + j;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        dx[gate * H] = v[gate];
        const int q = gate * U + u;
        dgb[(q >> 3) * 64 + r * 8 + (q & 7)] = v[gate];  // core matrices [q / 8][r][q % 8]
      }
    }
    fence_proxy_async();  // dgb written here; wgmma reads it through the async proxy
    __syncthreads();      // dgates[s] complete; every read of the slot is done
    // 3: P[j, r] = sum_q W[j, q] round(dgates[r, q]) for every unit j:
    // wgmma, A = W_hh's columns (registers, then shared memory), B = the 8
    // rows of dgates; the tile slots in order
    float acc[kBwdTileSlots][4];
#pragma unroll
    for (int c = 0; c < kBwdTileSlots; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t db = dg_desc + uint64_t(ks * 16);  // core matrices of k-step ks: 256 bytes on
#pragma unroll
      for (int c = 0; c < kBwdTileSlots; ++c) {
        if (c < kBwdRegTiles) {
          wgmma_m64n8k16(acc[c], wa[c < kBwdRegTiles ? c : 0][ks], db, 1);
        } else {
          const int tile = min(wg + kBwdWarpGroups * c, MT - 1) - kBwdWarpGroups * kBwdRegTiles;
          const uint64_t da = a_desc_at(a_addr + uint32_t(tile * 2 * kAtomBytes + (ks / 4) * kAtomBytes +
                                                          (ks % 4) * 32));
          wgmma_m64n8k16_ss(acc[c], da, db);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    // acc[c][e]: unit (wg + 3 c) 64 + wq 16 + gr + (e >> 1) 8, row 2 tig + (e & 1);
    // staged by owner [j / 32][r][j % 32] in the slot this step has read
    float* stage = recv + ((s + 1) & 1) * slot;
#pragma unroll
    for (int c = 0; c < kBwdTileSlots; ++c) {
      const int tile = wg + kBwdWarpGroups * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = tile * 64 + wq * 16 + gr + h * 8, r = 2 * tig;
        if (tile >= MT || j >= H) continue;
        float* st = stage + (j / U) * part + j % U;
        if (r < Br) st[r * U] = acc[c][2 * h];
        if (r + 1 < Br) st[(r + 1) * U] = acc[c][2 * h + 1];
      }
    }
    __syncthreads();  // the partials staged
    // 4: every owner's [Br][32] slice: warps 0-7 to this cluster's owners'
    // slot s & 1 by st.async; warps 8-11 to the other cluster's owners'
    // global slots s & 1, then one count on this cluster's counter.  Step
    // 0's partials give dh0; two directions, which have none, exchange them
    // all the same (a walk that left the loop before spilled 40 bytes a
    // thread)
    {
      constexpr int kPieces = U / 4;  // 16-byte pieces of a row
      const int pieces = Br * kPieces;
      const int sl = s & 1;
      if (warp < 8) {
        const uint32_t bar_off = uint32_t(sl) * 8;
        for (int e = tid; e < n_mine * pieces; e += 256) {
          const int to = e / pieces, pc = e % pieces;
          const int r = pc / kPieces, col = pc % kPieces * 4;
          const int src = (base_mine + to) * part + r * U + col;
          const float4 v = *reinterpret_cast<const float4*>(stage + src);
          send4(cluster_addr(recv + sl * slot + m * part + r * U + col, to), v, cluster_addr(bars, to) + bar_off);
        }
      } else {
        for (int e = tid - 256; e < n_other * pieces; e += 128) {
          const int to = e / pieces, pc = e % pieces;
          const int r = pc / kPieces, col = pc % kPieces * 4;
          const int dst_owner = base_other + to;
          *reinterpret_cast<float4*>(xb + (size_t(sl) * NO + dst_owner) * slot + m * part + r * U + col) =
              *reinterpret_cast<const float4*>(stage + dst_owner * part + r * U + col);
        }
        asm volatile("bar.sync 1, 128;\n" ::: "memory");  // warps 8-11: every write above is done
        if (tid == 256) counter_release_add(my_count);
      }
    }
    // 5: the next step's inputs load while the partials travel
    if (s > 0) prefetch(s - 1);
  }

  if (m >= 0) {
    const float* in = receive(0);  // step 0's partials: dh0 (two directions: none)
#pragma unroll
    for (int p = 0; p < kSplitPairs; ++p) {
      if (ru[p] < 0 || dh0 == nullptr) continue;
      const int r = ru[p] >> 16, u = ru[p] & 0xffff;
      float rec = 0.0f;
      for (int x = 0; x < NO; ++x) rec += in[x * part + r * U + u];
      dh0[size_t(row0 + r) * H + u0 + u] = rec;
      dc0[size_t(row0 + r) * H + u0 + u] = dc[p];
    }
  }
  cluster.sync();  // no block leaves while a peer may still write to it
}

// ---------------------------------------------------------------------------
// The grid route
// ---------------------------------------------------------------------------

// A pass's tile shape: lanes along the rows (32, each thread every unit of
// its rows; 8, four lanes sharing a row's units; or 1, each lane a unit),
// row slots of a lane and bytes of a staged chunk of a dgates row (the
// whole row where a pass has one or two rows).  A launch
// takes the first shape (in this order) whose rows hold a direction's, or a
// later one where that does not fit in shared memory beside W_hh's rows,
// else the same with W_hh staged.
struct GridBwdPass {
  int lr, ri, chunk_bytes;
};
constexpr GridBwdPass kGridBwdPasses[] = {{32, 3, 256}, {32, 2, 256},  {32, 1, 2048},  {32, 1, 256},
                                          {8, 3, 2048}, {8, 1, 3072},  {8, 1, 256},    {1, 2, 13312},
                                          {1, 1, 13312}, {1, 1, 256}};
constexpr int kGridBwdPassCount = int(sizeof(kGridBwdPasses) / sizeof(GridBwdPass));

// Shared memory of the grid route for D directions of B rows, U units a
// block, tile shape `pass` and chunks of kc columns: the block's rows of
// W_hh [D][U][grid_ld(4H)] (T) when `w_shared`, else the chunks of them
// [buffers][kGridUnits][grid_lda(kc)]; the chunks of dgates [buffers]
// [rows_pass][grid_lda(kc)] (T); the warps' partials [kGridWarps]
// [min(rows_pass, B)][min(U, kGridUnits)] and the carried dc [D B][U] (fp32).
template <typename T>
size_t grid_bwd_smem(int D, int B, int H, int U, GridBwdPass pass, bool w_shared) {
  const int kc = pass.chunk_bytes / int(sizeof(T)), rows_pass = pass.lr * pass.ri;
  const size_t bufs = size_t(grid_buffers(4 * H, kc));
  const size_t w = w_shared ? size_t(D) * U * grid_ld(4 * H) : bufs * kGridUnits * grid_lda<T>(kc);
  return align16(w * sizeof(T)) + align16(bufs * rows_pass * grid_lda<T>(kc) * sizeof(T)) +
         (size_t(kGridWarps) * std::min(rows_pass, B) * std::min(U, kGridUnits) + size_t(D) * B * U) *
             sizeof(float);
}

// Block b owns units [b U, b U + U) (fewer in the last block) of every row.
// Per reverse step, for each direction, block of at most kGridUnits units
// and pass of at most LR RI rows: dgates[t+1] of the pass's rows (from dxp,
// which every block wrote before the last grid barrier) streams through in
// chunks of KC columns (cp.async, the next chunk in flight while the current
// one multiplies; lstm_grid.cuh); each thread accumulates dh_rec of its RI
// rows and the unit block's units (all of them, LR = 32; every fourth, LR =
// 8; its own, LR = 1) over its warp's quads of columns against its rows of
// W_hh; the warps'
// partials add in warp order where dgates[t] of the block's units are
// computed into dxp.  Then one grid barrier.  kWShared: W_hh's rows in shared memory, else staged chunk
// by chunk beside dgates.  vec: 16-byte copies (4H x the operand's size a
// multiple of 16 bytes, and aligned rows).
template <typename T, int D, int LR, int RI, int KC, bool kWShared>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_grid_kernel(const T* __restrict__ w0,        // [H, 4H], rows [0, B)
                     const T* __restrict__ w1,        // [H, 4H], rows [B, 2B) (D == 2)
                     const float* __restrict__ gates, // [T, R, 4H] activated
                     const float* __restrict__ cs,    // [T, R, H]
                     const float* __restrict__ c0,    // [R, H] or null (zero state)
                     const float* __restrict__ dhs,   // [T, R, H]
                     const float* __restrict__ dhf,   // [R, H] or null (zero)
                     const float* __restrict__ dcf,   // [R, H] or null (zero)
                     T* dxp,                          // [T, R, 4H]; read back across blocks
                     float* __restrict__ dh0,         // [R, H] or null
                     float* __restrict__ dc0,         // [R, H] or null
                     int T_, int B, int H, int U, int vec) {
  constexpr int RB = LR * RI, CJ = (kGridUnits * LR + 31) / 32;  // rows a pass, unit slots a lane
  constexpr int LDA = grid_lda<T>(KC);
  cg::grid_group grid = cg::this_grid();
  const int R = D * B;
  const int G4 = 4 * H;  // gate columns of one row
  const int LDW = kWShared ? grid_ld(G4) : LDA;
  const int u0 = blockIdx.x * U, Ub = min(U, H - u0);  // this block's units
  const int NCB = min(U, kGridUnits);                   // partial columns of a row
  const int RP = min(RB, B);                            // partial rows
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bufs = grid_buffers(G4, KC);
  const size_t w_elems = kWShared ? size_t(D) * U * LDW : size_t(bufs) * kGridUnits * LDA;
  T* w_s = reinterpret_cast<T*>(smem_raw);  // [D][U][LDW], or [bufs][kGridUnits][LDA]
  T* a_s = reinterpret_cast<T*>(smem_raw + align16(w_elems * sizeof(T)));  // [bufs][RB][LDA]
  float* part = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(a_s) +
                                         align16(size_t(bufs) * RB * LDA * sizeof(T)));  // [kGridWarps][RP][NCB]
  float* dc_s = part + kGridWarps * RP * NCB;  // [R][U]

  // this block's rows of each W_hh (contiguous in device memory)
  if constexpr (kWShared) {
    for (int e = tid; e < D * U * LDW; e += kThreads) w_s[e] = from_float<T>(0.0f);
    __syncthreads();
    for (int e = tid; e < D * Ub * G4; e += kThreads) {
      const int d = e / (Ub * G4), u = e / G4 % Ub, q = e % G4;
      w_s[(size_t(d) * U + u) * LDW + q] = (d ? w1 : w0)[size_t(u0 + u) * G4 + q];
    }
  }
  for (int e = tid; e < R * U; e += kThreads) {
    const int r = e / U, u = e % U;
    dc_s[e] = dcf != nullptr && u < Ub ? dcf[size_t(r) * H + u0 + u] : 0.0f;
  }
  __syncthreads();

  const int chunks = grid_chunks(G4, KC);
  // s is the step whose dgates are multiplied; t = s - 1 is the step computed
  for (int s = T_; s >= 0; --s) {
    const bool product = s < T_ && (D == 1 || s > 0);  // after step 0 only dh0 needs it
    if (s == 0 && !product) break;
    for (int d = 0; d < D; ++d) {
      for (int ub = 0; ub < Ub; ub += kGridUnits) {
        const int Uc = min(kGridUnits, Ub - ub);
        for (int r0 = 0; r0 < B; r0 += RB) {
          const int rows = min(RB, B - r0);
          if (product) {
            // dh_rec[r][u] = sum_q dgates[s][r][q] W[u0 + ub + u][q]
            const T* src = dxp + (size_t(s) * R + d * B + r0) * G4;
            const T* wsrc = (d ? w1 : w0) + size_t(u0 + ub) * G4;
            float acc[RI][CJ];
#pragma unroll
            for (int i = 0; i < RI; ++i) {
#pragma unroll
              for (int j = 0; j < CJ; ++j) acc[i][j] = 0.0f;
            }
            auto stage = [&](int ch) {
              const int buf = ch & 1;
              grid_stage<T, KC>(a_s + buf * RB * LDA, RB, src, G4, rows, ch * KC, G4, vec, w0);
              if constexpr (!kWShared) {
                grid_stage<T, KC>(w_s + buf * kGridUnits * LDA, kGridUnits, wsrc, G4, Uc, ch * KC, G4, vec, w0);
              }
              cp_async_commit();
            };
            // this lane's unit slots: all of them (LR = 32), or every fourth
            // or its own
            const int jn = LR == 32 ? Uc : grid_lane_columns<LR>(Uc);
            stage(0);
            for (int ch = 0; ch < chunks; ++ch) {
              cp_async_wait<0>();
              __syncthreads();  // chunk ch staged; every warp is done with chunk ch - 1
              if (ch + 1 < chunks) stage(ch + 1);
              const T* w = kWShared ? w_s + (size_t(d) * U + ub) * LDW + ch * KC
                                    : w_s + (ch & 1) * kGridUnits * LDA;
              const int nq = (min(KC, G4 - ch * KC) + 3) / 4;
              grid_product<LR, KC>(acc, a_s + (ch & 1) * RB * LDA, w, LDW, jn, nq);
            }
            grid_partials<LR>(part, acc, RP, NCB, rows, jn);
            __syncthreads();  // the product complete
          }
          if (s == 0) {  // one direction: dh0 and dc0
            for (int e = tid; e < rows * Uc; e += kThreads) {
              const int r = e / Uc, u = e % Uc, j = u0 + ub + u, rg = r0 + r;
              dh0[size_t(rg) * H + j] = grid_sum(part, RP, NCB, r, u);
              dc0[size_t(rg) * H + j] = dc_s[rg * U + ub + u];
            }
            continue;
          }
          // step t = s - 1: the unit block's columns of dgates[t]
          const int t = s - 1;
          for (int e = tid; e < rows * Uc; e += kThreads) {
            const int r = e / Uc, u = e % Uc, j = u0 + ub + u, rg = d * B + r0 + r;
            const size_t row = size_t(t) * R + rg;
            const float* gt = gates + row * G4;
            const float i = gt[j], f = gt[H + j], g = gt[2 * H + j], o = gt[3 * H + j];
            float c_prev = 0.0f;
            if (t > 0) {
              c_prev = cs[(row - R) * H + j];
            } else if (c0 != nullptr) {
              c_prev = c0[size_t(rg) * H + j];
            }
            float dh_rec = 0.0f;
            if (product) {
              dh_rec = grid_sum(part, RP, NCB, r, u);
            } else if (dhf != nullptr) {
              dh_rec = dhf[size_t(rg) * H + j];
            }
            float* dc = dc_s + rg * U + ub + u;
            const float tc = tanhf(f * c_prev + i * g);
            const float dh = dhs[row * H + j] + dh_rec;
            const float dout = dh * tc;
            const float dct = dh * o * (1.0f - tc * tc) + *dc;
            *dc = dct * f;
            T* dx = dxp + row * G4;
            dx[j] = from_float<T>(dct * g * i * (1.0f - i));
            dx[H + j] = from_float<T>(dct * c_prev * f * (1.0f - f));
            dx[2 * H + j] = from_float<T>(dct * i * (1.0f - g * g));
            dx[3 * H + j] = from_float<T>(dout * o * (1.0f - o));
          }
        }
      }
    }
    if (s > 0) grid.sync();  // the whole dgates[t] is in dxp before any block stages it
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void *w0, *w1, *gates, *cs, *hs, *h0, *c0, *dhs, *dhf, *dcf;
  void *dxp, *dw0, *dw1, *dh0, *dc0;
  int steps, B, H;
  void* exchange;         // the split walk's exchange memory (its counters zeroed here before its launch)
  size_t exchange_bytes;  // its size
};

enum Route : int { kGrid = 0, kWalk = 1, kSplit = 2 };

// The walk's launch on this card for B rows a direction (in `info`;
// info->clusters 0 if the card holds no cluster); launches it when `args`
// is given and it can run.
template <typename T, int D, int RC>
cudaError_t walk(const WalkShape& ws, int B, int H, const BwdArgs* args, cudaStream_t stream,
                 ClusterLaunch* info) {
  auto kernel = lstm_bwd_kernel<T, D, RC>;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, D * info->groups, kWalkThreads, stream, &config, &attr, info);
  // a launch shape only, or no cluster fits the card: nothing launched
  if (err != cudaSuccess || args == nullptr || info->clusters < 1) return err;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(args->w0),
                           static_cast<const T*>(args->w1), static_cast<const float*>(args->gates),
                           static_cast<const float*>(args->cs), static_cast<const float*>(args->c0),
                           static_cast<const float*>(args->dhs), static_cast<const float*>(args->dhf),
                           static_cast<const float*>(args->dcf), static_cast<T*>(args->dxp),
                           static_cast<float*>(args->dh0), static_cast<float*>(args->dc0), args->steps,
                           B, H, info->groups, info->rows, ws.units, ws.rows_padded, ws.k_padded,
                           ws.ld, ws.h_padded);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The route and launch on this card for D directions of B rows each.
struct BwdLaunch {
  int route;           // kWalk (the cluster walk), kSplit (the split walk) or kGrid
  ClusterLaunch info;  // walks: row groups, shared memory, clusters; registers of any route
  BwdSplitShape split; // the split walk
  size_t exchange;     // the split walk: bytes of exchange memory it needs
  int grid_blocks, grid_units;  // grid route: blocks, units a block
  size_t grid_smem;
  int grid_resident;   // grid route: blocks the card holds at once
  bool grid_w_shared;  // grid route: W_hh's rows in shared memory (else staged from L2 with dgates)
};

// The walk's row groups and occupancy on this card into `info` (info->groups
// 0 if not one row fits a cluster, info->clusters 0 if the card holds no
// cluster); launches it when `args` is given and it can run, else launches
// nothing.
template <typename T, int D>
cudaError_t walk(int B, int H, const BwdArgs* args, cudaStream_t stream, ClusterLaunch* info) {
  *info = {};
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  auto fits = [&](int rows) {
    const WalkShape w = walk_shape<T>(rows, H);
    return w.smem <= size_t(optin) && walk_fits<T>(w, rows, H);
  };
  if (!row_groups(B, kPairs * kWalkThreads, fits, &info->groups, &info->rows)) {
    info->groups = info->rows = 0;  // no row fits
    return cudaSuccess;
  }
  const WalkShape ws = walk_shape<T>(info->rows, H);
  info->smem = ws.smem;
  if constexpr (sizeof(T) == 2) {
    return walk<T, D, 8>(ws, B, H, args, stream, info);
  } else {
    switch (ws.rows_chunk) {
      case 2: return walk<T, D, 2>(ws, B, H, args, stream, info);
      case 4: return walk<T, D, 4>(ws, B, H, args, stream, info);
      default: return walk<T, D, 8>(ws, B, H, args, stream, info);
    }
  }
}

// The grid route's kernel for tile shape `at` of kGridBwdPasses.
template <typename T, int D, bool kWShared, int I = 0>
void grid_bwd_kernel(int at, decltype(&lstm_bwd_grid_kernel<T, D, 1, 1, 64, true>)* kernel) {
  if constexpr (I < kGridBwdPassCount) {
    constexpr GridBwdPass p = kGridBwdPasses[I];
    if (at == I) {
      *kernel = lstm_bwd_grid_kernel<T, D, p.lr, p.ri, p.chunk_bytes / int(sizeof(T)), kWShared>;
    } else {
      grid_bwd_kernel<T, D, kWShared, I + 1>(at, kernel);
    }
  }
}

// The grid route's launch on this card into `bl`, and the launch when `args`
// is given: one block per U = ceil(H / SMs) units, all resident at once
// (else cudaErrorCooperativeLaunchTooLarge, before anything launches); the
// tile shape the first of kGridBwdPasses whose rows hold a direction's, or
// a later one where that does not fit beside W_hh's rows in shared memory,
// else the same with W_hh's rows staged chunk by chunk.
template <typename T, int D>
cudaError_t grid_route(int B, int H, const BwdArgs* args, cudaStream_t stream, BwdLaunch* bl) {
  int sms = 0, optin = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const int U = (H + sms - 1) / sms;  // at most one block per SM
  bl->grid_units = U;
  bl->grid_blocks = (H + U - 1) / U;
  auto rows_of = [](int i) { return kGridBwdPasses[i].lr * kGridBwdPasses[i].ri; };
  int first = 0;  // the first of the shapes with the fewest rows that hold B
  for (int i = 1; i < kGridBwdPassCount; ++i) {
    if (rows_of(i) >= B && rows_of(i) < rows_of(first)) first = i;
  }
  auto smem = [&](int at, bool w_shared) { return grid_bwd_smem<T>(D, B, H, U, kGridBwdPasses[at], w_shared); };
  int at = first;
  bl->grid_w_shared = true;
  while (at + 1 < kGridBwdPassCount && smem(at, true) > size_t(optin)) ++at;
  if (smem(at, true) > size_t(optin)) {
    bl->grid_w_shared = false;
    at = first;
    while (at + 1 < kGridBwdPassCount && smem(at, false) > size_t(optin)) ++at;
  }
  bl->grid_smem = smem(at, bl->grid_w_shared);
  decltype(&lstm_bwd_grid_kernel<T, D, 1, 1, 64, true>) kernel = nullptr;
  if (bl->grid_w_shared) {
    grid_bwd_kernel<T, D, true>(at, &kernel);
  } else {
    grid_bwd_kernel<T, D, false>(at, &kernel);
  }
  err = occupancy(kernel, bl->grid_smem, &bl->grid_resident, &bl->info.registers, &bl->info.local_bytes);
  if (err == cudaErrorInvalidConfiguration) {  // not one block fits an SM
    bl->grid_resident = 0;
    err = cudaSuccess;
  }
  if (err != cudaSuccess || args == nullptr) return err;
  if (bl->grid_resident < bl->grid_blocks) return cudaErrorCooperativeLaunchTooLarge;
  const T* w0_t = static_cast<const T*>(args->w0);
  const T* w1_t = static_cast<const T*>(args->w1);
  const float* gates_t = static_cast<const float*>(args->gates);
  const float* cs_t = static_cast<const float*>(args->cs);
  const float* c0_t = static_cast<const float*>(args->c0);
  const float* dhs_t = static_cast<const float*>(args->dhs);
  const float* dhf_t = static_cast<const float*>(args->dhf);
  const float* dcf_t = static_cast<const float*>(args->dcf);
  T* dxp_t = static_cast<T*>(args->dxp);
  float* dh0_t = static_cast<float*>(args->dh0);
  float* dc0_t = static_cast<float*>(args->dc0);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  int steps = args->steps, rows = B, hidden = H, units = U;
  int vec = (sizeof(T) == 4 || H % 2 == 0) && aligned(args->dxp) && aligned(args->w0) && aligned(args->w1);
  void* kargs[] = {&w0_t, &w1_t, &gates_t, &cs_t, &c0_t, &dhs_t, &dhf_t, &dcf_t,
                   &dxp_t, &dh0_t, &dc0_t, &steps, &rows, &hidden, &units, &vec};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(bl->grid_blocks), dim3(kThreads), kargs,
                                    bl->grid_smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The split walk's occupancy on this card into `bl->info` (its row groups
// and shape already there), and its launch when `args` is given and the card
// holds all its clusters at once: the counters zeroed on `stream`, then the
// walk.
template <int D>
cudaError_t split_walk(BwdLaunch* bl, int B, int H, const BwdArgs* args, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const BwdSplitShape& s = bl->split;
  const int pairs = D * bl->info.groups;
  auto kernel = lstm_bwd_split_kernel<D>;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attrs[2];
  cudaError_t err = cluster_config(kernel, 2 * pairs, kWalkThreads, stream, &config, attrs, &bl->info);
  if (err != cudaSuccess || args == nullptr || bl->info.clusters < 2 * pairs) return err;
  if (args->exchange == nullptr || args->exchange_bytes < bl->exchange) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(args->exchange, 0, split_counter_bytes(pairs), stream);
  if (err != cudaSuccess) return err;
  unsigned char* ex = static_cast<unsigned char*>(args->exchange);
  return split_launch(kernel, &config, attrs, static_cast<const T*>(args->w0), static_cast<const T*>(args->w1),
                      static_cast<const float*>(args->gates), static_cast<const float*>(args->cs),
                      static_cast<const float*>(args->c0), static_cast<const float*>(args->dhs),
                      static_cast<const float*>(args->dhf), static_cast<const float*>(args->dcf),
                      static_cast<T*>(args->dxp), static_cast<float*>(args->dh0), static_cast<float*>(args->dc0),
                      reinterpret_cast<unsigned int*>(ex), reinterpret_cast<float*>(ex + split_counter_bytes(pairs)),
                      args->steps, B, H, bl->info.groups, bl->info.rows, s.owners, s.first, s.mtiles);
}

// Chooses the route from the shape and the card before anything launches:
// the cluster walk wherever a cluster holds a row and the card holds a
// cluster; else, in bf16, the split walk wherever a pair holds a row and the
// card holds all its clusters at once; else the grid route.  Then launches
// it when `args` is given, else only fills `bl`.
template <typename T, int D>
cudaError_t choose_route(int B, int H, const BwdArgs* args, cudaStream_t stream, BwdLaunch* bl) {
  *bl = {};
  cudaError_t err = walk<T, D>(B, H, args, stream, &bl->info);
  if (err != cudaSuccess) return err;
  if (bl->info.groups > 0 && bl->info.clusters >= 1) {
    bl->route = kWalk;
    return cudaSuccess;
  }
  if constexpr (sizeof(T) == 2) {
    int optin = 0;
    err = smem_optin(&optin);
    if (err != cudaSuccess) return err;
    bl->info = {};
    bl->split = bwd_split_shape(H);
    auto fits = [&](int rows) { return bwd_split_fits(bl->split, rows, size_t(optin)); };
    if (row_groups(B, kBwdSplitMaxRows, fits, &bl->info.groups, &bl->info.rows)) {
      bl->info.smem = bl->split.smem;
      const int pairs = D * bl->info.groups;
      bl->exchange = split_counter_bytes(pairs) + size_t(pairs) * bl->split.pair_bytes;
      err = split_walk<D>(bl, B, H, args, stream);
      if (err != cudaSuccess) return err;
      if (bl->info.clusters >= 2 * pairs) {
        bl->route = kSplit;
        return cudaSuccess;
      }
    }
    bl->info = {};
    bl->exchange = 0;
  }
  bl->route = kGrid;
  return grid_route<T, D>(B, H, args, stream, bl);
}

template <typename T>
cudaError_t launch_dwhh(const void* hs, const void* h0, const void* dxp, void* dw0, void* dw1,
                        int T_, int B, int D, int H, void* stream) {
  if (T_ <= 0 || B <= 0 || H <= 0 || (D != 1 && D != 2)) return cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = H % 4 == 0 && aligned(hs) && aligned(h0) && aligned(dxp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((H + kDwTile - 1) / kDwTile, (4 * H + kDwTile - 1) / kDwTile, D);
    auto kernel = vec ? lstm_dwhh_kernel<T, true> : lstm_dwhh_kernel<T, false>;
    kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(hs), static_cast<const float*>(h0),
                                     static_cast<const T*>(dxp), static_cast<float*>(dw0),
                                     static_cast<float*>(dw1), T_, B, D, H);
  } else {
    const dim3 grid((H + kDwfM - 1) / kDwfM, (4 * H + kDwfN - 1) / kDwfN, D);
    auto kernel = vec ? lstm_dwhh_f32_kernel<true> : lstm_dwhh_f32_kernel<false>;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kDwfSmem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kDwfThreads, kDwfSmem, s>>>(static_cast<const float*>(hs), static_cast<const float*>(h0),
                                           static_cast<const float*>(dxp), static_cast<float*>(dw0),
                                           static_cast<float*>(dw1), T_, B, D, H);
  }
  return cudaGetLastError();
}

// The reverse walk on its route, then dW_hh from its dxp.
template <typename T, int D>
cudaError_t launch(const BwdArgs& a, void* stream, int* route) {
  if (a.steps <= 0 || a.B <= 0 || a.H <= 0) return cudaErrorInvalidValue;
  BwdLaunch bl;
  cudaError_t err = choose_route<T, D>(a.B, a.H, &a, static_cast<cudaStream_t>(stream), &bl);
  if (route != nullptr) *route = bl.route;
  if (err != cudaSuccess) return err;
  return launch_dwhh<T>(a.hs, a.h0, a.dxp, a.dw0, a.dw1, a.steps, a.B, D, a.H, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function returns its
// cudaError_t; 0 is success.  `bf16` selects bf16 operands (W_hh, dxp),
// otherwise fp32.  Everything else is fp32.  `route`, where given, receives
// the walk's route: 1 the cluster walk, 2 the split walk, 0 the grid route.
// `exchange` is scratch memory of `exchange_bytes` bytes (at least what
// lstm_bwd_exchange_bytes reports for the shape; null where that is 0),
// which the split walk uses and whose counters it zeroes on the stream first.

// One direction: whh [H, 4H]; gates [T, B, 4H]; cs, hs, dhs [T, B, H];
// h0, c0, dhf, dcf, dh0, dc0 [B, H]; dxp [T, B, 4H]; dwhh [H, 4H].
extern "C" int lstm_bwd(const void* whh, const void* gates, const void* cs, const void* hs,
                        const void* h0, const void* c0, const void* dhs, const void* dhf,
                        const void* dcf, void* dxp, void* dwhh, void* dh0, void* dc0, int T,
                        int B, int H, int bf16, void* exchange, long long exchange_bytes, void* stream,
                        int* route) {
  const BwdArgs a{whh, nullptr, gates, cs, hs, h0, c0, dhs, dhf, dcf,
                  dxp, dwhh, nullptr, dh0, dc0, T, B, H, exchange, size_t(exchange_bytes)};
  return bf16 ? launch<__nv_bfloat16, 1>(a, stream, route) : launch<float, 1>(a, stream, route);
}

// Both directions, zero initial state: gates, cs, hs, dhs over 2B rows with
// rows [B, 2B) time-reversed; whh_f, whh_b, dwhh_f, dwhh_b [H, 4H].
extern "C" int bilstm_bwd(const void* whh_f, const void* whh_b, const void* gates,
                          const void* cs, const void* hs, const void* dhs, void* dxp,
                          void* dwhh_f, void* dwhh_b, int T, int B, int H, int bf16, void* exchange,
                          long long exchange_bytes, void* stream, int* route) {
  const BwdArgs a{whh_f, whh_b, gates, cs, hs, nullptr, nullptr, dhs, nullptr, nullptr,
                  dxp, dwhh_f, dwhh_b, nullptr, nullptr, T, B, H, exchange, size_t(exchange_bytes)};
  return bf16 ? launch<__nv_bfloat16, 2>(a, stream, route) : launch<float, 2>(a, stream, route);
}

// dW_hh alone, the second kernel of the two functions above: D directions
// of B rows each; hs [T, D*B, H], h0 [D*B, H] or null (zero state), dxp
// [T, D*B, 4H] in the operand type; dwhh_f (rows [0, B)) and, for D = 2,
// dwhh_b (rows [B, 2B)) [H, 4H].
extern "C" int lstm_dwhh(const void* hs, const void* h0, const void* dxp, void* dwhh_f,
                         void* dwhh_b, int T, int B, int D, int H, int bf16, void* stream) {
  return bf16 ? launch_dwhh<__nv_bfloat16>(hs, h0, dxp, dwhh_f, dwhh_b, T, B, D, H, stream)
              : launch_dwhh<float>(hs, h0, dxp, dwhh_f, dwhh_b, T, B, D, H, stream);
}

namespace {
cudaError_t bwd_config(int D, int B, int H, int bf16, BwdLaunch* bl) {
  if (B <= 0 || H <= 0 || (D != 1 && D != 2)) return cudaErrorInvalidValue;
  if (D == 1) {
    return bf16 ? choose_route<__nv_bfloat16, 1>(B, H, nullptr, nullptr, bl)
                : choose_route<float, 1>(B, H, nullptr, nullptr, bl);
  }
  return bf16 ? choose_route<__nv_bfloat16, 2>(B, H, nullptr, nullptr, bl)
              : choose_route<float, 2>(B, H, nullptr, nullptr, bl);
}
}  // namespace

// Bytes of exchange memory the two walks above need for D directions of B
// rows each on this card (0 but on the split walk).
extern "C" int lstm_bwd_exchange_bytes(int D, int B, int H, int bf16, long long* bytes) {
  BwdLaunch bl;
  const cudaError_t err = bwd_config(D, B, H, bf16, &bl);
  *bytes = static_cast<long long>(bl.exchange);
  return err;
}

// The walk's launch for D directions of B rows each on this card: route (1
// the cluster walk, 2 the split walk, 0 the grid route), blocks, units per
// block, dynamic shared memory in bytes; the walks' cluster size, threads
// per block, clusters the card holds at once (0: the walk cannot launch),
// registers and spilled bytes a thread, row groups a direction (one cluster
// each on the cluster walk, a pair on the split walk) and rows a group (the
// grid route: 0 cluster, 256 threads, the blocks it holds at once in
// `clusters`, no row groups); `w_shared` 1 where the grid route keeps W_hh's
// rows in shared memory, 0 where it reads them through L2 (and on the
// walks).
extern "C" int lstm_bwd_launch_config(int D, int B, int H, int bf16, int* route, int* blocks,
                                      int* units, long long* smem, int* cluster, int* threads,
                                      int* clusters, int* registers, int* local_bytes, int* groups,
                                      int* rows, int* w_shared) {
  BwdLaunch bl;
  const cudaError_t err = bwd_config(D, B, H, bf16, &bl);
  if (err != cudaSuccess) return err;
  *route = bl.route;
  *w_shared = bl.route == kGrid && bl.grid_w_shared ? 1 : 0;
  *registers = bl.info.registers;
  *local_bytes = bl.info.local_bytes;
  if (bl.route != kGrid) {
    const bool split = bl.route == kSplit;
    *blocks = D * bl.info.groups * kCluster * (split ? 2 : 1);
    *units = split ? kSplitUnits : (H + kCluster - 1) / kCluster;
    *smem = static_cast<long long>(bl.info.smem);
    *cluster = kCluster;
    *threads = kWalkThreads;
    *clusters = bl.info.clusters;
    *groups = bl.info.groups;
    *rows = bl.info.rows;
  } else {
    *blocks = bl.grid_blocks;
    *units = bl.grid_units;
    *smem = static_cast<long long>(bl.grid_smem);
    *cluster = 0;
    *threads = kThreads;
    *clusters = bl.grid_resident;
    *groups = *rows = 0;
  }
  return cudaSuccess;
}
