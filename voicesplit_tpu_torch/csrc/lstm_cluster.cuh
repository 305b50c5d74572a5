// What the LSTM walks share (lstm_fwd.cu: the forward walks; lstm_bwd.cu:
// the reverse walks): a direction's rows run on thread-block clusters of
// kCluster blocks, block k owning the U = ceil(H / kCluster) hidden units
// J_k = [k U, k U + U) and the 4U columns {g H + j : j in J_k, g = 0..3} of
// its direction's W_hh; blocks exchange what a step produces point to point
// through distributed shared memory, with 16-byte st.async stores counted on
// the receiver's mbarrier.  The split walks (H = 800 in bf16) run a
// direction and row group on a pair of clusters, kSplitUnits units a block,
// and exchange across the pair through L2 (below).  Here: the cluster
// primitives, the wgmma pieces of the bf16 products, the exchange across a
// pair, the owned columns of W_hh, the split of a direction's rows into row
// groups, one cluster or pair each, and the launches.
//
// Each .cu that includes this file is compiled on its own; everything here
// has internal linkage.  Each walk's design is described at the top of its
// .cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCluster = 16;  // blocks of one cluster (non-portable size)
// the split walks (two clusters a direction and row group): units a block
// owns, threads a block, rows a pair holds at most (two 8-row tiles)
constexpr int kSplitUnits = 32;
constexpr int kSplitThreads = 384;
constexpr int kSplitMaxRows = 16;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The address of `p` (this block's shared memory) in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// v into another block's shared memory at `addr`, counted as 16 bytes on
// that block's mbarrier at `bar` (both shared::cluster addresses).
__device__ __forceinline__ void send4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
               ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}
// This thread's view of shared memory that generic stores (st.async
// included) wrote, ordered before its reads through the async proxy
// (wgmma's operands in shared memory).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a) : "memory");
}
// One arrival that also expects `bytes` more on the barrier's current phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed; traps instead of
// hanging if it never does (a fault, not a slow step: ~10 s).
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ---------------------------------------------------------------------------
// wgmma pieces of the walks' bf16 products (m64n8k16: 64 rows of A by 8 rows
// of the other operand), and a split walk's W_hh in shared memory
// ---------------------------------------------------------------------------

// D (64 x 8 fp32; this warp's 16 rows in the mma.sync accumulator layout)
// = A (64 x 16 bf16 from registers, this warp's 16 rows) x B (16 x 8 from
// shared memory, K-major: `desc`) + D if accumulate.
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}

// Shared-memory descriptor of a K-major bf16 B operand of 8 rows and 16 k
// without swizzle: two 8 x 8 core matrices of 128 contiguous bytes, the
// second 128 bytes after the first (both byte offsets 128: N = 8 has no
// second row group).
__device__ __forceinline__ uint64_t b_desc(const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(128 >> 4) << 32);
}

// A split walk's W_hh columns in shared memory: K-major atoms of 64 rows
// (columns q) by 64 k (four k-steps) with the 128-byte swizzle, 8 KB each
// and 1024-byte aligned: element (q, c) at byte (q / 8) 1024 + (q % 8) 128 +
// ((2 c / 16) ^ (q % 8)) 16 + 2 c % 16, the layout CUTLASS gives a K-major
// A operand.
constexpr int kAtomBytes = 8192;
__device__ __forceinline__ int sw128_at(int q, int c) {
  return (q >> 3) * 1024 + (q & 7) * 128 + ((((2 * c) >> 4) ^ (q & 7)) << 4) + ((2 * c) & 15);
}
// Shared-memory descriptor of k-step s (0..3) of such an atom: the start
// advanced by 32 bytes a k-step, 8-row groups 1024 bytes apart (stride byte
// offset), the 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t a_desc_at(uint32_t addr) {  // a shared::cta address
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}
__device__ __forceinline__ uint64_t a_desc(const void* atom, int s) {
  return a_desc_at(static_cast<uint32_t>(__cvta_generic_to_shared(atom)) + 32u * uint32_t(s));
}

// D (64 x 8 fp32) += A (64 x 16 bf16 from shared memory: `da`) x B (16 x 8
// from shared memory, K-major: `db`).
__device__ __forceinline__ void wgmma_m64n8k16_ss(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// ---------------------------------------------------------------------------
// Across the two clusters of a split walk (lstm_fwd.cu, lstm_bwd.cu): the
// clusters share no shared memory, so a block publishes what the other
// cluster needs in a global buffer (through L2) and announces it on an
// integer counter of its cluster; a receiver waits for the counter to reach
// the count of all the other cluster's blocks for that step, then copies
// the bytes into its own shared memory with one bulk copy (cp.async.bulk)
// counted on an mbarrier of its own.  The global buffer has two slots by
// step parity, reused as the receive slots are: a block writes a slot again
// only after it has received every block's next step, which each block
// sends after it has copied the slot.  The counters only count: every float
// is summed in a fixed order by the block that owns it.
// ---------------------------------------------------------------------------

// One more publication on `counter`, ordered after every write this thread
// made or observed before it (release, gpu scope).  A block publishes after
// a barrier that follows its writes to the global buffer.
__device__ __forceinline__ void counter_release_add(unsigned int* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}
// Waits until *counter >= target (acquire, gpu scope), then orders what it
// observed before this thread's later bulk copies (the async proxy); traps
// instead of hanging if the count never comes (a fault, not a slow step:
// ~10 s).
__device__ __forceinline__ void counter_wait(const unsigned int* counter, unsigned int target) {
  const long long t0 = clock64();
  while (true) {
    unsigned int v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
    if (v >= target) break;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into this block's shared memory, counted on this block's `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// The forward's split walk waits between two wgmma with more in flight.
// A loop or branch in C++ there makes ptxas fence and serialize every wgmma
// of the kernel ("wgmma.mma_async instructions are serialized", C7520), so
// these two waits keep their loops inside one asm statement each.
//
// bar_wait's loop in one asm statement: waits until the phase of parity
// `parity` of `bar` has completed; traps if it never does (~10 s).
__device__ __forceinline__ void bar_wait_asm(uint64_t* bar, uint32_t parity) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n .reg .pred p;\n .reg .u64 t0, t1;\n"
      " mov.u64 t0, %%clock64;\n"
      "BAR_WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      " @p bra BAR_DONE;\n"
      " mov.u64 t1, %%clock64;\n sub.u64 t1, t1, t0;\n"
      " setp.gt.u64 p, t1, 17179869184;\n @p trap;\n"
      " bra BAR_WAIT;\n"
      "BAR_DONE:\n}\n" ::"r"(a), "r"(parity) : "memory");
}
// Where `leader` is set: counter_wait(counter, target) (trap after ~10 s),
// then `copies` (1 or 2) bulk copies of `bytes` each, src0 -> dst0 and src1
// -> dst1 (global -> this block's shared memory), expected on `bar` (one
// arrival and their bytes).  Elsewhere nothing.  One asm statement.
__device__ __forceinline__ void fetch_after_count(int leader, const unsigned int* counter, unsigned int target,
                                                  uint64_t* bar, uint32_t bytes, int copies, void* dst0,
                                                  const void* src0, void* dst1, const void* src1) {
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  const uint32_t d0 = static_cast<uint32_t>(__cvta_generic_to_shared(dst0));
  const uint32_t d1 = static_cast<uint32_t>(__cvta_generic_to_shared(dst1));
  asm volatile(
      "{\n .reg .pred p, q;\n .reg .u32 v, n;\n .reg .u64 t0, t1;\n"
      " setp.ne.b32 q, %0, 0;\n @!q bra FETCH_DONE;\n"
      " mov.u64 t0, %%clock64;\n"
      "FETCH_SPIN:\n"
      " ld.acquire.gpu.global.u32 v, [%1];\n"
      " setp.ge.u32 p, v, %2;\n @p bra FETCH_GOT;\n"
      " mov.u64 t1, %%clock64;\n sub.u64 t1, t1, t0;\n"
      " setp.gt.u64 p, t1, 17179869184;\n @p trap;\n"
      " bra FETCH_SPIN;\n"
      "FETCH_GOT:\n"
      " fence.proxy.async.global;\n"
      " mul.lo.u32 n, %4, %5;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], n;\n"
      " cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%6], [%7], %4, [%3];\n"
      " setp.gt.s32 p, %5, 1;\n"
      " @p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%8], [%9], %4, [%3];\n"
      "FETCH_DONE:\n}\n" ::"r"(leader),
      "l"(counter), "r"(target), "r"(b), "r"(bytes), "r"(copies), "r"(d0), "l"(src0), "r"(d1), "l"(src1)
      : "memory");
}

// Where a split walk's counters and buffers lie in its exchange memory:
// counter x of pair p at counters + (2 p + x) * kCounterStride (one 128-byte
// line each, so that the two clusters' counters are never polled on one
// line), then each pair's global slots.
constexpr int kCounterStride = 32;
inline size_t split_counter_bytes(int pairs) { return size_t(2) * pairs * kCounterStride * 4; }

// Block `u0 / U`'s columns of W [H, 4H] into shared memory: element e of
// w_s [n][ld] is W[j, g H + u0 + u] for (j, q = g U + u) = at(e / ld, e % ld),
// zero where j is no unit (j < 0 or j >= H) or q no owned column (u >= Uk,
// the block's units, or q >= 4U).  The block's threads each take elements.
template <typename T, typename At>
__device__ void stage_owned_columns(T* w_s, int n, int ld, const T* W, int H, int U, int u0,
                                    int Uk, At at) {
  for (int e = threadIdx.x; e < n * ld; e += blockDim.x) {
    int j, q;
    at(e / ld, e % ld, j, q);
    const int u = q % U;
    w_s[e] = (j >= 0 && j < H && q < 4 * U && u < Uk) ? W[size_t(j) * 4 * H + (q / U) * H + u0 + u]
                                                      : from_float<T>(0.0f);
  }
}

// Row groups: a direction's B rows over `groups` clusters of at most `rows`
// rows each (the last may hold fewer, never none), `rows` the most that
// `fits(rows)` allows (at most `cap`), spread evenly.  Clusters never talk
// to each other, so the groups run in any order.  False if not one row fits.
template <typename Fits>
bool row_groups(int B, int cap, Fits fits, int* groups, int* rows) {
  int most = B < cap ? B : cap;
  while (most > 0 && !fits(most)) --most;
  if (most <= 0) return false;
  const int g = (B + most - 1) / most;
  *rows = (B + g - 1) / g;
  *groups = (B + *rows - 1) / *rows;
  return true;
}

// What a cluster walk's launch needs and gets on this card.
struct ClusterLaunch {
  int groups, rows;  // row groups of a direction (one cluster each), rows a cluster
  size_t smem;       // dynamic shared memory of a block
  int clusters;      // cudaOccupancyMaxActiveClusters (0: it cannot run)
  int registers;     // a thread
  int local_bytes;   // spilled, a thread
};

inline cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Sets `kernel`'s attributes for info->smem bytes and a non-portable cluster
// of kCluster blocks, fills `config` (with `attr`, one attribute) for
// `n_clusters` clusters of `threads` threads on `stream`, and reads the
// kernel's registers and spills and the clusters the card holds at once into
// `info`.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int n_clusters, int threads, cudaStream_t stream,
                           cudaLaunchConfig_t* config, cudaLaunchAttribute* attr,
                           ClusterLaunch* info) {
  info->clusters = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  info->registers = fa.numRegs;
  info->local_bytes = int(fa.localSizeBytes);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(info->smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *config = {};
  config->gridDim = dim3(n_clusters * kCluster);
  config->blockDim = dim3(threads);
  config->dynamicSmemBytes = info->smem;
  config->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(&info->clusters, (const void*)kernel, config);
}

// Launches a split walk configured by cluster_config (`config`, whose
// `attrs` has room for a second attribute) as a cooperative launch, so that
// the runtime too refuses to start fewer blocks than all: the two clusters
// of a pair wait on each other, and a cluster left waiting to be scheduled
// would hang its partner.  The caller has checked that the card holds every
// cluster at once.
template <typename Kernel, typename... Args>
cudaError_t split_launch(Kernel kernel, cudaLaunchConfig_t* config, cudaLaunchAttribute* attrs, Args... args) {
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  config->numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
