// What the LSTM walks share (lstm_fwd.cu: the forward walk; lstm_bwd.cu:
// the reverse walk): a direction's rows run on thread-block clusters of
// kCluster blocks, block k owning the U = ceil(H / kCluster) hidden units
// J_k = [k U, k U + U) and the 4U columns {g H + j : j in J_k, g = 0..3} of
// its direction's W_hh; blocks exchange what a step produces point to point
// through distributed shared memory, with 16-byte st.async stores counted on
// the receiver's mbarrier.  Here: the cluster primitives, the owned columns
// of W_hh, and the split of a direction's rows into row groups, one cluster
// each.
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
// of kCluster blocks, fills `config` (with `attr`) for `n_clusters` clusters
// of `threads` threads on `stream`, and reads the kernel's registers and
// spills and the clusters the card holds at once into `info`.
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

}  // namespace
