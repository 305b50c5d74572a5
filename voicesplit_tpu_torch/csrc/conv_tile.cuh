// Helpers that the conv kernels share (conv_fwd.cu: the forward / data-
// gradient kernel body of conv_dilated_fwd, conv_bn_act_fwd, conv_dgrad and
// conv_bn_act_eval; conv_wgrad.cu: the weight-gradient kernels and the
// chain's prologue and d_raw passes):
// channels, tile widths, operand types, the prologue's activation, the eval
// epilogue's per-channel table, ldmatrix,
// mma.sync, wgmma's ordering, cp.async, occupancy, launch-shape checks and
// the fixed-order reduction of per-block partial rows.  lstm_bwd.cu takes its
// ldmatrix and mma.sync pieces from here too, for the dW_hh product, and
// lstm_fwd.cu its ldmatrix and wgmma pieces, for the forward walk's product.
//
// Each .cu that includes this file is compiled on its own and defines its
// own __global__ kernels; everything here has internal linkage.  Each
// kernel's design is described at the top of its .cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// The eval mode's epilogue (conv_fwd.cu, conv_fwd_wide.cu): the layer's conv
// bias, BatchNorm parameters and running statistics (fp32 [Cout] each), eps
// and the activation (kMish or kRelu).
struct EvalParams {
  const float* bias;
  const float* scale;
  const float* beta;
  const float* mean;
  const float* var;
  float eps;
  int act;
};

namespace {

constexpr int kC = 64;        // channels of a tile: in and out at C = 64, else a slab or group
constexpr int kTileF = 128;   // frequency positions per weight-gradient tile
constexpr int kThreads = 256;
constexpr int kMaxTaps = 7;   // largest kt or kf

enum Act : int { kMish = 1, kRelu = 2 };  // the prologue's and the eval epilogue's activation (0: none)

template <typename T> struct Ld {  // operand row stride in shared memory: + 16 bytes
  static constexpr int value = kC + 16 / int(sizeof(T));
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 8 consecutive channels, global -> registers (fp32).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 consecutive channels, registers -> global or shared, rounded to T.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The prologue's activation of z, every step rounded on its own (no fused
// multiply-add), as the plain version computes it.
__device__ __forceinline__ float activate(float z, int act) {
  if (act == kRelu) return fmaxf(z, 0.0f);
  const float u = expf(fminf(z, 20.0f));
  const float up = __fadd_rn(1.0f, u);
  const float w = __fmul_rn(up, up);
  const float t = __fdiv_rn(__fadd_rn(w, -1.0f), __fadd_rn(w, 1.0f));
  return __fmul_rn(z, t);
}

// Stages [3][cout] fp32 into shared memory: the conv bias, inv = scale x
// (1 / sqrt(var + eps)) and shift = beta - mean x inv, every step rounded on
// its own, as the plain version computes them.
__device__ __forceinline__ void stage_eval(float* s, const EvalParams& ep, int cout, int tid, int threads) {
  for (int c = tid; c < cout; c += threads) {
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ep.var[c], ep.eps)));
    const float inv = __fmul_rn(ep.scale[c], r);
    s[c] = ep.bias[c];
    s[cout + c] = inv;
    s[2 * cout + c] = __fsub_rn(ep.beta[c], __fmul_rn(ep.mean[c], inv));
  }
}

// The eval epilogue's activation, without a branch, so that a thread's
// outputs interleave: mish as z n / (n + 2) with n = u (u + 2), u =
// e^min(z, 20) (tanh(softplus(z)) without the cancellation of ((1 + u)^2 - 1)
// / ((1 + u)^2 + 1) that activate's form has for z < 0) on the fast
// exponential and division, a few fp32 ulps under the output's one rounding;
// relu selected.  (With activate, exact step by step, the eval kernel took
// 47% more time than the plain one at B = 8 on an H100; the prologue pass
// keeps activate and its bits.)
__device__ __forceinline__ float activate_eval(float z, int act) {
  const float u = __expf(fminf(z, 20.0f));
  const float n = u * (u + 2.0f);
  const float mish = z * __fdividef(n, n + 2.0f);
  return act == kRelu ? fmaxf(z, 0.0f) : mish;
}

// act((acc + bias) x inv + shift) of output channels co and co + 1 (co even),
// from stage_eval's table, in fp32 (the caller rounds once).
__device__ __forceinline__ void eval_pair(float& v0, float& v1, const float* s, int cout, int co, int act) {
  const float2 b = *reinterpret_cast<const float2*>(s + co);
  const float2 inv = *reinterpret_cast<const float2*>(s + cout + co);
  const float2 shift = *reinterpret_cast<const float2*>(s + 2 * cout + co);
  v0 = activate_eval(__fadd_rn(__fmul_rn(__fadd_rn(v0, b.x), inv.x), shift.x), act);
  v1 = activate_eval(__fadd_rn(__fmul_rn(__fadd_rn(v1, b.y), inv.y), shift.y), act);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D += A (16x16, row) * B (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma's ordering: before the first product that reads registers other
// instructions wrote; closing a group of products; waiting until at most N
// groups are in flight.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros and reads
// nothing (the halo).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// out[c] = sum over rows of in[row][c], rows added in a fixed order, in
// double.  Block: 32 columns x SLICES row slices.
template <int SLICES>
__global__ void reduce_rows_kernel(const float* __restrict__ in, int rows, int width,
                                   float* __restrict__ out) {
  __shared__ double part[SLICES][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  double a = 0.0;
  if (col < width) {
    for (int r = threadIdx.y; r < rows; r += SLICES) a += double(in[size_t(r) * width + col]);
  }
  part[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    double total = 0.0;
    for (int k = 0; k < SLICES; ++k) total += part[k][threadIdx.x];
    out[col] = float(total);
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Blocks of `kernel` (kThreads threads, `smem` bytes of dynamic shared memory)
// that the card holds at once, and its registers and local (spilled) bytes a
// thread.  Sets the kernel's shared-memory limit, which a launch needs.
template <typename K>
cudaError_t occupancy(K kernel, size_t smem, int* resident, int* registers, int* local_bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *resident = per_sm * sms;
  *registers = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  return cudaSuccess;
}

bool bad_shape(int B, int T_, int F, int kt, int kf, int dt) {
  return B <= 0 || T_ <= 0 || F <= 0 || dt <= 0 || kt <= 0 || kf <= 0 || kt % 2 == 0 ||
         kf % 2 == 0 || kt > kMaxTaps || kf > kMaxTaps;
}

}  // namespace
