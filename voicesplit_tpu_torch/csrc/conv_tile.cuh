// The "same" time-dilated conv over channels-last [B, T, F, 64] activations:
// the block-level body conv_tile of the fused chain's forward kernel
// conv_bn_act_fwd (conv_fused.cu: two time rows x 128 frequency positions x
// 64 output channels per block, with the chain's prologue, bias and output
// statistics), and the helpers that the other conv kernels share with it
// (operand types, the prologue's activation, ldmatrix, mma.sync, cp.async,
// occupancy, launch-shape checks, the fixed-order reduction).
//
// Each .cu that includes this file is compiled on its own and defines its
// own __global__ kernels; everything here has internal linkage.  conv_tile's
// design (mma.sync.m16n8k16 for bf16, FMAs for fp32, padded shared-memory
// rows for ldmatrix, predicated halo loads, cross-block sums by
// reduce_rows_kernel in a fixed order) is described at the top of
// conv_fused.cu; the forward / data-gradient kernels' at the top of
// conv_fwd.cu; the weight gradient's at the top of conv_wgrad.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kC = 64;        // channels, in and out
constexpr int kTileF = 128;   // frequency positions per block tile
constexpr int kRows = 2;      // time rows per forward / dgrad block
constexpr int kThreads = 256;
constexpr int kLdOut = kC + 4;  // fp32 tile row stride in the epilogue
constexpr int kMaxTaps = 7;     // largest kt or kf

enum Act : int { kNone = 0, kMish = 1, kRelu = 2 };

template <typename T> struct Ld {  // operand row stride in shared memory: + 16 bytes
  static constexpr int value = kC + 16 / int(sizeof(T));
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

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

// Stage `n_pos` positions [f_lo, f_lo + n_pos) of one activation row into
// dst[n_pos][Ld]: zero outside [0, F) or when the row itself is outside
// the tensor (row == nullptr); the prologue applied when act != kNone.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* row, int f_lo, int n_pos, int F,
                                          int act, const float* inv_s, const float* shift_s,
                                          int tid) {
  constexpr int LD = Ld<T>::value;
  for (int e = tid; e < n_pos * 8; e += kThreads) {
    const int p = e >> 3, c8 = (e & 7) * 8;
    const int f = f_lo + p;
    float v[8];
    if (row != nullptr && f >= 0 && f < F) {
      load8(row + size_t(f) * kC + c8, v);
      if (act != kNone) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float z = __fadd_rn(__fmul_rn(v[k], inv_s[c8 + k]), shift_s[c8 + k]);
          v[k] = activate(z, act);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.0f;
    }
    store8(dst + size_t(p) * LD + c8, v);
  }
}

// Copy `rows` rows of 64 channels, contiguous in global memory, into
// dst[rows][Ld].
template <typename T>
__device__ __forceinline__ void stage_dense(T* dst, const T* src, int rows, int tid) {
  constexpr int LD = Ld<T>::value;
  constexpr int kVec = 16 / int(sizeof(T));  // elements per 16 bytes
  constexpr int kPerRow = kC / kVec;
  for (int e = tid; e < rows * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    *reinterpret_cast<uint4*>(dst + size_t(r) * LD + c) =
        *reinterpret_cast<const uint4*>(src + size_t(r) * kC + c);
  }
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

// ---------------------------------------------------------------------------
// Forward and data gradient: one tile kernel body
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr size_t tile_a_bytes(int kf) {
  return align16(size_t(kRows) * (kTileF + kf - 1) * Ld<T>::value * sizeof(T));
}
template <typename T>
__host__ __device__ constexpr size_t tile_w_bytes(int kf) {
  return align16(size_t(kf) * kC * Ld<T>::value * sizeof(T));
}
constexpr size_t kTileOutBytes = size_t(kRows) * kTileF * kLdOut * sizeof(float);
constexpr size_t kTileRedBytes = size_t(kThreads / 8) * 2 * kC * sizeof(float);

template <typename T>
__host__ __device__ constexpr size_t tile_smem_bytes(int kf) {
  const size_t operands = tile_a_bytes<T>(kf) + tile_w_bytes<T>(kf);
  const size_t epilogue = kTileOutBytes + kTileRedBytes;
  return operands > epilogue ? operands : epilogue;
}

// conv_bn_act_fwd: the prologue, bias and the statistics of the output;
// partials[block][128] = {sum[64], sum of squares[64]}.
template <typename T>
__device__ __forceinline__ void conv_tile(const T* __restrict__ x, const T* __restrict__ w,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ scal, T* __restrict__ out,
                                          float* __restrict__ partials, int T_, int F, int kt,
                                          int kf, int dt, int act) {
  constexpr int LD = Ld<T>::value;
  constexpr bool kTensorCore = sizeof(T) == 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_ft = (F + kTileF - 1) / kTileF;
  const int n_tp = (T_ + kRows - 1) / kRows;
  const int ft = blockIdx.x % n_ft;
  const int tp = (blockIdx.x / n_ft) % n_tp;
  const int b = blockIdx.x / (n_ft * n_tp);
  const int f0 = ft * kTileF, t0 = tp * kRows;
  const int pad_t = (kt - 1) * dt / 2, pad_f = (kf - 1) / 2;
  const int a_rows = kTileF + kf - 1;  // staged positions per input row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);                        // [kRows][a_rows][LD]
  T* w_s = reinterpret_cast<T*>(smem_raw + tile_a_bytes<T>(kf));  // [kf][kC][LD]
  float* out_s = reinterpret_cast<float*>(smem_raw);              // [kRows * kTileF][kLdOut]
  float* red_s = reinterpret_cast<float*>(smem_raw + kTileOutBytes);  // [32][128]
  __shared__ float inv_s[kC], shift_s[kC], bias_s[kC];

  if (tid < kC) {
    inv_s[tid] = act != kNone ? scal[tid] : 0.0f;
    shift_s[tid] = act != kNone ? scal[kC + tid] : 0.0f;
    bias_s[tid] = bias[tid];
  }
  __syncthreads();

  // accumulators: tensor cores [2 m16 tiles x 8 n8 tiles][4]; FMA [64 outputs]
  float acc[16][4];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;

  const int tr = warp >> 2;          // which of the two time rows this warp works on
  const int m0 = (warp & 3) * 32;    // its 32 positions

  for (int i = 0; i < kt; ++i) {
    const T* rows[kRows];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r, ti = t + i * dt - pad_t;
      const bool ok = t < T_ && ti >= 0 && ti < T_;
      rows[r] = ok ? x + (size_t(b) * T_ + ti) * F * kC : nullptr;
      any = any || ok;
    }
    if (!any) continue;  // the same for every thread of the block
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (rows[r] != nullptr) {
        stage_row<T>(a_s + size_t(r) * a_rows * LD, rows[r], f0 - pad_f, a_rows, F, act, inv_s,
                     shift_s, tid);
      }
    }
    stage_dense<T>(w_s, w + size_t(i) * kf * kC * kC, kf * kC, tid);
    __syncthreads();

    if ((tr ? rows[1] : rows[0]) != nullptr) {  // the same for every thread of the warp
      const T* a_row = a_s + size_t(tr) * a_rows * LD;
      if constexpr (kTensorCore) {
        for (int j = 0; j < kf; ++j) {
          const T* w_j = w_s + size_t(j) * kC * LD;
#pragma unroll
          for (int kk = 0; kk < kC / 16; ++kk) {
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const int row = m0 + mt * 16 + (lane & 15) + j;
              ldmatrix_x4(a[mt], a_row + size_t(row) * LD + kk * 16 + (lane >> 4) * 8);
            }
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              uint32_t bf[4];
              ldmatrix_x4_trans(
                  bf, w_j + size_t(kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(acc[mt * 8 + 2 * np], a[mt], bf[0], bf[1]);
                mma_bf16(acc[mt * 8 + 2 * np + 1], a[mt], bf[2], bf[3]);
              }
            }
          }
        }
      } else {
        // one output position per thread, all 64 output channels
        const int m = tid & 127;
        for (int j = 0; j < kf; ++j) {
          const T* a_p = a_row + size_t(m + j) * LD;
          const T* w_j = w_s + size_t(j) * kC * LD;
          for (int k = 0; k < kC; ++k) {
            const float av = to_float(a_p[k]);
            const T* w_k = w_j + size_t(k) * LD;
#pragma unroll
            for (int n = 0; n < kC; ++n) {
              acc[n >> 2][n & 3] = fmaf(av, to_float(w_k[n]), acc[n >> 2][n & 3]);
            }
          }
        }
      }
    }
    __syncthreads();  // before the next tap row overwrites the operands
  }

  // the fp32 tile through shared memory (the operands are no longer needed)
  if constexpr (kTensorCore) {
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float (&c)[4] = acc[mt * 8 + nt];
        float* o = out_s + size_t(tr * kTileF + m0 + mt * 16 + g) * kLdOut + nt * 8 + 2 * tig;
        o[0] = c[0];
        o[1] = c[1];
        o[8 * kLdOut] = c[2];
        o[8 * kLdOut + 1] = c[3];
      }
    }
  } else {
    float* o = out_s + size_t(tid) * kLdOut;  // tid = tr * 128 + m
#pragma unroll
    for (int n = 0; n < kC; ++n) o[n] = acc[n >> 2][n & 3];
  }
  __syncthreads();

  // epilogue: + bias, round, write 8 channels per thread, statistics
  const int c8 = (tid & 7) * 8;
  float s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.0f;
  for (int pass = 0; pass < kRows * kTileF / (kThreads / 8); ++pass) {
    const int rowl = pass * (kThreads / 8) + (tid >> 3);
    const int t = t0 + rowl / kTileF, f = f0 + rowl % kTileF;
    if (t < T_ && f < F) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = round_to<T>(out_s[size_t(rowl) * kLdOut + c8 + k] + bias_s[c8 + k]);
        s[k] += v[k];
        q[k] += v[k] * v[k];
      }
      store8(out + ((size_t(b) * T_ + t) * F + f) * kC + c8, v);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    red_s[(tid >> 3) * 2 * kC + c8 + k] = s[k];
    red_s[(tid >> 3) * 2 * kC + kC + c8 + k] = q[k];
  }
  __syncthreads();
  if (tid < 2 * kC) {
    float v = 0.0f;
    for (int r = 0; r < kThreads / 8; ++r) v += red_s[r * 2 * kC + tid];
    partials[size_t(blockIdx.x) * 2 * kC + tid] = v;
  }
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

struct LaunchConfig {
  int blocks, threads;
  size_t smem, scratch;  // dynamic shared memory bytes; fp32 scratch elements
};

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

template <typename T>
cudaError_t tile_config(int B, int T_, int F, int kt, int kf, LaunchConfig* cfg) {
  if (bad_shape(B, T_, F, kt, kf, 1)) return cudaErrorInvalidValue;
  const long long blocks =
      (long long)B * ((T_ + kRows - 1) / kRows) * ((F + kTileF - 1) / kTileF);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cfg->blocks = int(blocks);
  cfg->threads = kThreads;
  cfg->smem = tile_smem_bytes<T>(kf);
  cfg->scratch = size_t(blocks) * 2 * kC;
  return cudaSuccess;
}

}  // namespace
