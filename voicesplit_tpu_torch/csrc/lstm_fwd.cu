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
// Design: a persistent cooperative kernel.  The Pallas kernel keeps the
// whole W_hh (1.28 MB in bf16 at H = 400) resident in VMEM; an SM has at
// most 227 KB of shared memory, so here the hidden units are split across
// blocks.  Block b owns U consecutive units (U = ceil(H / #SMs): 4 at
// H = 400 on 132 SMs, so 100 blocks, all co-resident) and keeps their 4U
// gate columns of each W_hh in shared memory for all T steps (25.6 KB per
// direction in bf16, 51.2 KB in fp32).  Each step the block stages h[t-1]
// for all rows from hs in global memory (L2, __ldcg), rounds it to the
// operand type, computes its R x 4U gate pre-activations with CUDA-core
// FMAs (8 threads per dot product, reduced with warp shuffles), applies
// the cell update for its units (their c stays in shared memory), writes
// hs, cs and gates, and crosses a grid-wide barrier
// (cooperative_groups::this_grid().sync()) so that the next step sees the
// whole new h.  R = D * B <= 16 rows on the serving path, so CUDA cores
// suffice; tensor-core products (mma.sync / wgmma), TMA and CUDA graphs are
// later work.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense),
// counting each input byte read once and each output byte written once:
//   lstm_fwd,  B = 1, T = 301, H = 400, bf16: ~5.1 MB and 0.39 GFLOP
//              -> memory-bound, ~1.5 us; launched twice per forward.
//   bilstm_fwd, B = 8 (16 rows), bf16: ~64 MB and 6.2 GFLOP
//              -> memory-bound, ~19 us; launched once per forward.
// The real limit of this design is neither: it is the T = 301 dependent
// steps, each ending in one grid-wide barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                      // threads sharing one dot product
constexpr int kGroups = kThreads / kLanes;     // dot products per pass
constexpr int kRowChunk = 16;                  // rows of h staged at a time

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

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int D, int R, int H, int U) {
  return align16(size_t(D) * 4 * U * H * sizeof(T)) +
         (size_t(kRowChunk) * H + size_t(R) * 4 * U + size_t(R) * U) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const T* __restrict__ xp,     // [T, R, 4H]
                const T* __restrict__ w0,     // [H, 4H], rows [0, B)
                const T* __restrict__ w1,     // [H, 4H], rows [B, 2B) (D == 2)
                const float* __restrict__ h0, // [R, H] or null (zero state)
                const float* __restrict__ c0, // [R, H] or null (zero state)
                float* hs,                    // [T, R, H]; read back across blocks
                float* __restrict__ cs,       // [T, R, H]
                float* __restrict__ gates,    // [T, R, 4H]
                int T_, int B, int H, int U) {
  cg::grid_group grid = cg::this_grid();
  const int R = D * B;
  const int G = 4 * U;  // gate columns owned by this block
  const int u0 = blockIdx.x * U;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // [D][G][H]
  float* h_s = reinterpret_cast<float*>(smem_raw + align16(size_t(D) * G * H * sizeof(T)));
  float* pre_s = h_s + size_t(kRowChunk) * H;  // [R][G]
  float* c_s = pre_s + size_t(R) * G;          // [R][U]

  // This block's gate columns of W_hh, column q = gate * U + unit.
  for (int e = tid; e < D * G * H; e += kThreads) {
    const int d = e / (G * H);
    const int q = (e / H) % G;
    const int k = e % H;
    const int j = u0 + q % U;
    const T* W = d ? w1 : w0;
    w_s[e] = j < H ? W[size_t(k) * 4 * H + size_t(q / U) * H + j] : from_float<T>(0.0f);
  }
  for (int e = tid; e < R * U; e += kThreads) {
    const int r = e / U, j = u0 + e % U;
    c_s[e] = (c0 != nullptr && j < H) ? c0[size_t(r) * H + j] : 0.0f;
  }
  __syncthreads();

  const int group = tid / kLanes, lane = tid % kLanes;
  for (int t = 0; t < T_; ++t) {
    const float* h_prev = t > 0 ? hs + size_t(t - 1) * R * H : h0;
    for (int r0 = 0; r0 < R; r0 += kRowChunk) {
      const int rc = min(kRowChunk, R - r0);
      for (int e = tid; e < rc * H; e += kThreads) {
        const size_t idx = size_t(r0) * H + e;
        float h = 0.0f;
        if (t > 0) {
          h = __ldcg(h_prev + idx);  // written by other blocks: bypass L1
        } else if (h0 != nullptr) {
          h = h0[idx];
        }
        h_s[e] = round_to<T>(h);
      }
      __syncthreads();
      const int n_out = rc * G;
      for (int ob = 0; ob < n_out; ob += kGroups) {  // same trip count in every thread
        const int o = ob + group;
        const bool active = o < n_out;
        float acc = 0.0f;
        if (active) {
          const int rl = o / G, q = o % G;
          const int d = (D == 2 && r0 + rl >= B) ? 1 : 0;
          const T* w = w_s + (size_t(d) * G + q) * H;
          const float* h = h_s + size_t(rl) * H;
          for (int k = lane; k < H; k += kLanes) acc = fmaf(h[k], to_float(w[k]), acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (active && lane == 0) pre_s[size_t(r0) * G + o] = acc;
      }
      __syncthreads();
    }

    for (int e = tid; e < R * U; e += kThreads) {
      const int r = e / U, u = e % U, j = u0 + u;
      if (j >= H) continue;
      const size_t row = size_t(t) * R + r;
      const T* x = xp + row * 4 * H;
      const float* p = pre_s + size_t(r) * G;
      const float i = sigmoid(to_float(x[j]) + p[u]);
      const float f = sigmoid(to_float(x[H + j]) + p[U + u]);
      const float g = tanhf(to_float(x[2 * H + j]) + p[2 * U + u]);
      const float o = sigmoid(to_float(x[3 * H + j]) + p[3 * U + u]);
      const float c = f * c_s[e] + i * g;
      const float h = o * tanhf(c);
      c_s[e] = c;
      hs[row * H + j] = h;
      cs[row * H + j] = c;
      float* gt = gates + row * 4 * H;
      gt[j] = i;
      gt[H + j] = f;
      gt[2 * H + j] = g;
      gt[3 * H + j] = o;
    }
    grid.sync();  // the whole h[t] is visible before step t + 1 reads it
  }
}

struct LaunchConfig {
  int blocks, units;
  size_t smem;
};

template <typename T>
cudaError_t launch_config(int D, int B, int H, LaunchConfig* cfg) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  cfg->units = (H + sms - 1) / sms;  // at most one block per SM
  cfg->blocks = (H + cfg->units - 1) / cfg->units;
  cfg->smem = smem_bytes<T>(D, D * B, H, cfg->units);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(const void* xp, const void* w0, const void* w1, const void* h0,
                   const void* c0, void* hs, void* cs, void* gates, int T_, int B, int H,
                   void* stream) {
  if (T_ <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  LaunchConfig cfg;
  cudaError_t err = launch_config<T>(D, B, H, &cfg);
  if (err != cudaSuccess) return err;
  auto kernel = lstm_fwd_kernel<T, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(cfg.smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, cfg.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm * sms < cfg.blocks) return cudaErrorCooperativeLaunchTooLarge;

  const T* xp_t = static_cast<const T*>(xp);
  const T* w0_t = static_cast<const T*>(w0);
  const T* w1_t = static_cast<const T*>(w1);
  const float* h0_t = static_cast<const float*>(h0);
  const float* c0_t = static_cast<const float*>(c0);
  float* hs_t = static_cast<float*>(hs);
  float* cs_t = static_cast<float*>(cs);
  float* gates_t = static_cast<float*>(gates);
  int units = cfg.units;
  void* args[] = {&xp_t, &w0_t, &w1_t, &h0_t, &c0_t, &hs_t, &cs_t, &gates_t,
                  &T_, &B, &H, &units};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(cfg.blocks),
                                    dim3(kThreads), args, cfg.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function returns its
// cudaError_t; 0 is success.  `bf16` selects bf16 operands (xp, W_hh),
// otherwise fp32.  h0 / c0 / hs / cs / gates are fp32.

// One direction: xp [T, B, 4H], whh [H, 4H], h0 and c0 [B, H].
extern "C" int lstm_fwd(const void* xp, const void* whh, const void* h0, const void* c0,
                        void* hs, void* cs, void* gates, int T, int B, int H, int bf16,
                        void* stream) {
  return bf16 ? launch<__nv_bfloat16, 1>(xp, whh, nullptr, h0, c0, hs, cs, gates, T, B, H, stream)
              : launch<float, 1>(xp, whh, nullptr, h0, c0, hs, cs, gates, T, B, H, stream);
}

// Both directions, zero initial state: xp [T, 2B, 4H], rows [B, 2B) already
// time-reversed; whh_f and whh_b [H, 4H].
extern "C" int bilstm_fwd(const void* xp, const void* whh_f, const void* whh_b, void* hs,
                          void* cs, void* gates, int T, int B, int H, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16, 2>(xp, whh_f, whh_b, nullptr, nullptr, hs, cs, gates, T,
                                         B, H, stream)
              : launch<float, 2>(xp, whh_f, whh_b, nullptr, nullptr, hs, cs, gates, T, B, H,
                                 stream);
}

// Launch shape the two functions above use: blocks, units per block and
// dynamic shared memory in bytes, for D directions of B rows each.
extern "C" int lstm_launch_config(int D, int B, int H, int bf16, int* blocks, int* units,
                                  long long* smem) {
  LaunchConfig cfg;
  cudaError_t err = bf16 ? launch_config<__nv_bfloat16>(D, B, H, &cfg)
                         : launch_config<float>(D, B, H, &cfg);
  if (err != cudaSuccess) return err;
  *blocks = cfg.blocks;
  *units = cfg.units;
  *smem = static_cast<long long>(cfg.smem);
  return cudaSuccess;
}

// The text of a cudaError_t, for every wrapper of this library.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
