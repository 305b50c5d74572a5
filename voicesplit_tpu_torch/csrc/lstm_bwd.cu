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
//   dW_hh[j, :] += round(h[t-1, r, j]) * round(dgates[r, :])
// where round() casts to the operand type (bf16 or fp32) as the Pallas
// kernel does before its matrix products, and every product accumulates in
// fp32.  dxp = dgates in the operand type; dW_hh is fp32.  h[t-1] and
// c[t-1] are read in place from the forward's hs and cs (h0 and c0 at
// t = 0), so the shifted copies the JAX wrapper builds are not needed.
//
// Design: a persistent cooperative kernel, one block per U = ceil(H/#SMs)
// hidden units (U = 4 at H = 400 on 132 SMs: 100 blocks), one grid-wide
// barrier per step, as in lstm_fwd.cu.  What differs from the forward:
//   - The recurrent product runs the other way: dh_rec[j] needs row j of
//     W_hh across all 4H gate columns, so a block keeps the ROWS of W_hh
//     for its units in shared memory (U x 4H: 12.8 KB per direction in
//     bf16 at H = 400).
//   - dgates[t+1] of all units is needed by every block.  The owning
//     block writes it to dxp (which has the operand type, so dxp IS the
//     rounded product operand); after the barrier every block stages all
//     of it, R x 4H, through L2 (__ldcg, 8 rows at a time) into shared
//     memory.
//   - dW_hh = sum_t h[t-1]^T dgates[t] lies off the sequential chain.  It
//     is accumulated in the walk, in shared memory: the staged dgates[t+1]
//     rows are exactly what the block's own rows of dW_hh (its U units x
//     4H columns, fp32, 25.6 KB per direction) need, so the product reuses
//     the reads the recurrence makes anyway, each block owns distinct rows
//     (no atomics), and dW_hh is written once at the end.  A second tiled
//     kernel over all T*R rows would read h and dgates from device memory
//     once more; this one reads nothing extra.
//   - Step order, after the barrier of step t+1: stage dgates[t+1], form
//     dh_rec for own units and add round(h[t]) x dgates[t+1] into dW_hh,
//     then compute own 4U columns of dgates[t] (dc carried in shared
//     memory) and write them to dxp[t].  After step 0, one more staging
//     gives dh0 and the h0 term of dW_hh (one direction only: the
//     two-direction kernel starts from zero state, whose terms are zero).
// R = D * B rows; CUDA-core FMAs: one warp per dh_prev dot product (four
// partial sums per lane, warp-shuffle reduction), and for dW_hh each
// thread owns columns q of the block's rows, so the loop carries no index
// division.  Tensor-core products, fewer barriers and CUDA graphs are
// later work.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense),
// counting each input byte read once and each output byte written once,
// both products at the bf16 rate:
//   lstm_bwd,  B = 2, T = 301, H = 400, bf16: ~12.5 MB and 1.54 GFLOP
//              -> memory-bound, ~3.7 us; launched twice per training step.
//   bilstm_bwd, B = 8 (16 rows), bf16: ~77 MB and 12.3 GFLOP
//              -> memory-bound, ~23 us; launched once per training step.
// The real limit of this design is neither: it is the T = 301 dependent
// steps, each ending in one grid-wide barrier, and the per-step CUDA-core
// products.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;          // dot products per pass, one per warp
constexpr int kRowChunk = 8;                   // rows of dgates staged at a time

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

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared memory: W_hh rows [D][U][4H] (T), staged dgates [kRowChunk][4H]
// (T), dW_hh rows [D][U][4H] (fp32), then [R][U] fp32 each for the rounded
// h of the staged step, the recurrent dh and the carried dc.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int D, int R, int H, int U) {
  return align16(size_t(D) * U * 4 * H * sizeof(T)) +
         align16(size_t(kRowChunk) * 4 * H * sizeof(T)) +
         (size_t(D) * U * 4 * H + 3 * size_t(R) * U) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const T* __restrict__ w0,        // [H, 4H], rows [0, B)
                const T* __restrict__ w1,        // [H, 4H], rows [B, 2B) (D == 2)
                const float* __restrict__ gates, // [T, R, 4H] activated
                const float* __restrict__ cs,    // [T, R, H]
                const float* __restrict__ hs,    // [T, R, H]
                const float* __restrict__ h0,    // [R, H] or null (zero state)
                const float* __restrict__ c0,    // [R, H] or null (zero state)
                const float* __restrict__ dhs,   // [T, R, H]
                const float* __restrict__ dhf,   // [R, H] or null (zero)
                const float* __restrict__ dcf,   // [R, H] or null (zero)
                T* dxp,                          // [T, R, 4H]; read back across blocks
                float* __restrict__ dw0,         // [H, 4H]
                float* __restrict__ dw1,         // [H, 4H] (D == 2)
                float* __restrict__ dh0,         // [R, H] or null
                float* __restrict__ dc0,         // [R, H] or null
                int T_, int B, int H, int U) {
  cg::grid_group grid = cg::this_grid();
  const int R = D * B;
  const int G4 = 4 * H;  // gate columns of one row
  const int u0 = blockIdx.x * U;
  const int tid = threadIdx.x;
  const int n_w = D * U * G4;  // shared elements of W_hh rows and of dW_hh rows

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // [D][U][4H]
  unsigned char* p = smem_raw + align16(size_t(n_w) * sizeof(T));
  T* dg_s = reinterpret_cast<T*>(p);  // [kRowChunk][4H]
  p += align16(size_t(kRowChunk) * G4 * sizeof(T));
  float* dw_s = reinterpret_cast<float*>(p);  // [D][U][4H]
  float* hr_s = dw_s + n_w;                   // [R][U]
  float* dhr_s = hr_s + size_t(R) * U;        // [R][U]
  float* dc_s = dhr_s + size_t(R) * U;        // [R][U]

  // This block's rows of each W_hh (contiguous in device memory), zeroed dW.
  for (int e = tid; e < n_w; e += kThreads) {
    const int d = e / (U * G4);
    const int u = (e / G4) % U;
    const int q = e % G4;
    const int j = u0 + u;
    const T* W = d ? w1 : w0;
    w_s[e] = j < H ? W[size_t(j) * G4 + q] : from_float<T>(0.0f);
    dw_s[e] = 0.0f;
  }
  for (int e = tid; e < R * U; e += kThreads) {
    const int r = e / U, j = u0 + e % U;
    const bool in = j < H;
    dc_s[e] = (dcf != nullptr && in) ? dcf[size_t(r) * H + j] : 0.0f;
    dhr_s[e] = (dhf != nullptr && in) ? dhf[size_t(r) * H + j] : 0.0f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  // s is the step whose dgates are staged; t = s - 1 is the step computed.
  for (int s = T_; s >= 0; --s) {
    if (s < T_ && (D == 1 || s > 0)) {
      // round(h[s-1]) of own units: the h_prev of step s, for dW_hh
      for (int e = tid; e < R * U; e += kThreads) {
        const int r = e / U, j = u0 + e % U;
        float h = 0.0f;
        if (j < H) {
          if (s > 0) {
            h = hs[(size_t(s - 1) * R + r) * H + j];
          } else if (h0 != nullptr) {
            h = h0[size_t(r) * H + j];
          }
        }
        hr_s[e] = round_to<T>(h);
      }
      const T* dg_step = dxp + size_t(s) * R * G4;
      for (int r0 = 0; r0 < R; r0 += kRowChunk) {
        const int rc = min(kRowChunk, R - r0);
        // stage rows [r0, r0 + rc) of dgates[s] as 4-byte words (4H * sizeof(T)
        // is a multiple of 4); written by other blocks: bypass L1
        const unsigned int* src =
            reinterpret_cast<const unsigned int*>(dg_step + size_t(r0) * G4);
        unsigned int* dst = reinterpret_cast<unsigned int*>(dg_s);
        const int words = int(size_t(rc) * G4 * sizeof(T) / 4);
        for (int e = tid; e < words; e += kThreads) dst[e] = __ldcg(src + e);
        __syncthreads();

        // dh_rec[r, u] = sum_q dgates[r, q] * W[j, q], one warp per (r, u)
        const int n_out = rc * U;
        for (int o = warp; o < n_out; o += kWarps) {  // warp-uniform
          const int rl = o / U, u = o % U;
          const int d = (D == 2 && r0 + rl >= B) ? 1 : 0;
          const T* w = w_s + (size_t(d) * U + u) * G4;
          const T* g = dg_s + size_t(rl) * G4;
          float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
          int q = lane;
          for (; q + 96 < G4; q += 128) {
            a0 = fmaf(to_float(g[q]), to_float(w[q]), a0);
            a1 = fmaf(to_float(g[q + 32]), to_float(w[q + 32]), a1);
            a2 = fmaf(to_float(g[q + 64]), to_float(w[q + 64]), a2);
            a3 = fmaf(to_float(g[q + 96]), to_float(w[q + 96]), a3);
          }
          for (; q < G4; q += 32) a0 = fmaf(to_float(g[q]), to_float(w[q]), a0);
          float acc = (a0 + a1) + (a2 + a3);
          for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
          if (lane == 0) dhr_s[size_t(r0) * U + o] = acc;
        }

        // dW[d][u][q] += sum over staged rows r of direction d: hr[r, u] * dgates[r, q]
        for (int d = 0; d < D; ++d) {
          const int r_lo = max(r0, d * B), r_hi = min(r0 + rc, D == 2 ? (d + 1) * B : R);
          if (r_lo >= r_hi) continue;
          for (int u = 0; u < U; ++u) {
            float* dw = dw_s + (size_t(d) * U + u) * G4;
            for (int q = tid; q < G4; q += kThreads) {
              float acc = dw[q];
              for (int r = r_lo; r < r_hi; ++r) {
                acc = fmaf(hr_s[r * U + u], to_float(dg_s[size_t(r - r0) * G4 + q]), acc);
              }
              dw[q] = acc;
            }
          }
        }
        __syncthreads();  // before the next chunk overwrites dg_s
      }
    }
    if (s == 0) break;

    // step t = s - 1: own units' columns of dgates[t]
    const int t = s - 1;
    for (int e = tid; e < R * U; e += kThreads) {
      const int r = e / U, j = u0 + e % U;
      if (j >= H) continue;
      const size_t row = size_t(t) * R + r;
      const float* gt = gates + row * G4;
      const float i = gt[j], f = gt[H + j], g = gt[2 * H + j], o = gt[3 * H + j];
      float c_prev = 0.0f;
      if (t > 0) {
        c_prev = cs[(row - R) * H + j];
      } else if (c0 != nullptr) {
        c_prev = c0[size_t(r) * H + j];
      }
      const float tc = tanhf(f * c_prev + i * g);
      const float dh = dhs[row * H + j] + dhr_s[e];
      const float dout = dh * tc;
      const float dct = dh * o * (1.0f - tc * tc) + dc_s[e];
      dc_s[e] = dct * f;
      T* dx = dxp + row * G4;
      dx[j] = from_float<T>(dct * g * i * (1.0f - i));
      dx[H + j] = from_float<T>(dct * c_prev * f * (1.0f - f));
      dx[2 * H + j] = from_float<T>(dct * i * (1.0f - g * g));
      dx[3 * H + j] = from_float<T>(dout * o * (1.0f - o));
    }
    grid.sync();  // the whole dgates[t] is in dxp before any block stages it
  }

  if (D == 1) {
    for (int e = tid; e < R * U; e += kThreads) {
      const int r = e / U, j = u0 + e % U;
      if (j >= H) continue;
      dh0[size_t(r) * H + j] = dhr_s[e];
      dc0[size_t(r) * H + j] = dc_s[e];
    }
  }
  for (int e = tid; e < n_w; e += kThreads) {
    const int d = e / (U * G4);
    const int u = (e / G4) % U;
    const int q = e % G4;
    const int j = u0 + u;
    if (j < H) (d ? dw1 : dw0)[size_t(j) * G4 + q] = dw_s[e];
  }
}

struct LaunchConfig {
  int blocks, units;
  size_t smem;
};

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <typename T>
cudaError_t launch_config(int D, int B, int H, LaunchConfig* cfg) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  cfg->units = (H + sms - 1) / sms;  // at most one block per SM
  cfg->blocks = (H + cfg->units - 1) / cfg->units;
  cfg->smem = smem_bytes<T>(D, D * B, H, cfg->units);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(const void* w0, const void* w1, const void* gates, const void* cs,
                   const void* hs, const void* h0, const void* c0, const void* dhs,
                   const void* dhf, const void* dcf, void* dxp, void* dw0, void* dw1,
                   void* dh0, void* dc0, int T_, int B, int H, void* stream) {
  if (T_ <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  LaunchConfig cfg;
  cudaError_t err = launch_config<T>(D, B, H, &cfg);
  if (err != cudaSuccess) return err;
  auto kernel = lstm_bwd_kernel<T, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(cfg.smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, cfg.smem);
  if (err != cudaSuccess) return err;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < cfg.blocks) return cudaErrorCooperativeLaunchTooLarge;

  const T* w0_t = static_cast<const T*>(w0);
  const T* w1_t = static_cast<const T*>(w1);
  const float* gates_t = static_cast<const float*>(gates);
  const float* cs_t = static_cast<const float*>(cs);
  const float* hs_t = static_cast<const float*>(hs);
  const float* h0_t = static_cast<const float*>(h0);
  const float* c0_t = static_cast<const float*>(c0);
  const float* dhs_t = static_cast<const float*>(dhs);
  const float* dhf_t = static_cast<const float*>(dhf);
  const float* dcf_t = static_cast<const float*>(dcf);
  T* dxp_t = static_cast<T*>(dxp);
  float* dw0_t = static_cast<float*>(dw0);
  float* dw1_t = static_cast<float*>(dw1);
  float* dh0_t = static_cast<float*>(dh0);
  float* dc0_t = static_cast<float*>(dc0);
  int units = cfg.units;
  void* args[] = {&w0_t, &w1_t, &gates_t, &cs_t, &hs_t, &h0_t, &c0_t, &dhs_t, &dhf_t,
                  &dcf_t, &dxp_t, &dw0_t, &dw1_t, &dh0_t, &dc0_t, &T_, &B, &H, &units};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(cfg.blocks), dim3(kThreads),
                                    args, cfg.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function returns its
// cudaError_t; 0 is success.  `bf16` selects bf16 operands (W_hh, dxp),
// otherwise fp32.  Everything else is fp32.

// One direction: whh [H, 4H]; gates [T, B, 4H]; cs, hs, dhs [T, B, H];
// h0, c0, dhf, dcf, dh0, dc0 [B, H]; dxp [T, B, 4H]; dwhh [H, 4H].
extern "C" int lstm_bwd(const void* whh, const void* gates, const void* cs, const void* hs,
                        const void* h0, const void* c0, const void* dhs, const void* dhf,
                        const void* dcf, void* dxp, void* dwhh, void* dh0, void* dc0, int T,
                        int B, int H, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16, 1>(whh, nullptr, gates, cs, hs, h0, c0, dhs, dhf, dcf,
                                         dxp, dwhh, nullptr, dh0, dc0, T, B, H, stream)
              : launch<float, 1>(whh, nullptr, gates, cs, hs, h0, c0, dhs, dhf, dcf, dxp,
                                 dwhh, nullptr, dh0, dc0, T, B, H, stream);
}

// Both directions, zero initial state: gates, cs, hs, dhs over 2B rows with
// rows [B, 2B) time-reversed; whh_f, whh_b, dwhh_f, dwhh_b [H, 4H].
extern "C" int bilstm_bwd(const void* whh_f, const void* whh_b, const void* gates,
                          const void* cs, const void* hs, const void* dhs, void* dxp,
                          void* dwhh_f, void* dwhh_b, int T, int B, int H, int bf16,
                          void* stream) {
  return bf16 ? launch<__nv_bfloat16, 2>(whh_f, whh_b, gates, cs, hs, nullptr, nullptr, dhs,
                                         nullptr, nullptr, dxp, dwhh_f, dwhh_b, nullptr,
                                         nullptr, T, B, H, stream)
              : launch<float, 2>(whh_f, whh_b, gates, cs, hs, nullptr, nullptr, dhs, nullptr,
                                 nullptr, dxp, dwhh_f, dwhh_b, nullptr, nullptr, T, B, H,
                                 stream);
}

// Launch shape of the two functions above: blocks, units per block and
// dynamic shared memory in bytes, for D directions of B rows each.
extern "C" int lstm_bwd_launch_config(int D, int B, int H, int bf16, int* blocks, int* units,
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
