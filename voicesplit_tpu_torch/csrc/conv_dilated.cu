// Time-dilated "same" conv for Hopper (sm_90a): forward / data gradient and
// weight gradient of the opt-in conv path (VOICESPLIT_PALLAS_CONV=1).
//
// Replaces the TPU kernels in voicesplit_tpu/ops/conv_pallas.py:
//   conv_dilated_fwd   <- _fwd_kernel   (:95,  launched by _conv_fwd_core   :167)
//   conv_dilated_wgrad <- _wgrad_kernel (:234, launched by _conv_wgrad_core :292)
//
// Channels-last activations [B, T, F, C = 64], weights [kt, kf, Cin, Cout],
// time dilation dt, frequency dilation 1, odd kt and kf, no bias:
//
//   conv_dilated_fwd    out = round(sum_{i,j,c} x[b, t + i*dt - pad_t, f + j - pad_f, c]
//                                               * W[i, j, c, co])
//                       With the tap-flipped, channel-transposed weights the
//                       caller packs, the same kernel is the data gradient
//                       (conv_pallas.py:371-378).
//   conv_dilated_wgrad  dW[i, j, c, co] = sum_{b,t,f} x[b, t + i*dt - pad_t, f + j - pad_f, c]
//                                                     * dy[b, t, f, co]      (fp32)
//
// round() casts to the operand type (bf16 or fp32); every product accumulates
// in fp32 and a tap outside [0, T) x [0, F) contributes zero.  The TPU kernel
// rounds each frequency tap's partial sum to the output type and adds the kf
// partial sums in that type (its N-fold shift-add); this kernel keeps all
// taps in one fp32 sum and rounds once, which is the more exact of the two.
//
// Not carried over: the K-fold (time taps folded into the contraction) and
// N-fold (frequency taps folded into the output width), the 128-lane channel
// padding, the 8-column frequency halo frames and the (t_tile, f_tile) grid
// with its double-buffered DMA.  They make 320 x 320 products for a 128-wide
// matrix unit fed from 128 MB of VMEM; mma.sync wants 16 x 8 x 16 tiles from
// shared memory, and C = 64 gives those without a remainder.  The halo is a
// predicated load that gives zero.
//
// Design.  Both kernels are the block-level bodies of conv_tile.cuh, which
// the fused chain's kernels (conv_fused.cu) also use, without a prologue,
// bias or statistics: conv_tile in its plain mode (a block computes two time
// rows x 128 positions x 64 channels, stages one time tap's weights for both
// rows, writes 16 bytes per thread) and wgrad_tile (a block owns one time tap
// and every n-th (b, t) row and keeps dW[i, 0..kf) in registers).  The TPU
// kernel keeps the whole [kt*64, kf*64] fp32 dW resident across a sequential
// grid; 5*64 x 5*64 fp32 is 409,600 B, more than an SM's shared memory, and
// blocks run in no order, so each block writes its partial dW to scratch and
// reduce_rows_kernel adds the partials in a fixed order (in double): the
// same inputs give the same bits, no float atomics.
//
// What bounds them on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16
// dense): as conv_fused.cu's kernels, a (5,5) layer by operations and the
// (7,1) layer by bytes.  This first version reaches neither bound (no
// cp.async / TMA ring, mma.sync and not wgmma); that is later work.

#include "conv_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv_dilated_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                        int T_, int F, int kt, int kf, int dt) {
  conv_tile<T, kTilePlain>(x, w, nullptr, nullptr, out, nullptr, T_, F, kt, kf, dt, kNone);
}

template <typename T, int KF>
__global__ void __launch_bounds__(kThreads, 2)
conv_dilated_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          float* __restrict__ partials, int B, int T_, int F, int kt, int dt) {
  wgrad_tile<T, KF>(x, dy, nullptr, partials, B, T_, F, kt, dt, kNone);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, void* out, int B, int T_, int F, int kt,
                       int kf, int dt, cudaStream_t stream) {
  if (bad_shape(B, T_, F, kt, kf, dt)) return cudaErrorInvalidValue;
  LaunchConfig cfg;
  cudaError_t err = tile_config<T>(B, T_, F, kt, kf, &cfg);
  if (err != cudaSuccess) return err;
  auto kernel = conv_dilated_fwd_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(cfg.smem));
  if (err != cudaSuccess) return err;
  kernel<<<cfg.blocks, cfg.threads, cfg.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), T_, F, kt, kf,
      dt);
  return cudaGetLastError();
}

template <typename T, int KF>
cudaError_t launch_wgrad_kf(const void* x, const void* dy, void* dw, void* scratch, int B, int T_,
                            int F, int kt, int dt, cudaStream_t stream) {
  LaunchConfig cfg;
  cudaError_t err = wgrad_config<T>(B, T_, F, kt, KF, &cfg);
  if (err != cudaSuccess) return err;
  auto kernel = conv_dilated_wgrad_kernel<T, KF>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(cfg.smem));
  if (err != cudaSuccess) return err;
  float* partials = static_cast<float*>(scratch);
  kernel<<<dim3(cfg.blocks, kt), cfg.threads, cfg.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partials, B, T_, F, kt, dt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = kt * KF * kC * kC;
  reduce_rows_kernel<4><<<(width + 31) / 32, dim3(32, 4), 0, stream>>>(
      partials, cfg.blocks, width, static_cast<float*>(dw));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad(const void* x, const void* dy, void* dw, void* scratch, int B, int T_,
                         int F, int kt, int kf, int dt, cudaStream_t stream) {
  if (bad_shape(B, T_, F, kt, kf, dt)) return cudaErrorInvalidValue;
  switch (kf) {
    case 1: return launch_wgrad_kf<T, 1>(x, dy, dw, scratch, B, T_, F, kt, dt, stream);
    case 3: return launch_wgrad_kf<T, 3>(x, dy, dw, scratch, B, T_, F, kt, dt, stream);
    case 5: return launch_wgrad_kf<T, 5>(x, dy, dw, scratch, B, T_, F, kt, dt, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function returns its
// cudaError_t; 0 is success.  `bf16` selects bf16 activations and weights,
// otherwise fp32; dw and scratch are fp32.  Activations are [B, T, F, 64],
// weights [kt, kf, 64, 64].  `scratch` holds the weight gradient's per-block
// partial sums (conv_dilated_launch_config gives its size); the forward
// needs none.

extern "C" int conv_dilated_fwd(const void* x, const void* w, void* out, int B, int T, int F,
                                int kt, int kf, int dt, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, w, out, B, T, F, kt, kf, dt, s)
              : launch_fwd<float>(x, w, out, B, T, F, kt, kf, dt, s);
}

extern "C" int conv_dilated_wgrad(const void* x, const void* dy, void* dw, void* scratch, int B,
                                  int T, int F, int kt, int kf, int dt, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_wgrad<__nv_bfloat16>(x, dy, dw, scratch, B, T, F, kt, kf, dt, s)
              : launch_wgrad<float>(x, dy, dw, scratch, B, T, F, kt, kf, dt, s);
}

// Launch shape of a kernel: kind 0 forward (scratch 0), 1 weight gradient
// (whose grid is blocks x kt).
extern "C" int conv_dilated_launch_config(int kind, int B, int T, int F, int kt, int kf, int bf16,
                                          int* blocks, int* threads, long long* smem,
                                          long long* scratch) {
  LaunchConfig cfg;
  cudaError_t err;
  if (kind == 1) {
    err = bf16 ? wgrad_config<__nv_bfloat16>(B, T, F, kt, kf, &cfg)
               : wgrad_config<float>(B, T, F, kt, kf, &cfg);
  } else if (kind == 0) {
    err = bf16 ? tile_config<__nv_bfloat16>(B, T, F, kt, kf, &cfg)
               : tile_config<float>(B, T, F, kt, kf, &cfg);
    cfg.scratch = 0;
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  *blocks = cfg.blocks;
  *threads = cfg.threads;
  *smem = static_cast<long long>(cfg.smem);
  *scratch = static_cast<long long>(cfg.scratch);
  return cudaSuccess;
}
