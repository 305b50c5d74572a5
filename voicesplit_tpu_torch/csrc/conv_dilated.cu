// Time-dilated "same" conv for Hopper (sm_90a): forward / data gradient of
// the opt-in conv path (VOICESPLIT_PALLAS_CONV=1).  The path's weight
// gradient, conv_dilated_wgrad, lives in conv_wgrad.cu.
//
// Replaces the TPU kernel in voicesplit_tpu/ops/conv_pallas.py:
//   conv_dilated_fwd   <- _fwd_kernel   (:95,  launched by _conv_fwd_core   :167)
//   (conv_dilated_wgrad <- _wgrad_kernel (:234): conv_wgrad.cu)
//
// Channels-last activations [B, T, F, C = 64], weights [kt, kf, Cin, Cout],
// time dilation dt, frequency dilation 1, odd kt and kf, no bias:
//
//   conv_dilated_fwd    out = round(sum_{i,j,c} x[b, t + i*dt - pad_t, f + j - pad_f, c]
//                                               * W[i, j, c, co])
//                       With the tap-flipped, channel-transposed weights the
//                       caller packs, the same kernel is the data gradient
//                       (conv_pallas.py:371-378).
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
// Design.  The kernel is the block-level body conv_tile of conv_tile.cuh,
// which the fused chain's kernels (conv_fused.cu) also use, in its plain mode
// (no prologue, bias or statistics): a block computes two time rows x 128
// positions x 64 channels, stages one time tap's weights for both rows and
// writes 16 bytes per thread.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense):
// as conv_fused.cu's kernels, a (5,5) layer by operations and the (7,1) layer
// by bytes.  conv_tile reaches neither bound yet (no cp.async / TMA ring,
// mma.sync and not wgmma); conv_wgrad.cu's pipelined, whole-wave design is
// the pattern for its redesign.

#include "conv_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv_dilated_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                        int T_, int F, int kt, int kf, int dt) {
  conv_tile<T, kTilePlain>(x, w, nullptr, nullptr, out, nullptr, T_, F, kt, kf, dt, kNone);
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

}  // namespace

// Plain C interface (loaded with ctypes).  Returns its cudaError_t; 0 is
// success.  `bf16` selects bf16 activations and weights, otherwise fp32.
// Activations are [B, T, F, 64], weights [kt, kf, 64, 64].  Its grid is
// conv_tile's, which conv_fused_launch_config gives.

extern "C" int conv_dilated_fwd(const void* x, const void* w, void* out, int B, int T, int F,
                                int kt, int kf, int dt, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, w, out, B, T, F, kt, kf, dt, s)
              : launch_fwd<float>(x, w, out, B, T, F, kt, kf, dt, s);
}
