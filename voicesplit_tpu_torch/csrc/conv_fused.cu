// Fused conv chain for Hopper (sm_90a): the forward kernel.  The chain's
// data gradient, conv_dgrad, lives in conv_fwd.cu, its weight gradient,
// conv_wgrad, in conv_wgrad.cu.
//
// Replaces the TPU kernels in voicesplit_tpu/ops/conv_fused.py:
//   conv_bn_act_fwd <- _fwd_kernel   (:303, launched by _conv_fwd   :365)
//   (conv_dgrad     <- _dgrad_kernel (:411): conv_fwd.cu)
//   (conv_wgrad     <- _wgrad_kernel (:524): conv_wgrad.cu)
//
// Both are "same" convolutions over channels-last activations
// [B, T, F, C = 64] with weights [kt, kf, Cin, Cout], time dilation dt,
// frequency dilation 1, odd kt and kf:
//
//   conv_bn_act_fwd  y   = prologue ? round(act(float(x) * inv[c] + shift[c])) : x
//                    raw = round(sum_{i,j,c} y[b, t + i*dt - pad_t, f + j - pad_f, c]
//                                            * W[i, j, c, co]  + bias[co])
//                    stats[0, co] = sum raw,  stats[1, co] = sum raw^2   (fp32, of
//                    the rounded raw)
//   conv_dgrad       dx  = round(the same sum over d_raw with the flipped,
//                    transposed weights the caller packs), dbias[c] = sum d_raw
//
// round() casts to the operand type (bf16 or fp32), every product
// accumulates in fp32, the prologue runs in fp32 and is rounded before the
// product, and a tap outside [0, T) x [0, F) contributes zero (zero after
// the activation).  Mish in the prologue is the Pallas kernels'
// single-exponential form, u = e^min(z, 20), t = ((1+u)^2 - 1) / ((1+u)^2 + 1).
//
// Not carried over: the TPU's frequency fold (pairs of bins -> 128
// channels) and its zero-margined frames, which serve a 128-wide matrix
// unit and DMA alignment; here the halo is a predicated load that gives
// zero.  Nor the BN-backward prologues of _dgrad_kernel (prologue=True) and
// _wgrad_kernel (rhs_prologue), which make_chain never reaches: it
// materializes d_raw in two plain passes.
//
// The block-level body (conv_tile), its helpers and the launch shapes live
// in conv_tile.cuh; this file holds the __global__ kernel, its launch and
// the C interface.  conv_dgrad's description stays here beside the forward's
// because the two compute the same sum; conv_fwd.cu holds its design.
//
// Design.  bf16 operands go through the warp-level tensor-core product
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), operands staged in shared
// memory with a 16-byte row padding so that ldmatrix is free of bank
// conflicts.  fp32 operands use fp32 FMAs on CUDA cores (not TF32); that
// instantiation is for tests at reduced shapes.
//
//   forward: one block computes two time rows x 128 frequency
//   positions x 64 output channels.  For each time tap i it stages the two
//   input rows (prologue applied while staging, halo zeroed) and the kf x
//   64 x 64 weights of that tap row, then each of its 8 warps multiplies a
//   32-position slice.  The two rows share the staged weights.  The fp32
//   tile goes through shared memory to the epilogue, which adds the bias,
//   rounds, writes 16 bytes per thread and sums the statistics per column.
//
// Reductions across blocks (blocks run in no order, unlike the TPU's grid):
// every block writes its partial sums to scratch and a second small kernel
// adds them in a fixed order (in double), so the same inputs give the same
// bits: no float atomics.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16
// dense), each input byte read once and each output byte written once: a
// (5,5) layer at [8, 301, 601, 64] is 296 GFLOP against 370 MB, so
// operations bound it (0.30 ms against 0.11 ms); the (7,1) layer is bound
// by bytes.  conv_tile reaches neither yet: it waits for its loads (no
// cp.async / TMA ring, two blocks per SM), conv_bn_act_fwd recomputes its
// prologue for each time tap that stages a row, and it multiplies with
// mma.sync, not wgmma.  conv_fwd.cu's whole-wave design (a cp.async ring of
// input rows, weights staged once per run or per item) is the pattern for
// its redesign, with the prologue run once per element.

#include "conv_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv_bn_act_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ scal,
                       T* __restrict__ out, float* __restrict__ partials, int T_, int F, int kt,
                       int kf, int dt, int act) {
  conv_tile<T>(x, w, bias, scal, out, partials, T_, F, kt, kf, dt, act);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const void* bias, const void* scal,
                       void* raw, void* stats, void* scratch, int B, int T_, int F, int kt,
                       int kf, int dt, int act, cudaStream_t stream) {
  if (bad_shape(B, T_, F, kt, kf, dt) || act < kNone || act > kRelu) return cudaErrorInvalidValue;
  LaunchConfig cfg;
  cudaError_t err = tile_config<T>(B, T_, F, kt, kf, &cfg);
  if (err != cudaSuccess) return err;
  auto kernel = conv_bn_act_fwd_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(cfg.smem));
  if (err != cudaSuccess) return err;
  float* partials = static_cast<float*>(scratch);
  kernel<<<cfg.blocks, cfg.threads, cfg.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(scal), static_cast<T*>(raw), partials, T_, F, kt, kf, dt, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_rows_kernel<32><<<(2 * kC + 31) / 32, dim3(32, 32), 0, stream>>>(
      partials, cfg.blocks, 2 * kC, static_cast<float*>(stats));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function returns its
// cudaError_t; 0 is success.  `bf16` selects bf16 activations and weights,
// otherwise fp32; bias, scal (the [8, 64] table: row 0 inv, row 1 shift),
// stats and scratch are fp32.  Activations are [B, T, F, 64],
// weights [kt, kf, 64, 64].  `act`: 0 no prologue, 1 mish, 2 relu.  `scratch`
// holds the per-block partial sums (conv_fused_launch_config gives its size).

extern "C" int conv_bn_act_fwd(const void* x, const void* w, const void* bias, const void* scal,
                               void* raw, void* stats, void* scratch, int B, int T, int F,
                               int kt, int kf, int dt, int act, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, w, bias, scal, raw, stats, scratch, B, T, F, kt, kf,
                                          dt, act, s)
              : launch_fwd<float>(x, w, bias, scal, raw, stats, scratch, B, T, F, kt, kf, dt, act,
                                  s);
}

// Launch shape of conv_bn_act_fwd.
extern "C" int conv_fused_launch_config(int B, int T, int F, int kt, int kf, int bf16, int* blocks,
                                        int* threads, long long* smem, long long* scratch) {
  LaunchConfig cfg;
  cudaError_t err = bf16 ? tile_config<__nv_bfloat16>(B, T, F, kt, kf, &cfg)
                         : tile_config<float>(B, T, F, kt, kf, &cfg);
  if (err != cudaSuccess) return err;
  *blocks = cfg.blocks;
  *threads = cfg.threads;
  *smem = static_cast<long long>(cfg.smem);
  *scratch = static_cast<long long>(cfg.scratch);
  return cudaSuccess;
}
