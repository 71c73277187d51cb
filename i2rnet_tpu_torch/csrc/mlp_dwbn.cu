// HRFormer MlpDWBN, forward (eval, BatchNorms folded), for Hopper (sm_90a):
// two kernels from one template.
//
// Replaces: i2rnet_tpu/ops/pallas/hrformer_block.py::mlp_block_fused
//   (Kernel F, entry i2r_mlp_block_fwd), and
// Replaces: i2rnet_tpu/ops/pallas/mlp_dwbn.py::mlp_dwbn_fused
//   (Kernel G, entry i2r_mlp_dwbn_fwd).
//
// Computes, per person on a [H, W, C] map with hidden width D = 4C,
//   F: x + T(g(T(g(dw3x3(T(g(T(LN2(x)) . W1 + b1))) + bdw)) . W2 + b2))
//      with T the activation type, weights in T, the tanh-form GELU g
//      (_gelu_tanh_erf) and the rounding points of _mlp_math (:158-185);
//   G: T(g(g(dw3x3(g(x . W1 + b1)) + bdw) . W2 + b2)) with x, weights and the
//      hidden map in f32, the Abramowitz-Stegun erf GELU g (_gelu_exact) and
//      one cast at the end (mlp_dwbn.py:73-95).
// The depthwise 3x3 reads a zero border around the H x W hidden map (zero,
// not g(b1), outside the map); its nine taps are f32, summed in (dy, dx)
// row-major order.
//
// What bounds it on the H100: per person at branch 0 of a 256x192 input
// (64x48x78, D = 312) the products are 2*3072*78*312*2 + 2*9*3072*312 =
// 0.32 GFLOP against 2*3072*78*2 B = 0.96 MB of bf16 map I/O: 0.32 us at the
// bf16 tensor-core peak, 0.29 us at the memory rate -- balanced. This kernel
// runs the products on CUDA cores in f32, so the FMA rate and the L1 and
// shared-memory reads that feed it bound it.
//
// Design: one block of 256 threads per (output tile of TH x TW pixels,
// person); the wrapper-side launcher picks 8x8, or 4x4 where 8x8's shared
// memory would hold one block per SM. The block loads the tile and its
// 1-pixel halo, LN'd (F) or as is (G), into shared memory, then walks the D
// hidden channels in chunks of 32: the 1x1 expand for tile + halo (a lane per
// hidden channel, a warp per 4 pixels, W1 read through L1), GELU and
// rounding; the depthwise 3x3 on the tile, GELU and rounding; and the
// chunk's share of the 1x1 contract added into an f32 [TH*TW, C]
// accumulator in shared memory. So the hidden map never leaves the block and
// never has to fit whole (2496 channels at 384x288's branch 3). Last: bias,
// GELU, rounding, residual (F), and the store of the pixels inside the map.
// tanhf, not tanh.approx.f32, whose error would show in the f32 checks.
// The block's work is mlp_item (mlp_dwbn.cuh), which phase 2 of kernel 7
// (full_block.cu) runs too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mlp_dwbn.cuh"

namespace {

// T: activation type of x and out; W: weight type (T for F, float for G)
template <typename T, typename W, bool kBlock>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
           const float* __restrict__ ln_b, const W* __restrict__ w1t,
           const float* __restrict__ b1, const float* __restrict__ dwt,
           const float* __restrict__ bdw, const W* __restrict__ w2t,
           const float* __restrict__ b2, T* __restrict__ out, int h, int w, int c, int dh,
           float eps, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mlp_item<T, W, kBlock>(x, ln_g, ln_b, w1t, b1, dwt, bdw, w2t, b2, out, h, w, c, dh, eps, th, tw,
                         blockIdx.x, blockIdx.y, smem_raw);
}

template <typename T, typename W, bool kBlock>
cudaError_t launch(const void* x, const void* ln_g, const void* ln_b, const void* w1t,
                   const void* b1, const void* dwt, const void* bdw, const void* w2t,
                   const void* b2, void* out, int p, int h, int w, int c, int dh, float eps,
                   cudaStream_t stream) {
  const int th = mlp_tile<T>(c), tw = th;
  const size_t bytes = mlp_smem_bytes<T>(c, th, tw);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<T, W, kBlock>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + th - 1) / th) * ((w + tw - 1) / tw), p);
  mlp_kernel<T, W, kBlock><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const W*>(w1t), static_cast<const float*>(b1), static_cast<const float*>(dwt),
      static_cast<const float*>(bdw), static_cast<const W*>(w2t), static_cast<const float*>(b2),
      static_cast<T*>(out), h, w, c, dh, eps, th, tw);
  return cudaGetLastError();
}

bool bad_shape(int p, int h, int w, int c, int dh) {
  return p < 1 || p > 65535 || h < 1 || w < 1 || c < 1 || dh < 1;
}

}  // namespace

// Kernel F. x, out: [p, h, w, c] contiguous, type T (dtype 0 = float32,
// 1 = bfloat16); ln_g, ln_b [c] f32; w1t = W1^T [c][dh] and w2t = W2^T [dh][c]
// in T; dwt [3][3][dh], b1 [dh], bdw [dh], b2 [c] f32. Returns the cudaError_t.
extern "C" int i2r_mlp_block_fwd(const void* x, const void* ln_g, const void* ln_b,
                                 const void* w1t, const void* b1, const void* dwt,
                                 const void* bdw, const void* w2t, const void* b2, void* out,
                                 int p, int h, int w, int c, int dh, float eps, int dtype,
                                 void* stream) {
  if (bad_shape(p, h, w, c, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float, float, true>(x, ln_g, ln_b, w1t, b1, dwt, bdw, w2t, b2, out, p, h, w, c,
                                     dh, eps, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16, true>(x, ln_g, ln_b, w1t, b1, dwt, bdw, w2t, b2,
                                                     out, p, h, w, c, dh, eps, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Kernel G. As Kernel F without LN and residual; every weight f32.
extern "C" int i2r_mlp_dwbn_fwd(const void* x, const void* w1t, const void* b1, const void* dwt,
                                const void* bdw, const void* w2t, const void* b2, void* out,
                                int p, int h, int w, int c, int dh, int dtype, void* stream) {
  if (bad_shape(p, h, w, c, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float, float, false>(x, nullptr, nullptr, w1t, b1, dwt, bdw, w2t, b2, out, p, h,
                                      w, c, dh, 0.f, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, float, false>(x, nullptr, nullptr, w1t, b1, dwt, bdw, w2t, b2,
                                              out, p, h, w, c, dh, 0.f, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
