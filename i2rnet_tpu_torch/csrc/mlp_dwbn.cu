// HRFormer MlpDWBN, forward (eval, BatchNorms folded), for Hopper (sm_90a):
// Kernels F and G.
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
// bf16 tensor-core peak, 0.29 us at the memory rate -- balanced. Besides the
// products, F evaluates about 2.5 D + C GELUs per pixel (the expand's over
// the tile's halo too), each a tanhf: on the CUDA cores that work, not the
// tensor cores, bounds the bf16 kernel.
//
// Design, F in bf16 (mlp_item_mma, mlp_dwbn.cuh): one block of 256 threads per
// (output tile of TH x TW pixels, hidden slice, person). The plan
// (ops/cuda/mlp_dwbn.py::mlp_plan) takes 8x8 tiles evened out over the map
// (8x6 on 256x192's 16x12 and 8x6 maps, where the whole map is one tile),
// then the fewest slices of the D hidden channels that keep two blocks per
// SM in shared memory, and more while the grid holds fewer than two blocks
// per SM (S = 1, 2, 3, 8 on 256x192's four maps). The block loads x for the tile and its 1-pixel halo,
// cut to the map (off the map the hidden map is 0, so those pixels cost
// nothing), with every thread's loads in flight, and applies LN2 in shared
// memory, rounded to bf16 and zero-padded to 16 channels. Then for each
// 64-channel chunk of its slice:
//   - the 1x1 expand as mma.sync m16n8k16 (bf16 in, f32 accumulate), a warp
//     per 8 hidden channels over every 16-pixel row tile, A by ldmatrix from
//     shared memory, B (W1) straight from L2/L1 in a fragment-ordered layout
//     the wrapper packs once (8 coalesced bytes per lane per k-step, 4
//     k-steps in flight);
//   - + b1, GELU, rounding, into a bf16 chunk buffer;
//   - the depthwise 3x3 from the rounded values in f32 (a 3x3 window slides
//     along each row), + bdw, GELU, rounding, into the slice's bf16 buffer
//     [TH*TW][slice width] in shared memory.
// Last, the 1x1 contract of the whole slice: each warp takes output-channel
// tiles of 8 over every output row, W2's fragments likewise. So each block
// reads its slice of W1 and of W2 once, and a person's weight traffic from
// L2 scales with its number of tiles (one at 8x6). The rounding points make
// the tensor cores exact here: every product's operands are already bf16,
// so f32 accumulation changes only the order of the sums. With one slice the
// block ends with + b2, GELU, rounding, the residual and the store of the
// pixels inside the map. With S slices it writes its f32 sums to a scratch
// [S, P, H, W, C] (at most 32 MiB, so it stays in L2), and a second launch
// (mlp_finish) adds them in the order s = 0 ... S-1 and applies that
// epilogue: no atomics, the same bits every run.
//
// Design, G (mlp_item_tf32x3, mlp_dwbn.cuh; f32 on the model's path, bf16
// x in the checks): F's bf16 walk with f32 buffers. One block per (output
// tile, hidden slice, person) under its own plan (ops/cuda/mlp_dwbn.py::
// mlp32_plan: 8x8 tiles evened out over the map, the fewest slices that keep
// two blocks per SM within the slice sums' limit, else one, then more while
// the grid holds fewer than two blocks per SM). x of the box goes to shared
// memory in f32, channels padded to 8; per 64-channel chunk the expand, + b1,
// GELU into an f32 chunk buffer, the depthwise conv (f32 taps, (dy, dx)
// order), + bdw, GELU into the slice's f32 buffer; then the contract, + b2,
// GELU and one cast to T, or f32 slice sums that mlp32_finish adds in the
// order s = 0 ... S-1 (no atomics: the same bits every run). Both products
// run on the tensor cores as mma.sync m16n8k8 in TF32 with f32 sums, in three
// passes per k-step: a_lo b_hi, a_hi b_lo, a_hi b_hi, with hi = tf32(v) and
// lo = tf32(v - hi) (cvt.rna). One TF32 pass keeps 11 bits of each operand,
// about 2^-11 relative per product, which the f32 checks' 1e-4 would not
// hold; the three passes leave out only a_lo b_lo and lo's own rounding,
// about 2^-21 relative. The wrapper splits W1 and W2 once into hi and lo
// B-operand fragments (ops/cuda/mlp_dwbn.py::pack_tf32x3, 16 bytes a lane
// per k-step from L2); the A operand (x, then the conv's output) stays plain
// f32 in shared memory and is split in registers as it is read. The GELUs
// (Abramowitz-Stegun erf with expf) and the conv stay f32 on the CUDA cores.
// What bounds G on the H100: at branch 0 (P=32) its 1x1 products are 9.57
// GFLOP; as three TF32 passes at 495 TFLOP/s that is 58 us, with the
// depthwise work on the CUDA cores 66 us, against 151 us for all of it in
// f32 on the CUDA cores (67 TFLOP/s); its f32 map I/O is 2 x 30.7 MB, 18 us.
//
// Design, F in f32 (mlp_item, the CUDA-core template): one block per (tile,
// person), 8x8 tiles or 4x4 where 8x8's shared memory would hold one block
// per SM; the hidden channels in chunks of 32 (expand a lane per hidden
// channel and a warp per 4 pixels, depthwise conv, the chunk's share of the
// contract into an f32 accumulator in shared memory), products in f32 on the
// CUDA cores.
// tanhf, not tanh.approx.f32, whose error would show in the f32 checks.
// Phases 2-3 of kernel 7 (full_block.cu) run F's bodies on the same items.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mlp_dwbn.cuh"

namespace {

using bf16 = __nv_bfloat16;

// F in f32 on the CUDA-core template
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const float* __restrict__ x, const float* __restrict__ ln_g,
           const float* __restrict__ ln_b, const float* __restrict__ w1t,
           const float* __restrict__ b1, const float* __restrict__ dwt,
           const float* __restrict__ bdw, const float* __restrict__ w2t,
           const float* __restrict__ b2, float* __restrict__ out, int h, int w, int c, int dh,
           float eps, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mlp_item<float>(x, ln_g, ln_b, w1t, b1, dwt, bdw, w2t, b2, out, h, w, c, dh, eps, th, tw,
                  blockIdx.x, blockIdx.y, smem_raw);
}

// grid (tiles, slices, p)
__global__ void __launch_bounds__(kThreads, 2)
mlp_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, const uint2* __restrict__ w1f,
               const float* __restrict__ b1, const float* __restrict__ dwt,
               const float* __restrict__ bdw, const uint2* __restrict__ w2f,
               const float* __restrict__ b2, bf16* __restrict__ out, float* __restrict__ part,
               int h, int w, int c, int dh, float eps, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mlp_item_mma(x, ln_g, ln_b, w1f, b1, dwt, bdw, w2f, b2, out, part, gridDim.z, h, w, c, dh, eps,
               th, tw, gridDim.y, blockIdx.x, blockIdx.y, blockIdx.z, smem_raw);
}

__global__ void __launch_bounds__(kThreads)
mlp_finish_kernel(const bf16* __restrict__ x, const float* __restrict__ part,
                  const float* __restrict__ b2, bf16* __restrict__ out, size_t n, int c,
                  int slices) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) mlp_finish(x, part, b2, out, n, c, slices, i);
}

cudaError_t launch_f32(const void* x, const void* ln_g, const void* ln_b, const void* w1t,
                       const void* b1, const void* dwt, const void* bdw, const void* w2t,
                       const void* b2, void* out, int p, int h, int w, int c, int dh, float eps,
                       int th, int tw, cudaStream_t stream) {
  const size_t bytes = mlp_smem_bytes<float>(c, th, tw);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + th - 1) / th) * ((w + tw - 1) / tw), p);
  mlp_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const float*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(dwt),
      static_cast<const float*>(bdw), static_cast<const float*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(out), h, w, c, dh, eps, th, tw);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* x, const void* ln_g, const void* ln_b, const void* w1f,
                       const void* b1, const void* dwt, const void* bdw, const void* w2f,
                       const void* b2, void* out, void* part, int p, int h, int w, int c, int dh,
                       float eps, int th, int tw, int slices, cudaStream_t stream) {
  if (!mlp_mma_fits(c, h, w, th, tw, dh, slices) || slices > 65535 ||
      (slices > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const size_t bytes = mlp_mma_smem_bytes(c, h, w, th, tw, dh, slices);
  cudaError_t err = amma::allow_smem<mlp_mma_kernel>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + th - 1) / th) * ((w + tw - 1) / tw), slices, p);
  mlp_mma_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const uint2*>(w1f),
      static_cast<const float*>(b1), static_cast<const float*>(dwt),
      static_cast<const float*>(bdw), static_cast<const uint2*>(w2f),
      static_cast<const float*>(b2), static_cast<bf16*>(out), static_cast<float*>(part), h, w, c,
      dh, eps, th, tw);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const size_t n = (size_t)p * h * w * c;
  mlp_finish_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(part),
      static_cast<const float*>(b2), static_cast<bf16*>(out), n, c, slices);
  return cudaGetLastError();
}

// Kernel G: grid (tiles, slices, p)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mlp32_kernel(const T* __restrict__ x, const uint4* __restrict__ w1f,
             const float* __restrict__ b1, const float* __restrict__ dwt,
             const float* __restrict__ bdw, const uint4* __restrict__ w2f,
             const float* __restrict__ b2, T* __restrict__ out, float* __restrict__ part, int h,
             int w, int c, int dh, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mlp_item_tf32x3<T>(x, w1f, b1, dwt, bdw, w2f, b2, out, part, gridDim.z, h, w, c, dh, th, tw,
                     gridDim.y, blockIdx.x, blockIdx.y, blockIdx.z, smem_raw);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp32_finish_kernel(const float* __restrict__ part, const float* __restrict__ b2,
                    T* __restrict__ out, size_t n, int c, int slices) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) mlp32_finish(part, b2, out, n, c, slices, i);
}

template <typename T>
cudaError_t launch_tf32x3(const void* x, const void* w1f, const void* b1, const void* dwt,
                          const void* bdw, const void* w2f, const void* b2, void* out,
                          void* part, int p, int h, int w, int c, int dh, int th, int tw,
                          int slices, cudaStream_t stream) {
  if (!mlp32_fits(c, h, w, th, tw, dh, slices) || slices > 65535 ||
      (slices > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const size_t bytes = mlp32_smem_bytes(c, h, w, th, tw, dh, slices);
  cudaError_t err = amma::allow_smem<mlp32_kernel<T>>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + th - 1) / th) * ((w + tw - 1) / tw), slices, p);
  mlp32_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const uint4*>(w1f), static_cast<const float*>(b1),
      static_cast<const float*>(dwt), static_cast<const float*>(bdw),
      static_cast<const uint4*>(w2f), static_cast<const float*>(b2), static_cast<T*>(out),
      static_cast<float*>(part), h, w, c, dh, th, tw);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const size_t n = (size_t)p * h * w * c;
  mlp32_finish_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(b2), static_cast<T*>(out), n, c,
      slices);
  return cudaGetLastError();
}

bool bad_shape(int p, int h, int w, int c, int dh) {
  return p < 1 || p > 65535 || h < 1 || w < 1 || c < 1 || dh < 1;
}

}  // namespace

// Kernel F. x, out: [p, h, w, c] contiguous, type T (dtype 0 = float32,
// 1 = bfloat16); ln_g, ln_b [c] f32; dwt [3][3][dh], b1 [dh], bdw [dh], b2 [c]
// f32. float32: w1 = W1^T [c][dh] and w2 = W2^T [dh][c] in f32, th = tw = 0
// and slices = 1 (the CUDA-core template takes its own tile, mlp_tile);
// bfloat16: w1, w2 the B-operand fragments of W1 [dh][c] and W2 [c][dh]
// (mlp_dwbn.cuh::mlp_item_mma), the plan (ops/cuda/mlp_dwbn.py::mlp_plan:
// output tiles th x tw, `slices` hidden slices) and with slices > 1 part, an
// f32 scratch of slices * p * h * w * c. Returns the cudaError_t.
extern "C" int i2r_mlp_block_fwd(const void* x, const void* ln_g, const void* ln_b,
                                 const void* w1, const void* b1, const void* dwt,
                                 const void* bdw, const void* w2, const void* b2, void* out,
                                 void* part, int p, int h, int w, int c, int dh, int th, int tw,
                                 int slices, float eps, int dtype, void* stream) {
  if (bad_shape(p, h, w, c, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && th == 0 && tw == 0 && slices == 1) {
    const int t = mlp_tile<float>(c);
    return (int)launch_f32(x, ln_g, ln_b, w1, b1, dwt, bdw, w2, b2, out, p, h, w, c, dh, eps, t,
                           t, st);
  }
  if (dtype == 1)
    return (int)launch_mma(x, ln_g, ln_b, w1, b1, dwt, bdw, w2, b2, out, part, p, h, w, c, dh,
                           eps, th, tw, slices, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel G. x, out: [p, h, w, c] contiguous, type T (dtype 0 = float32,
// 1 = bfloat16); w1, w2: the TF32 hi and lo B-operand fragments of W1
// [dh][c] and W2 [c][dh] (mlp_dwbn.cuh::mlp_item_tf32x3,
// ops/cuda/mlp_dwbn.py::pack_tf32x3); dwt [3][3][dh], b1 [dh], bdw [dh], b2
// [c] f32; the plan (ops/cuda/mlp_dwbn.py::mlp32_plan: output tiles th x tw,
// `slices` hidden slices) and with slices > 1 part, an f32 scratch of
// slices * p * h * w * c. Returns the cudaError_t.
extern "C" int i2r_mlp_dwbn_fwd(const void* x, const void* w1, const void* b1, const void* dwt,
                                const void* bdw, const void* w2, const void* b2, void* out,
                                void* part, int p, int h, int w, int c, int dh, int th, int tw,
                                int slices, int dtype, void* stream) {
  if (bad_shape(p, h, w, c, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_tf32x3<float>(x, w1, b1, dwt, bdw, w2, b2, out, part, p, h, w, c, dh, th,
                                     tw, slices, st);
  if (dtype == 1)
    return (int)launch_tf32x3<bf16>(x, w1, b1, dwt, bdw, w2, b2, out, part, p, h, w, c, dh, th,
                                    tw, slices, st);
  return (int)cudaErrorInvalidValue;
}
