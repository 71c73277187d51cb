// Post-norm DETR encoder FFN tail, forward (eval), for Hopper (sm_90a).
//
// Replaces: i2rnet_tpu/ops/pallas/encoder_ffn.py::encoder_ffn_fused.
//
// Computes, per token row x of width C,
//     n   = LN1(x)                                  (f32 statistics, eps)
//     h   = T(relu(T(n) . T(W1)^T + b1))            (f32 accumulation)
//     out = T(LN2(n + h . T(W2)^T + b2))            (residual on the f32 n)
// where T() rounds to the activation type -- the casting points of
// _ffn_jnp (encoder_ffn.py:60-74), which the Pallas kernel shares.
//
// What bounds it on the H100: at the main-path shape (rows = 16*1344 = 21504,
// C = 96, F = 192) the products are 2*2*21504*96*192 = 1.6 GFLOP (1.6 us on
// the tensor cores) against 2*21504*96*2 B = 8.3 MB of activations (2.5 us
// of device memory): memory, once the products are on the tensor cores.
//
// Design, bf16 (ffn_tile.cuh, shared with Kernel D's forward): warps of 16
// rows spread over every SM, 4 to a block; W1 and W2 rounded to bf16 into
// shared memory once per block; both products on mma.sync per 64-column
// chunk of F, the hidden activation kept in registers between them; LN1,
// the residual and LN2 in the mma fragments' layout. The launch plan is
// ops/cuda/encoder_ffn.py::ffn_plan.
//
// Design, f32 (the first CUDA-core template; TF32 would not hold the f32
// checks' 1e-4): W1, W2 (transposed to [in][out] while loading, so the 32
// lanes of a warp read 32 consecutive outputs), b1, b2 and both LayerNorms'
// parameters are loaded into dynamic shared memory once per block (147 KB
// at C=96, F=192). Each warp then walks rows: LN1 with warp-shuffle
// reductions, linear1 + ReLU with one output column per lane, linear2 +
// residual, LN2, store. The row's intermediates live in a per-warp shared
// scratch. The grid is sized by the wrapper to a few blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "ffn_tile.cuh"

namespace {

size_t smem_bytes(int c, int f) {
  return 2 * sizeof(float) * (size_t)c * f              // W1^T, W2^T
         + sizeof(float) * (size_t)(f + 5 * c)            // b1, b2, LN1 and LN2 scale/bias
         + sizeof(float) * (size_t)kWarps * (2 * c + f);  // per-warp n, n, h
}

__global__ void __launch_bounds__(kThreads)
encoder_ffn_kernel(const float* __restrict__ x, const float* __restrict__ ln1_w,
                   const float* __restrict__ ln1_b, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ ln2_w,
                   const float* __restrict__ ln2_b, float* __restrict__ out, int rows, int c,
                   int f, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1t = reinterpret_cast<float*>(smem_raw);  // [c][f]
  float* w2t = w1t + (size_t)c * f;                 // [f][c]
  float* p = reinterpret_cast<float*>(w2t + (size_t)c * f);
  float* sb1 = p;
  float* sb2 = sb1 + f;
  float* g1 = sb2 + c;
  float* be1 = g1 + c;
  float* g2 = be1 + c;
  float* be2 = g2 + c;
  float* scratch = be2 + c;

  // w1 is torch's linear1.weight [f][c], w2 is linear2.weight [c][f]
  for (int i = threadIdx.x; i < f * c; i += kThreads) {
    const int o = i / c, in = i % c;
    w1t[(size_t)in * f + o] = w1[i];
  }
  for (int i = threadIdx.x; i < c * f; i += kThreads) {
    const int o = i / f, in = i % f;
    w2t[(size_t)in * c + o] = w2[i];
  }
  for (int i = threadIdx.x; i < f; i += kThreads) sb1[i] = b1[i];
  for (int i = threadIdx.x; i < c; i += kThreads) {
    sb2[i] = b2[i];
    g1[i] = ln1_w[i];
    be1[i] = ln1_b[i];
    g2[i] = ln2_w[i];
    be2[i] = ln2_b[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* nf = scratch + (size_t)warp * (2 * c + f);  // n in f32, then z = n + y
  float* nb = nf + c;                                // T(n)
  float* hs = nb + c;                                // T(relu(...))
  const float fc = (float)c;

  for (int r = blockIdx.x * kWarps + warp; r < rows; r += gridDim.x * kWarps) {
    const float* xr = x + (size_t)r * c;
    float sum = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float xv = xr[i];
      nf[i] = xv;
      sum += xv;
    }
    const float mean1 = warp_sum(sum) / fc;
    float sq = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float dlt = nf[i] - mean1;
      sq += dlt * dlt;
    }
    const float rstd1 = rsqrtf(warp_sum(sq) / fc + eps);
    for (int i = lane; i < c; i += 32) {
      const float n = (nf[i] - mean1) * rstd1 * g1[i] + be1[i];
      nf[i] = n;
      nb[i] = n;
    }
    __syncwarp();

    for (int o = lane; o < f; o += 32) {
      float a = 0.f;
      for (int i = 0; i < c; ++i) a += nb[i] * w1t[(size_t)i * f + o];
      hs[o] = fmaxf(a + sb1[o], 0.f);
    }
    __syncwarp();

    float zsum = 0.f;
    for (int o = lane; o < c; o += 32) {
      float a = 0.f;
      for (int i = 0; i < f; ++i) a += hs[i] * w2t[(size_t)i * c + o];
      const float z = nf[o] + (a + sb2[o]);
      nf[o] = z;
      zsum += z;
    }
    const float mean2 = warp_sum(zsum) / fc;
    float sq2 = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float dlt = nf[i] - mean2;
      sq2 += dlt * dlt;
    }
    const float rstd2 = rsqrtf(warp_sum(sq2) / fc + eps);
    float* orow = out + (size_t)r * c;
    for (int i = lane; i < c; i += 32)
      orow[i] = (nf[i] - mean2) * rstd2 * g2[i] + be2[i];
    __syncwarp();  // nf/nb/hs are rewritten by the next row
  }
}

cudaError_t launch(const void* x, const void* ln1_w, const void* ln1_b, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* ln2_w,
                   const void* ln2_b, void* out, int rows, int c, int f, float eps, int grid,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(c, f);
  cudaError_t err = cudaFuncSetAttribute(encoder_ffn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  encoder_ffn_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln1_w),
      static_cast<const float*>(ln1_b), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<const float*>(ln2_w),
      static_cast<const float*>(ln2_b), static_cast<float*>(out), rows, c, f, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, c] contiguous, type T (dtype 0 = float32, 1 = bfloat16).
// w1: [f, c] and w2: [c, f] (torch Linear layout), b1 [f], b2 [c], LayerNorm
// scales and biases [c], all float32 (the bf16 body rounds the weights as it
// loads them). grid: the blocks walking the rows (bf16: ffn_plan's grid).
// Returns the cudaError_t of the launch.
extern "C" int i2r_encoder_ffn_fwd(const void* x, const void* ln1_w, const void* ln1_b,
                                   const void* w1, const void* b1, const void* w2, const void* b2,
                                   const void* ln2_w, const void* ln2_b, void* out, int rows,
                                   int c, int f, float eps, int dtype, int grid, void* stream) {
  if (rows < 1 || c < 1 || f < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch(x, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b, out, rows, c, f, eps, grid,
                       st);
  if (dtype == 1) {
    const Params p{static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
                   static_cast<const float*>(w1),    static_cast<const float*>(b1),
                   static_cast<const float*>(w2),    static_cast<const float*>(b2),
                   static_cast<const float*>(ln2_w), static_cast<const float*>(ln2_b)};
    const Dropout none{nullptr, nullptr, 0u, 0u, 0u, 1.f, 0};
    return (int)ffn::launch_fwd(x, p, out, rows, c, f, eps, grid, none, st);
  }
  return (int)cudaErrorInvalidValue;
}
