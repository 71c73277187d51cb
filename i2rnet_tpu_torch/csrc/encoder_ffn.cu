// Post-norm DETR encoder FFN tail, forward (eval), for Hopper (sm_90a).
//
// Replaces: i2rnet_tpu/ops/pallas/encoder_ffn.py::encoder_ffn_fused.
//
// Computes, per token row x of width C,
//     n   = LN1(x)                                  (f32 statistics, eps)
//     h   = T(relu(T(n) . W1^T + b1))               (f32 accumulation)
//     out = T(LN2(n + h . W2^T + b2))               (residual on the f32 n)
// where T() rounds to the activation type -- the casting points of
// _ffn_jnp (encoder_ffn.py:60-74), which the Pallas kernel shares.
//
// What bounds it on the H100: at the main-path shape (rows = 8*1344 = 10752,
// C = 96, F = 192) the products are 2*2*10752*96*192 = 0.79 GFLOP against
// 2*10752*96*2 B = 4.1 MB of activations in bf16, plus 74 KB of weights. The
// weights are reread by every row, so what bounds a simple kernel is the
// shared-memory bandwidth of those reads, not device memory.
//
// Design: W1, W2 (transposed to [in][out] while loading, so the 32 lanes of a
// warp read 32 consecutive outputs), b1, b2 and both LayerNorms' parameters
// are loaded into dynamic shared memory once per block (74 KB in bf16, 147 KB
// in f32). Each warp then walks rows: LN1 with warp-shuffle reductions,
// linear1 + ReLU with one output column per lane, linear2 + residual, LN2,
// store. The row's intermediates live in a per-warp shared scratch, so any C
// and F whose weights fit shared memory are taken. The grid is sized by the
// wrapper to a few blocks per SM, each walking many rows, so the weight load
// is paid once per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the value of x once stored in T (the kernel's cast points), kept as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
size_t smem_bytes(int c, int f) {
  return 2 * sizeof(T) * (size_t)c * f          // W1^T, W2^T
         + sizeof(float) * (size_t)(f + 5 * c)  // b1, b2, LN1 and LN2 scale/bias
         + sizeof(float) * (size_t)kWarps * (2 * c + f);  // per-warp n, T(n), h
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
encoder_ffn_kernel(const T* __restrict__ x, const float* __restrict__ ln1_w,
                   const float* __restrict__ ln1_b, const T* __restrict__ w1,
                   const float* __restrict__ b1, const T* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ ln2_w,
                   const float* __restrict__ ln2_b, T* __restrict__ out, int rows, int c,
                   int f, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w1t = reinterpret_cast<T*>(smem_raw);  // [c][f]
  T* w2t = w1t + (size_t)c * f;             // [f][c]
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
    const T* xr = x + (size_t)r * c;
    float sum = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float xv = to_f32(xr[i]);
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
      nb[i] = round_to<T>(n);
    }
    __syncwarp();

    for (int o = lane; o < f; o += 32) {
      float a = 0.f;
      for (int i = 0; i < c; ++i) a += nb[i] * to_f32(w1t[(size_t)i * f + o]);
      hs[o] = round_to<T>(fmaxf(a + sb1[o], 0.f));
    }
    __syncwarp();

    float zsum = 0.f;
    for (int o = lane; o < c; o += 32) {
      float a = 0.f;
      for (int i = 0; i < f; ++i) a += hs[i] * to_f32(w2t[(size_t)i * c + o]);
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
    T* orow = out + (size_t)r * c;
    for (int i = lane; i < c; i += 32)
      orow[i] = from_f32<T>((nf[i] - mean2) * rstd2 * g2[i] + be2[i]);
    __syncwarp();  // nf/nb/hs are rewritten by the next row
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* ln1_w, const void* ln1_b, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* ln2_w,
                   const void* ln2_b, void* out, int rows, int c, int f, float eps, int grid,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(c, f);
  cudaError_t err = cudaFuncSetAttribute(encoder_ffn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  encoder_ffn_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln1_w),
      static_cast<const float*>(ln1_b), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<const float*>(ln2_w),
      static_cast<const float*>(ln2_b), static_cast<T*>(out), rows, c, f, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, c] contiguous, type T (dtype 0 = float32, 1 = bfloat16).
// w1: [f, c] and w2: [c, f] in T (torch Linear layout); b1 [f], b2 [c], LayerNorm
// scales and biases [c] in float32. Returns the cudaError_t of the launch.
extern "C" int i2r_encoder_ffn_fwd(const void* x, const void* ln1_w, const void* ln1_b,
                                   const void* w1, const void* b1, const void* w2, const void* b2,
                                   const void* ln2_w, const void* ln2_b, void* out, int rows,
                                   int c, int f, float eps, int dtype, int grid, void* stream) {
  if (rows < 1 || c < 1 || f < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b, out, rows, c, f, eps,
                        grid, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b, out, rows, c, f,
                                eps, grid, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
