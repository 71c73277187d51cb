// The epilogue of an eval conv unit (conv -> BatchNorm [-> + residual] [-> ReLU]),
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel. On the TPU, XLA fused the BatchNorm's multiply-add,
// the residual add and the ReLU into the convolution's epilogue; PyTorch's
// eager convolution cannot take them, so the port ran each as a pass of its own
// over the conv output. The eval path now folds the BatchNorm's scale into the
// convolution's weights (models/layers.py::fold_bn) and this kernel finishes the
// unit in one pass over the channels-last conv output y [N, H, W, C]:
//     out = act(y + bias[c] (+ residual))
// with bias = bn.bias - running_mean * scale in f32, the sum in f32, and one
// rounding to the output type (bf16 or f32). The residual and the ReLU are
// compile-time variants.
//
// What bounds it on the H100: device memory. It reads y (and the residual)
// and writes out once, with an add or two per element: at the W48 trunk's
// serving shapes (5120 crops of 256x192 a forward) a launch moves 0.19-24 GB
// in bf16, 56 us to 7.2 ms at 3.35 TB/s.
//
// Design: the tensor is walked as one flat array of V-element vectors along C
// (16-byte loads and stores where C and the pointers allow: V = 8 in bf16,
// 4 in f32; narrower for a C that is not a multiple of that, such as
// HRFormer's 78), a grid-stride loop over a grid that fills every SM once
// (8 blocks of 256 threads), so each block loads the C biases into shared
// memory once. A vector never straddles two pixels, since V divides C; each
// thread keeps the channel of its next vector as a running offset (no 64-bit
// division in the loop).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kEpiThreads = 256;
constexpr int kEpiBlocksPerSm = 8;  // 2048 threads: an SM's full occupancy
constexpr int kEpiMaxC = 12288;     // the biases in 48 KB of static-size shared memory

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

template <typename T, int V, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kEpiThreads)
    conv_epilogue_kernel(const T* __restrict__ y, const float* __restrict__ bias,
                         const T* __restrict__ res, T* __restrict__ out, long long n_vec, int c) {
  extern __shared__ float sb[];
  for (int i = threadIdx.x; i < c; i += blockDim.x) sb[i] = bias[i];
  __syncthreads();
  using P = Pack<T, V>;
  const P* yv = reinterpret_cast<const P*>(y);
  const P* rv = reinterpret_cast<const P*>(res);
  P* ov = reinterpret_cast<P*>(out);
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int ch = (int)((v * V) % c);
  const int step = (int)((stride * V) % c);
  for (; v < n_vec; v += stride) {
    const P a = yv[v];
    P r;
    if (kRes) r = rv[v];
    P o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float f = to_f32(a.x[k]) + sb[ch + k];
      if (kRes) f += to_f32(r.x[k]);
      if (kRelu) f = f < 0.f ? 0.f : f;  // NaN stays NaN, as torch.relu
      o.x[k] = from_f32<T>(f);
    }
    ov[v] = o;
    ch += step;
    if (ch >= c) ch -= c;
  }
}

template <typename T, int V>
cudaError_t launch_v(const void* y, const float* bias, const void* res, void* out, long long n,
                     int c, bool relu, int sms, cudaStream_t st) {
  const long long n_vec = n / V;
  const long long want = (n_vec + kEpiThreads - 1) / kEpiThreads;
  const long long full = (long long)sms * kEpiBlocksPerSm;
  const int grid = (int)(want < full ? want : full);
  const size_t smem = sizeof(float) * c;
  const T* yt = static_cast<const T*>(y);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (res != nullptr && relu)
    conv_epilogue_kernel<T, V, true, true><<<grid, kEpiThreads, smem, st>>>(yt, bias, rt, ot, n_vec, c);
  else if (res != nullptr)
    conv_epilogue_kernel<T, V, true, false><<<grid, kEpiThreads, smem, st>>>(yt, bias, rt, ot, n_vec, c);
  else if (relu)
    conv_epilogue_kernel<T, V, false, true><<<grid, kEpiThreads, smem, st>>>(yt, bias, rt, ot, n_vec, c);
  else
    conv_epilogue_kernel<T, V, false, false><<<grid, kEpiThreads, smem, st>>>(yt, bias, rt, ot, n_vec, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* y, const float* bias, const void* res, void* out, long long n,
                   int c, bool relu, int vec, int sms, cudaStream_t st) {
  switch (vec) {
    case 1: return launch_v<T, 1>(y, bias, res, out, n, c, relu, sms, st);
    case 2: return launch_v<T, 2>(y, bias, res, out, n, c, relu, sms, st);
    case 4: return launch_v<T, 4>(y, bias, res, out, n, c, relu, sms, st);
    case 8:
      if constexpr (sizeof(T) == 2) return launch_v<T, 8>(y, bias, res, out, n, c, relu, sms, st);
      return cudaErrorInvalidValue;  // f32 vectors stop at 16 bytes
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y, residual (nullptr for none) and out: [rows, c] in the activation type
// (dtype 0 f32, 1 bf16), each pointer aligned to vec elements; bias: [c] f32.
// vec divides c (1, 2, 4, or 8 in bf16).
extern "C" int i2r_conv_epilogue(const void* y, const void* bias, const void* residual,
                                 void* out, int rows, int c, int relu, int vec, int dtype,
                                 int sms, void* stream) {
  if (rows < 1 || c < 1 || c > kEpiMaxC || vec < 1 || c % vec != 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * c;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(y, b, residual, out, n, c, relu != 0, vec, sms, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(y, b, residual, out, n, c, relu != 0, vec, sms, st);
  return (int)cudaErrorInvalidValue;
}
