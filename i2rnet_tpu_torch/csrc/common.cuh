// Helpers shared by the kernel sources: the block shape, the activation-type
// conversions, warp reductions, and the fixed-order reductions that turn
// per-token operands into weight and vector gradients without atomics.
//
// Everything sits in the unnamed namespace, so each translation unit that
// includes this file has its own copy (no link-time symbol clashes between
// the kernel sources).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use on the H100

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the value of x once stored in T
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

constexpr int kOuterTile = 32;    // dW tile edge and row step of the reduction
constexpr int kOuterSplits = 16;  // row slices of the dW reduction

// part[z][i][j] = sum over rows r of slice z of a[r][i] * b[r][j]; a [rows][m],
// b [rows][n]; one 32x32 output tile per block, 8 rows x 4 outputs per thread.
template <typename T>
__global__ void __launch_bounds__(256)
outer_sum_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ part,
                 int rows, int m, int n, int rows_per_split) {
  __shared__ float as[kOuterTile][kOuterTile + 1];
  __shared__ float bs[kOuterTile][kOuterTile + 1];
  const int i0 = blockIdx.y * kOuterTile, j0 = blockIdx.x * kOuterTile;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r0 = r_begin; r0 < r_end; r0 += kOuterTile) {
    for (int e = threadIdx.x; e < kOuterTile * kOuterTile; e += 256) {
      const int rr = e / kOuterTile, cc = e % kOuterTile, r = r0 + rr;
      const bool in_r = r < r_end;
      as[rr][cc] = (in_r && i0 + cc < m) ? to_f32(a[(size_t)r * m + i0 + cc]) : 0.f;
      bs[rr][cc] = (in_r && j0 + cc < n) ? to_f32(b[(size_t)r * n + j0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kOuterTile; ++rr) {
      const float bv = bs[rr][tx];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += as[rr][ty + 8 * u] * bv;
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  if (j >= n) return;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 8 * u;
    if (i < m) part[((size_t)blockIdx.z * m + i) * n + j] = acc[u];
  }
}

// out[e] = scale * sum over k < parts of part[k * stride + e], in order
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int parts, int n, int stride, float scale) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int k = 0; k < parts; ++k) acc += part[(size_t)k * stride + e];
  out[e] = scale * acc;
}

cudaError_t sum_parts(const float* part, float* out, int parts, int n, int stride, float scale,
                      cudaStream_t st) {
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, parts, n, stride, scale);
  return cudaGetLastError();
}

// out [m][n] = scale * sum over rows of a[r][i] * b[r][j], in a fixed order:
// kOuterSplits row slices into part [kOuterSplits][m][n], then their sum.
template <typename T>
cudaError_t outer_sum(const void* a, const void* b, float* part, float* out, int rows, int m,
                      int n, float scale, cudaStream_t st) {
  const int per = ((rows + kOuterSplits - 1) / kOuterSplits + kOuterTile - 1) / kOuterTile *
                  kOuterTile;
  const int splits = (rows + per - 1) / per;
  dim3 grid((n + kOuterTile - 1) / kOuterTile, (m + kOuterTile - 1) / kOuterTile, splits);
  outer_sum_kernel<T><<<grid, 256, 0, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                            part, rows, m, n, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_parts(part, out, splits, m * n, m * n, scale, st);
}

}  // namespace
