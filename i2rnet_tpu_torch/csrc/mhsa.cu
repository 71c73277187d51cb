// Masked multi-head self-attention, forward (eval), for Hopper (sm_90a).
//
// Replaces: i2rnet_tpu/ops/pallas/mhsa.py::masked_mhsa_pallas.
//
// Computes, per (batch*head) and query row,
//     out = softmax(q * scale . K^T + bias) . V
// with bias = -1e30 at padded keys (key_padding_mask true) and 0 elsewhere,
// softmax and accumulation in f32, output cast to the input type.
//
// What bounds it on the H100: at the main-path shape (B=8 images, S=N*192=1344
// tokens, head dim 96, one head) the two products are 2*2*8*1344^2*96 = 5.5
// GFLOP while q, k, v and out are only 4*8*1344*96*2 B = 8.3 MB in bf16, so
// the kernel is bound by arithmetic, not by device memory. The [S, S] logits
// (58 MB in f32 at that shape) are what must stay out of device memory.
//
// Design (simple and right first; wgmma, TMA and mma.sync are later work):
// one block of 256 threads per (batch*head, 64-query tile). The block loops
// over 64-key tiles of K and V staged in shared memory (f32), keeping an
// online softmax: running max and sum per query row in f32, the running max
// initialised to the finite -1e30. A fully padded row therefore sees every
// logit equal to -1e30, gets exp(0) = 1 for each real key and ends as the
// uniform average over its S keys -- finite, as masked_mhsa_xla gives it.
// Keys past S (the ragged edge of the last tile) get weight exactly 0. Four
// threads share a query row: each holds 16 of the tile's 64 logits and a
// quarter of the output row; row max and sum reduce over the four lanes with
// warp shuffles. The logits never leave the SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 4 threads per query row
constexpr int kLdP = kBlockK + 1;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// DT: head-dim tile, a multiple of 4 and >= d. Row stride DT + 1 keeps the
// four lanes of a row, and the eight rows of a warp, on distinct banks.
template <int DT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(3 * kBlockQ * (DT + 1) + kBlockQ * kLdP + kBlockK);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
mhsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const uint8_t* __restrict__ key_pad, T* __restrict__ out,
                int s, int d, int heads, float scale) {
  constexpr int LD = DT + 1;
  constexpr int NJ = kBlockK / 4;  // logits per thread per tile
  constexpr int NO = DT / 4;       // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBlockQ][LD], pre-scaled
  float* ks = qs + kBlockQ * LD;      // [kBlockK][LD]
  float* vs = ks + kBlockK * LD;      // [kBlockK][LD]
  float* ps = vs + kBlockK * LD;      // [kBlockQ][kLdP]
  float* bias = ps + kBlockQ * kLdP;  // [kBlockK]

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)bh * s * d;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int quarter = tid & 3;

  for (int i = tid; i < kBlockQ * DT; i += kThreads) {
    const int r = i / DT, c = i % DT, qr = q0 + r;
    qs[r * LD + c] = (qr < s && c < d) ? to_f32(q[base + (size_t)qr * d + c]) * scale : 0.f;
  }

  float m = kNegBig, l = 0.f;
  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < s; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K/V readers are done
    for (int i = tid; i < kBlockK * DT; i += kThreads) {
      const int r = i / DT, c = i % DT, kr = k0 + r;
      const bool in = kr < s && c < d;
      ks[r * LD + c] = in ? to_f32(k[base + (size_t)kr * d + c]) : 0.f;
      vs[r * LD + c] = in ? to_f32(v[base + (size_t)kr * d + c]) : 0.f;
    }
    if (tid < kBlockK) {
      const int kr = k0 + tid;
      bias[tid] = kr >= s ? -INFINITY
                          : ((key_pad != nullptr && key_pad[(size_t)b * s + kr]) ? kNegBig : 0.f);
    }
    __syncthreads();

    float sc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) sc[j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qv = qs[row * LD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[j] += qv * ks[(quarter + 4 * j) * LD + c];
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      sc[j] += bias[quarter + 4 * j];
      tmax = fmaxf(tmax, sc[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);  // finite: m starts at -1e30
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
      ps[row * kLdP + quarter + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] *= alpha;
    __syncwarp();  // a row's probabilities are written and read by its own 4 lanes

    for (int kk = 0; kk < kBlockK; ++kk) {
      const float p = ps[row * kLdP + kk];
      const float* vr = vs + kk * LD + quarter;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[j] += p * vr[4 * j];
    }
  }

  const int qr = q0 + row;
  if (qr < s) {
    T* orow = out + base + (size_t)qr * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = quarter + 4 * j;
      if (c < d) orow[c] = from_f32<T>(acc[j] / l);
    }
  }
}

template <typename T, int DT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_pad, void* out,
                   int bh, int s, int d, int heads, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DT>();
  cudaError_t err = cudaFuncSetAttribute(mhsa_fwd_kernel<T, DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  mhsa_fwd_kernel<T, DT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_pad), static_cast<T*>(out), s, d, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dt(const void* q, const void* k, const void* v, const void* key_pad,
                        void* out, int bh, int s, int d, int heads, float scale,
                        cudaStream_t stream) {
  if (d <= 32) return launch<T, 32>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
  if (d <= 96) return launch<T, 96>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
  return launch<T, 128>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
}

}  // namespace

// q, k, v, out: [bh, s, d] contiguous, heads folded into the batch (bh = B*heads).
// key_pad: [B, s] bytes, nonzero = padded key; may be null (no mask).
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int i2r_mhsa_fwd(const void* q, const void* k, const void* v, const void* key_pad,
                            void* out, int bh, int s, int d, int heads, float scale, int dtype,
                            void* stream) {
  if (bh < 1 || s < 1 || d < 1 || d > 128 || heads < 1 || bh % heads != 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dt<float>(q, k, v, key_pad, out, bh, s, d, heads, scale, st);
  else if (dtype == 1)
    err = dispatch_dt<__nv_bfloat16>(q, k, v, key_pad, out, bh, s, d, heads, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
