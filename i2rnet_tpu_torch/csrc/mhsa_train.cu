// Masked multi-head self-attention with attention-weight dropout, training
// forward and backward, for Hopper (sm_90a).
//
// Replaces: i2rnet_tpu/ops/pallas/mhsa_train.py::masked_mhsa_train.
//
// Computes, per (batch*head) and query row i,
//     p   = softmax(q_i . K^T * scale + bias)     (bias -1e30 at padded keys)
//     pd  = keep ? p / (1 - rate) : 0             (keep: dropout bits >= threshold)
//     out = T(pd) . V                             (f32 accumulation)
// and the backward dQ, dK, dV, with the casting points of mhsa_train.py:
// T(pd) before . V and dV, T(dl) before the dQ and dK products, dK and dV
// accumulated in f32 and cast at the end (T = the activation type).
//
// What bounds it on the H100: at the main-path shape (B=8 images, S=1344
// tokens, head dim 96, one head) the forward's products are 2*2*8*1344^2*96
// = 5.5 GFLOP (plus the logits a second time, below) and the backward's four
// = 11 GFLOP, against 8 MB of q, k, v, out in bf16. Arithmetic bounds it, and
// what must stay out of device memory is the [S, S] probability matrix (58 MB
// in f32 per layer), three times per layer in a plain version.
//
// Design (simple and right first: shared-memory tiles and CUDA-core FMAs, as
// mhsa.cu; tensor cores are later work). Not the Pallas design, which holds a
// whole [256, S] row tile and whole K/V in VMEM and accumulates dK/dV along a
// sequential grid:
// * forward, one block per (batch*head, 64 queries), two passes over 64-key
//   tiles: the first finds each row's max m and sum l, the second forms the
//   exact normalised p (so T(pd) rounds where the JAX kernel rounds), drops,
//   and accumulates T(pd) . V. It saves m, l and the f32 output O;
// * backward: D_i = rowsum(dO o O) from the f32 O (the identity
//   sum_j p_j dp_j = dO . O holds with dropout); one kernel per 64-key tile
//   that loops over query tiles for dK and dV, one per 64-query tile that
//   loops over key tiles for dQ. Each output is summed by one block in a
//   fixed order: deterministic, no atomics. p is recomputed from m and l with
//   the forward's own arithmetic, bit for bit;
// * dropout bits: an explicit [B*H, S, S] uint32 tensor (tests, parity), or
//   Philox4x32-10 keyed by (seed, offset) and counted by (key, query, b*H+h)
//   (philox.cuh), regenerated in the backward: nothing S x S is stored;
// * four threads share a row of a 64x64 tile, 16 logits each; row max and
//   sum reduce over the four lanes with shuffles. Padded keys get the finite
//   -1e30 and the running max starts at -1e30, so a fully padded image is
//   uniform over its S keys, finite; keys past S get -inf, weight exactly 0,
//   in both directions; query rows past S carry m = +inf, so p = 0 there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBlock = 64;     // rows of a block's own tile and of each streamed tile
constexpr int kThreads = 256;  // 4 threads per row
constexpr int kNJ = kBlock / 4;
constexpr int kLdP = kBlock + 1;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Dropout {
  const uint32_t* bits;  // [bh, s, s] (mode 1)
  uint32_t seed, offset, threshold;
  float inv;             // 1 / (1 - rate)
  int mode;              // 0 none, 1 bits, 2 seed
};

// True where the element (bh, row, col) is dropped; row and col < s.
__device__ __forceinline__ bool dropped(const Dropout& dp, int bh, int row, int col, int s) {
  const uint32_t u = dp.mode == 1 ? dp.bits[((size_t)bh * s + row) * s + col]
                                  : i2r::philox_word0(dp.seed, dp.offset, (uint32_t)col,
                                                      (uint32_t)row, (uint32_t)bh);
  return u < dp.threshold;
}

// rows [r0, r0 + kBlock) of a [s, d] matrix into a [kBlock][DT + 1] f32 tile,
// zero outside
template <typename T, int DT>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int s, int d,
                                          int tid) {
  for (int i = tid; i < kBlock * DT; i += kThreads) {
    const int r = i / DT, c = i % DT, gr = r0 + r;
    dst[r * (DT + 1) + c] = (gr < s && c < d) ? to_f32(src[(size_t)gr * d + c]) : 0.f;
  }
}

__device__ __forceinline__ float key_bias(const uint8_t* key_pad, int b, int kr, int s) {
  return kr >= s ? -INFINITY : ((key_pad != nullptr && key_pad[(size_t)b * s + kr]) ? kNegBig : 0.f);
}

template <int DT>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (size_t)(3 * kBlock * (DT + 1) + kBlock * kLdP + kBlock);
}

template <int DT>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kBlock * (DT + 1) + 2 * kBlock * kLdP + 3 * kBlock);
}

template <int DT>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kBlock * (DT + 1) + kBlock * kLdP + kBlock);
}

// logits of one query row against the 16 keys quarter + 4j of a key tile
template <int DT>
__device__ __forceinline__ void row_logits(float (&sc)[kNJ], const float* qrow, const float* ks,
                                           const float* bias, int quarter, int d, float scale) {
  constexpr int LD = DT + 1;
#pragma unroll
  for (int j = 0; j < kNJ; ++j) sc[j] = 0.f;
  for (int c = 0; c < d; ++c) {
    const float qv = qrow[c];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) sc[j] += qv * ks[(quarter + 4 * j) * LD + c];
  }
#pragma unroll
  for (int j = 0; j < kNJ; ++j) sc[j] = sc[j] * scale + bias[quarter + 4 * j];
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
mhsa_train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ key_pad, T* __restrict__ out,
                      float* __restrict__ out32, float* __restrict__ row_m,
                      float* __restrict__ row_l, int s, int d, int heads, float scale,
                      Dropout dp) {
  constexpr int LD = DT + 1;
  constexpr int NO = DT / 4;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBlock][LD]
  float* ks = qs + kBlock * LD;      // [kBlock][LD]
  float* vs = ks + kBlock * LD;      // [kBlock][LD]
  float* ps = vs + kBlock * LD;      // [kBlock][kLdP]
  float* bias = ps + kBlock * kLdP;  // [kBlock]

  const int bh = blockIdx.y, b = bh / heads, q0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * s * d;
  const int tid = threadIdx.x, row = tid >> 2, quarter = tid & 3, qr = q0 + row;

  load_rows<T, DT>(qs, q + base, q0, s, d, tid);

  // pass 1: the row's max and sum
  float m = kNegBig, l = 0.f;
  for (int k0 = 0; k0 < s; k0 += kBlock) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, DT>(ks, k + base, k0, s, d, tid);
    if (tid < kBlock) bias[tid] = key_bias(key_pad, b, k0 + tid, s);
    __syncthreads();
    float sc[kNJ];
    row_logits<DT>(sc, qs + row * LD, ks, bias, quarter, d, scale);
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) tmax = fmaxf(tmax, sc[j]);
    const float m_new = fmaxf(m, quad_max(tmax));  // finite: m starts at -1e30
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) psum += expf(sc[j] - m_new);
    l = l * expf(m - m_new) + quad_sum(psum);
    m = m_new;
  }

  // pass 2: exact probabilities, dropout, T(pd) . V
  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < s; k0 += kBlock) {
    __syncthreads();
    load_rows<T, DT>(ks, k + base, k0, s, d, tid);
    load_rows<T, DT>(vs, v + base, k0, s, d, tid);
    if (tid < kBlock) bias[tid] = key_bias(key_pad, b, k0 + tid, s);
    __syncthreads();
    float sc[kNJ];
    row_logits<DT>(sc, qs + row * LD, ks, bias, quarter, d, scale);
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = quarter + 4 * j, kc = k0 + col;
      float p = expf(sc[j] - m) / l;
      if (dp.mode != 0 && qr < s && kc < s) p = dropped(dp, bh, qr, kc, s) ? 0.f : p * dp.inv;
      ps[row * kLdP + col] = round_to<T>(p);
    }
    __syncwarp();  // a row's probabilities are written and read by its own 4 lanes
    for (int kk = 0; kk < kBlock; ++kk) {
      const float p = ps[row * kLdP + kk];
      const float* vr = vs + kk * LD + quarter;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[j] += p * vr[4 * j];
    }
  }

  if (qr < s) {
    const size_t o = base + (size_t)qr * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = quarter + 4 * j;
      if (c < d) {
        out[o + c] = from_f32<T>(acc[j]);
        out32[o + c] = acc[j];
      }
    }
    if (quarter == 0) {
      row_m[(size_t)bh * s + qr] = m;
      row_l[(size_t)bh * s + qr] = l;
    }
  }
}

// D_i = sum_c dO[i, c] * O[i, c], one warp per row
template <typename T>
__global__ void rowdot_kernel(const T* __restrict__ dout, const float* __restrict__ out32,
                              float* __restrict__ row_d, int rows, int d) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (r >= rows) return;  // uniform across the warp
  float a = 0.f;
  for (int c = lane; c < d; c += 32) a += to_f32(dout[(size_t)r * d + c]) * out32[(size_t)r * d + c];
  a = warp_sum(a);
  if (lane == 0) row_d[r] = a;
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
mhsa_train_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const uint8_t* __restrict__ key_pad, const T* __restrict__ dout,
                       const float* __restrict__ row_m, const float* __restrict__ row_l,
                       const float* __restrict__ row_d, T* __restrict__ dk, T* __restrict__ dv,
                       int s, int d, int heads, float scale, Dropout dp) {
  constexpr int LD = DT + 1;
  constexpr int NO = DT / 4;
  extern __shared__ float smem[];
  float* ks = smem;                  // this block's keys [kBlock][LD]
  float* vs = ks + kBlock * LD;
  float* qs = vs + kBlock * LD;      // the streamed query tile
  float* gs = qs + kBlock * LD;      // its dO
  float* ps = gs + kBlock * LD;      // T(pd) [key][query]
  float* ds = ps + kBlock * kLdP;    // T(dl) [key][query]
  float* mrow = ds + kBlock * kLdP;
  float* lrow = mrow + kBlock;
  float* drow = lrow + kBlock;

  const int bh = blockIdx.y, b = bh / heads, k0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * s * d;
  const int tid = threadIdx.x, row = tid >> 2, quarter = tid & 3, kr = k0 + row;

  load_rows<T, DT>(ks, k + base, k0, s, d, tid);
  load_rows<T, DT>(vs, v + base, k0, s, d, tid);
  const float kb = key_bias(key_pad, b, kr, s);

  float dka[NO], dva[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) dka[j] = dva[j] = 0.f;

  for (int q0 = 0; q0 < s; q0 += kBlock) {
    __syncthreads();
    load_rows<T, DT>(qs, q + base, q0, s, d, tid);
    load_rows<T, DT>(gs, dout + base, q0, s, d, tid);
    if (tid < kBlock) {
      const int qi = q0 + tid;
      const bool in = qi < s;
      mrow[tid] = in ? row_m[(size_t)bh * s + qi] : INFINITY;
      lrow[tid] = in ? row_l[(size_t)bh * s + qi] : 1.f;
      drow[tid] = in ? row_d[(size_t)bh * s + qi] : 0.f;
    }
    __syncthreads();

    float sc[kNJ], dpd[kNJ];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) sc[j] = dpd[j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float kc = ks[row * LD + c], vc = vs[row * LD + c];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int i = quarter + 4 * j;
        sc[j] += qs[i * LD + c] * kc;
        dpd[j] += gs[i * LD + c] * vc;
      }
    }
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int i = quarter + 4 * j, qi = q0 + i;
      const float p = expf(sc[j] * scale + kb - mrow[i]) / lrow[i];
      float pd = p, dpv = dpd[j];
      if (dp.mode != 0 && qi < s && kr < s) {
        if (dropped(dp, bh, qi, kr, s)) {
          pd = 0.f;
          dpv = 0.f;
        } else {
          pd *= dp.inv;
          dpv *= dp.inv;
        }
      }
      ps[row * kLdP + i] = round_to<T>(pd);
      ds[row * kLdP + i] = round_to<T>(p * (dpv - drow[i]));
    }
    __syncwarp();
    for (int ii = 0; ii < kBlock; ++ii) {
      const float pv = ps[row * kLdP + ii], lv = ds[row * kLdP + ii];
      const float* gr = gs + ii * LD + quarter;
      const float* qrow = qs + ii * LD + quarter;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        dva[j] += pv * gr[4 * j];
        dka[j] += lv * qrow[4 * j];
      }
    }
  }

  if (kr < s) {
    const size_t o = base + (size_t)kr * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = quarter + 4 * j;
      if (c < d) {
        dk[o + c] = from_f32<T>(dka[j] * scale);
        dv[o + c] = from_f32<T>(dva[j]);
      }
    }
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
mhsa_train_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ key_pad, const T* __restrict__ dout,
                     const float* __restrict__ row_m, const float* __restrict__ row_l,
                     const float* __restrict__ row_d, T* __restrict__ dq, int s, int d, int heads,
                     float scale, Dropout dp) {
  constexpr int LD = DT + 1;
  constexpr int NO = DT / 4;
  extern __shared__ float smem[];
  float* qs = smem;                  // this block's queries
  float* gs = qs + kBlock * LD;      // their dO
  float* ks = gs + kBlock * LD;      // the streamed key tile
  float* vs = ks + kBlock * LD;
  float* ds = vs + kBlock * LD;      // T(dl) [query][key]
  float* bias = ds + kBlock * kLdP;

  const int bh = blockIdx.y, b = bh / heads, q0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * s * d;
  const int tid = threadIdx.x, row = tid >> 2, quarter = tid & 3, qr = q0 + row;
  const bool in = qr < s;

  load_rows<T, DT>(qs, q + base, q0, s, d, tid);
  load_rows<T, DT>(gs, dout + base, q0, s, d, tid);
  const float mi = in ? row_m[(size_t)bh * s + qr] : INFINITY;
  const float li = in ? row_l[(size_t)bh * s + qr] : 1.f;
  const float di = in ? row_d[(size_t)bh * s + qr] : 0.f;

  float dqa[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) dqa[j] = 0.f;

  for (int k0 = 0; k0 < s; k0 += kBlock) {
    __syncthreads();
    load_rows<T, DT>(ks, k + base, k0, s, d, tid);
    load_rows<T, DT>(vs, v + base, k0, s, d, tid);
    if (tid < kBlock) bias[tid] = key_bias(key_pad, b, k0 + tid, s);
    __syncthreads();

    float sc[kNJ], dpd[kNJ];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) sc[j] = dpd[j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qc = qs[row * LD + c], gc = gs[row * LD + c];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int kk = quarter + 4 * j;
        sc[j] += qc * ks[kk * LD + c];
        dpd[j] += gc * vs[kk * LD + c];
      }
    }
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int kk = quarter + 4 * j, kc = k0 + kk;
      const float p = expf(sc[j] * scale + bias[kk] - mi) / li;
      float dpv = dpd[j];
      if (dp.mode != 0 && in && kc < s) dpv = dropped(dp, bh, qr, kc, s) ? 0.f : dpv * dp.inv;
      ds[row * kLdP + kk] = round_to<T>(p * (dpv - di));
    }
    __syncwarp();
    for (int kk = 0; kk < kBlock; ++kk) {
      const float lv = ds[row * kLdP + kk];
      const float* kr = ks + kk * LD + quarter;
#pragma unroll
      for (int j = 0; j < NO; ++j) dqa[j] += lv * kr[4 * j];
    }
  }

  if (in) {
    const size_t o = base + (size_t)qr * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = quarter + 4 * j;
      if (c < d) dq[o + c] = from_f32<T>(dqa[j] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *key_pad, *dout;
  void *out, *out32, *row_m, *row_l, *row_d, *dq, *dk, *dv;
  int bh, s, d, heads;
  float scale;
  Dropout dp;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DT>
cudaError_t launch_fwd(const Args& a) {
  constexpr size_t bytes = fwd_smem_bytes<DT>();
  cudaError_t err = set_smem(mhsa_train_fwd_kernel<T, DT>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.s + kBlock - 1) / kBlock, a.bh);
  mhsa_train_fwd_kernel<T, DT><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.key_pad), static_cast<T*>(a.out),
      static_cast<float*>(a.out32), static_cast<float*>(a.row_m), static_cast<float*>(a.row_l),
      a.s, a.d, a.heads, a.scale, a.dp);
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t launch_bwd(const Args& a) {
  const int rows = a.bh * a.s;
  rowdot_kernel<T><<<(rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const T*>(a.dout), static_cast<const float*>(a.out32),
      static_cast<float*>(a.row_d), rows, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid((a.s + kBlock - 1) / kBlock, a.bh);
  constexpr size_t kv_bytes = dkdv_smem_bytes<DT>();
  err = set_smem(mhsa_train_dkdv_kernel<T, DT>, kv_bytes);
  if (err != cudaSuccess) return err;
  mhsa_train_dkdv_kernel<T, DT><<<grid, kThreads, kv_bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.key_pad), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.row_m), static_cast<const float*>(a.row_l),
      static_cast<const float*>(a.row_d), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s, a.d,
      a.heads, a.scale, a.dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t q_bytes = dq_smem_bytes<DT>();
  err = set_smem(mhsa_train_dq_kernel<T, DT>, q_bytes);
  if (err != cudaSuccess) return err;
  mhsa_train_dq_kernel<T, DT><<<grid, kThreads, q_bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.key_pad), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.row_m), static_cast<const float*>(a.row_l),
      static_cast<const float*>(a.row_d), static_cast<T*>(a.dq), a.s, a.d, a.heads, a.scale,
      a.dp);
  return cudaGetLastError();
}

template <typename T, bool kBwd>
cudaError_t dispatch(const Args& a) {
  if (a.d <= 32) return kBwd ? launch_bwd<T, 32>(a) : launch_fwd<T, 32>(a);
  if (a.d <= 64) return kBwd ? launch_bwd<T, 64>(a) : launch_fwd<T, 64>(a);
  if (a.d <= 96) return kBwd ? launch_bwd<T, 96>(a) : launch_fwd<T, 96>(a);
  return kBwd ? launch_bwd<T, 128>(a) : launch_fwd<T, 128>(a);
}

template <bool kBwd>
int run(const Args& a, int dtype) {
  if (a.bh < 1 || a.s < 1 || a.d < 1 || a.d > 128 || a.heads < 1 || a.bh % a.heads != 0 ||
      a.bh > 65535 || a.dp.mode < 0 || a.dp.mode > 2 || (a.dp.mode == 1 && a.dp.bits == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch<float, kBwd>(a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16, kBwd>(a);
  return (int)cudaErrorInvalidValue;
}

Dropout make_dropout(const void* bits, unsigned seed, unsigned offset, unsigned threshold,
                     float inv, int mode) {
  return Dropout{static_cast<const uint32_t*>(bits), seed, offset, threshold, inv, mode};
}

}  // namespace

// q, k, v, out: [bh, s, d] contiguous, heads folded into the batch (bh = B*heads);
// out32 [bh, s, d] and row_m, row_l [bh, s] are float32 outputs kept for the
// backward. key_pad: [B, s] bytes, nonzero = padded key; may be null. dtype: 0 =
// float32, 1 = bfloat16. Dropout mode 0 = none, 1 = bits ([bh, s, s] uint32),
// 2 = Philox from (seed, offset); an element is dropped where its bits <
// threshold, survivors scaled by inv. Returns the cudaError_t of the launch.
extern "C" int i2r_mhsa_train_fwd(const void* q, const void* k, const void* v,
                                  const void* key_pad, void* out, void* out32, void* row_m,
                                  void* row_l, int bh, int s, int d, int heads, float scale,
                                  int dtype, const void* bits, unsigned seed, unsigned offset,
                                  unsigned threshold, float inv, int mode, void* stream) {
  Args a{q, k, v, key_pad, nullptr, out, out32, row_m, row_l, nullptr, nullptr, nullptr, nullptr,
         bh, s, d, heads, scale, make_dropout(bits, seed, offset, threshold, inv, mode),
         static_cast<cudaStream_t>(stream)};
  return run<false>(a, dtype);
}

// dout, dq, dk, dv: [bh, s, d] of the activation type; out32, row_m, row_l from
// the forward; row_d: [bh, s] float32 scratch. Other arguments as the forward.
extern "C" int i2r_mhsa_train_bwd(const void* q, const void* k, const void* v,
                                  const void* key_pad, const void* dout, const void* out32,
                                  const void* row_m, const void* row_l, void* row_d, void* dq,
                                  void* dk, void* dv, int bh, int s, int d, int heads,
                                  float scale, int dtype, const void* bits, unsigned seed,
                                  unsigned offset, unsigned threshold, float inv, int mode,
                                  void* stream) {
  Args a{q, k, v, key_pad, dout, nullptr, const_cast<void*>(out32), const_cast<void*>(row_m),
         const_cast<void*>(row_l), row_d, dq, dk, dv, bh, s, d, heads, scale,
         make_dropout(bits, seed, offset, threshold, inv, mode),
         static_cast<cudaStream_t>(stream)};
  return run<true>(a, dtype);
}
