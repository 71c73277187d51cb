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
// tokens, head dim 96, one head) each product over the keys the mask leaves
// is about 1.4 GFLOP: the forward runs three (q . K^T twice, below), the
// backward seven, against 8 MB of q, k, v, out in bf16. The tensor cores
// bound them; what must stay out of device memory is the [S, S] probability
// matrix (58 MB in f32 per layer), three times per layer in a plain version.
// The seed-mode dropout bits are the other cost: one Philox4x32-10 call (ten
// rounds of 32 x 32 -> 64-bit multiplies) per element, some 9 million at that
// shape, bound by the integer multiplier (PERF.md has the measured times).
//
// Design, bf16 (attn_mma.cuh has the building blocks and the skip rule); not
// the Pallas design, which holds a whole [256, S] row tile and whole K/V in
// VMEM and accumulates dK/dV along a sequential grid:
// * dropout bits: with a rate above 0 the forward first draws every element's
//   keep bit in a kernel of its own (one thread per 32-key word, the words of
//   skipped tiles left out), from the explicit [B*H, S, S] uint32 bits
//   (tests, parity) or from Philox keyed by (seed, offset) and counted by
//   (key, query, b*H+h) (philox.cuh). The words, [B*H, S, ceil(S / 32)],
//   feed the forward's second pass and are kept for both backward kernels, so
//   Philox runs once per element and step, not three times;
// * forward, one block of 8 warps per (batch*head, 64 queries): 4 groups of
//   16 query rows x the two 32-key halves of each 64-key tile, so twice the
//   warps of one-warp-per-row-group work each row block. Two passes over the
//   key tiles, bf16 in shared memory, double-buffered with cp.async, one
//   barrier a tile: the first finds each row's max m and sum l per half
//   (the halves combined after it), the second recomputes S with the same
//   fragments in the same k-order (bit for bit), forms the exact normalised
//   p (so T(pd) rounds where the JAX kernel rounds, mhsa_train.py:100),
//   drops, and runs T(pd) . V on the tensor cores from registers; the halves'
//   outputs are summed in a fixed order. It saves m, l and the f32 output O.
//   Three products where a one-pass flash forward needs two: the price of
//   the JAX kernel's rounding point;
// * logits in base 2 (q . k * scale * log2 e, padded keys -1e30 log2 e), so
//   each weight is one ex2 and 1 / l one rcp.approx, the same instructions in
//   every kernel: the backward recomputes p bit for bit from m and l (row_m
//   is in base 2 on this route);
// * backward, three launches, deterministic (fixed summation order, no
//   atomics): D_i = rowsum(dO o O) from the f32 O (the identity
//   sum_j p_j dp_j = dO . O holds with dropout); dK/dV, one block of 8 warps
//   per 64-key tile (4 x 16 keys, 2 x 32 queries of each streamed 64-query
//   tile, the two halves summed in a fixed order at the end), S^T = K . Q^T
//   and dPd^T = V . dO^T so that T(pd)^T and T(dS)^T are the A operands of
//   dV += T(pd)^T . dO and dK += T(dS)^T . Q; dQ, one block of 8 warps per
//   64-query tile split as the forward, S = Q . K^T as in the forward,
//   dPd = dO . V^T, dQ += T(dS) . K. Every product is an mma.sync;
// * padded key tiles (the skip rule) are skipped by both forward passes, the
//   keep-bit kernel and the dQ kernel; the dK/dV block of such a tile writes
//   its rows' exact zeros (p = 0 there) and returns. Query tiles are never
//   skipped.
// Padded keys get the finite -1e30 and the running max starts there, so a
// fully padded image is uniform over its S keys, finite; keys past S get
// -inf, weight exactly 0, in both directions; query rows past S get p = 0.
//
// Head dims: bf16 instances for d padded to 16 up to 128, and wide ones for d
// padded to 192 and 256 (the cat_vec inter encoder, C = 174 or 192, one head).
// The wide forward and dQ kernels run one block an SM (split_min_blocks: their
// f32 accumulators take 96 or 128 registers a thread); the wide dK/dV kernel
// splits the output columns between two blocks of a key tile (dkdv_cols, grid
// z), each recomputing the logits over the whole head dim, so that dK and dV
// stay at 96 or 128 values a thread. The dropout bits do not depend on d.
//
// float32 keeps the first design (CUDA-core FMAs on f32 shared-memory tiles,
// four threads per row of a 64 x 64 tile, Philox in each kernel): it is the
// parity route of the f32 model checks, and the tensor cores' TF32 would not
// hold their 1e-4 tolerance. Its head-dim tiles go to 192 (the dK/dV block's
// f32 tiles then take 231680 of the 232448 B a block may have).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "philox.cuh"

namespace {

constexpr int kBlock = 64;     // rows of a block's own tile and of each streamed tile
// the widest instances (ops/cuda/mhsa_train.py::MAX_HEAD_DIM, MAX_HEAD_DIM_F32):
// bf16 to 256; f32 to 192, where the CUDA-core dK/dV block's tiles take 231680 B
constexpr int kMaxHeadDim = 256;
constexpr int kMaxHeadDimF32 = 192;
constexpr int kThreads = 256;  // 4 threads per row
constexpr int kNJ = kBlock / 4;
constexpr int kLdP = kBlock + 1;
using amma::kNegBig;
using amma::quad_max;
using amma::quad_sum;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
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

// The keep bit of element (bh, row, col) for any row and col: 0 outside s x s
// in bits mode (nothing there to read), Philox's own bit in seed mode (the
// element is never used outside).
__device__ __forceinline__ uint32_t keep_bit(const Dropout& dp, int bh, int row, int col, int s) {
  if (dp.mode == 1) return row < s && col < s && dp.bits[((size_t)bh * s + row) * s + col] >=
                                                     dp.threshold;
  return i2r::philox_word0(dp.seed, dp.offset, (uint32_t)col, (uint32_t)row, (uint32_t)bh) >=
         dp.threshold;
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
  void* keep;  // bf16: [bh, s, ceil(s / 32)] keep bits, written by the forward; null: no dropout
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
  if (a.d <= 128) return kBwd ? launch_bwd<T, 128>(a) : launch_fwd<T, 128>(a);
  return kBwd ? launch_bwd<T, 192>(a) : launch_fwd<T, 192>(a);  // dK/dV's 231680 B
}

// ---- bf16: tensor cores ----------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kSplitThreads = 256;  // forward, dQ: 4 groups of 16 rows x 2 halves of each key tile
constexpr int kDkdvThreads = 256;   // dK/dV: 4 groups of 16 keys x 2 halves of each query tile

// Resident blocks an SM the forward and dQ kernels are built for: 2 up to
// head dim 128 (the main path's instances, unchanged); 1 for the wide ones
// (padded 192, 256), whose f32 accumulators of 96 or 128 values a thread need
// the 255 registers one block leaves (six tiles: 154 or 203 KB of shared memory).
template <int DP> __host__ __device__ constexpr int split_min_blocks() { return DP <= 128 ? 2 : 1; }
// Output columns a dK/dV block accumulates: all of them up to head dim 128; half
// of them in the wide instances, where dK and dV together would hold 192 or
// 256 f32 values a thread: two blocks per key tile (grid z), each recomputing
// S^T and dPd^T over the whole head dim and keeping its half of the columns,
// so each output element's sum runs in the same order as in one block.
template <int DP> __host__ __device__ constexpr int dkdv_cols() { return DP <= 128 ? DP : DP / 2; }

constexpr int kBitsThreads = 256;
constexpr int kBitsRows = 32;  // query rows per block of the keep-bit kernel

// keep[bh][row][w], bit j: element (row, key 32 w + j) survives the dropout.
// One thread per word of a block's 32 rows, 32 Philox draws each; the words
// of skipped key tiles are left unwritten (never read).
__global__ void __launch_bounds__(kBitsThreads)
keep_bits_kernel(const uint8_t* __restrict__ key_pad, uint32_t* __restrict__ keep, int s,
                 int heads, Dropout dp) {
  using namespace amma;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  uint8_t* pad = mma_smem;
  uint8_t* live = pad + round16(s);
  const int bh = blockIdx.y, row0 = blockIdx.x * kBitsRows, tid = threadIdx.x;
  const int words = (s + 31) / 32, rows = min(kBitsRows, s - row0);
  const bool has_key = scan_mask<kBitsThreads>(key_pad, bh / heads, s, pad, live, tid);
  uint32_t* dst = keep + ((size_t)bh * s + row0) * words;
  for (int i = tid; i < rows * words; i += kBitsThreads) {
    const int r = i / words, w = i - r * words;
    if (has_key && !live[w >> 1]) continue;
    uint32_t bits = 0;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) bits |= keep_bit(dp, bh, row0 + r, w * 32 + j, s) << j;
    dst[i] = bits;
  }
}

// The two keep words (keys kw0 * 32.. of a tile) of rows r0..r0+63 into dst
// [64][2], 0 outside.
template <int kThreads>
__device__ __forceinline__ void load_keep(uint32_t* dst, const uint32_t* keep, int r0, int s,
                                          int kw0, int tid) {
  const int words = (s + 31) / 32;
  for (int i = tid; i < 2 * amma::kTile; i += kThreads) {
    const int r = r0 + (i >> 1), w = kw0 + (i & 1);
    const bool in = r < s && w < words;
    amma::cp_async4(dst + i, in ? keep + (size_t)r * words + w : keep, in);
  }
}

template <int DP>
constexpr size_t split_tiles_smem() {  // Q (and dO), 2 x (K, V), keep words, row stats
  return amma::tiles_smem<DP>(6) + 2 * 2 * amma::kTile * sizeof(uint32_t) +
         4 * amma::kTile * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kSplitThreads, split_min_blocks<DP>())
mhsa_train_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const uint8_t* __restrict__ key_pad,
                   const uint32_t* __restrict__ keep, bf16* __restrict__ out,
                   float* __restrict__ out32, float* __restrict__ row_m,
                   float* __restrict__ row_l, int s, int d, int heads, float scale, float dinv,
                   int vec) {
  using namespace amma;
  constexpr int LD = ld<DP>();
  constexpr int NK = DP / 16;
  constexpr int ND = DP / 8;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // [64][LD]; [64][LD] unused (dO in dQ)
  bf16* ks = qs + 2 * kTile * LD;                // [2][64][LD]
  bf16* vs = ks + 2 * kTile * LD;                // [2][64][LD]
  uint32_t* kw = reinterpret_cast<uint32_t*>(vs + 2 * kTile * LD);  // [2][64][2]
  float* cm = reinterpret_cast<float*>(kw + 4 * kTile);            // [2 halves][64]
  float* cl = cm + 2 * kTile;
  uint8_t* pad = reinterpret_cast<uint8_t*>(cl + 2 * kTile);
  uint8_t* live = pad + round16(s);

  const int bh = blockIdx.y, b = bh / heads, q0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * s * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, kh = warp >> 2, rr0 = rg * 16 + g, rr1 = rr0 + 8;
  const int nt = (s + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;
  const uint32_t* keep_bh = keep == nullptr ? nullptr : keep + (size_t)bh * s * ((s + 31) / 32);

  const bool has_key = scan_mask<kSplitThreads>(key_pad, b, s, pad, live, tid);
  load_tile<DP, kSplitThreads>(qs, q + base, q0, s, d, vec, tid);
  const int first = next_tile(live, has_key, 0, nt);
  load_tile<DP, kSplitThreads>(ks, k + base, first * kTile, s, d, vec, tid);
  cp_commit();

  // pass 1: each row's max m and sum l over this warp's key half
  float m0 = kNegBig2, m1 = kNegBig2, l0 = 0.f, l1 = 0.f;
  int stage = 0;
  for (int cur = first; cur < nt;) {
    cp_wait<0>();
    __syncthreads();
    const int nxt = next_tile(live, has_key, cur + 1, nt);
    if (nxt < nt)
      load_tile<DP, kSplitThreads>(ks + (stage ^ 1) * kTile * LD, k + base, nxt * kTile, s, d,
                                   vec, tid);
    cp_commit();
    float sc[4][4];
    logits32<NK>(sc, qs, rg * 16, ks + (stage * kTile + kh * 32) * LD, LD, pad,
                 cur * kTile + kh * 32, s, scale2, lane);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));  // finite
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ps0 += ex2(sc[j][0] - mn0) + ex2(sc[j][1] - mn0);
      ps1 += ex2(sc[j][2] - mn1) + ex2(sc[j][3] - mn1);
    }
    l0 = l0 * ex2(m0 - mn0) + ps0;
    l1 = l1 * ex2(m1 - mn1) + ps1;
    m0 = mn0;
    m1 = mn1;
    stage ^= 1;
    cur = nxt;
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t4 == 0) {
    cm[kh * kTile + rr0] = m0;
    cm[kh * kTile + rr1] = m1;
    cl[kh * kTile + rr0] = l0;
    cl[kh * kTile + rr1] = l1;
  }
  cp_wait<0>();
  __syncthreads();  // both halves' m and l are written
  float mrow[2], lsum[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row's max and sum over both halves, half 0 first
    const int rr = h ? rr1 : rr0;
    const float ma = cm[rr], mb = cm[kTile + rr];
    mrow[h] = fmaxf(ma, mb);
    lsum[h] = cl[rr] * ex2(ma - mrow[h]) + cl[kTile + rr] * ex2(mb - mrow[h]);
    inv[h] = rcp(lsum[h]);
  }

  // pass 2: the same logits, exact probabilities, dropout, T(pd) . V
  load_tile<DP, kSplitThreads>(ks + stage * kTile * LD, k + base, first * kTile, s, d, vec, tid);
  load_tile<DP, kSplitThreads>(vs + stage * kTile * LD, v + base, first * kTile, s, d, vec, tid);
  if (keep_bh) load_keep<kSplitThreads>(kw + stage * 2 * kTile, keep_bh, q0, s, first * 2, tid);
  cp_commit();
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int cur = first; cur < nt;) {
    cp_wait<0>();
    __syncthreads();
    const int nxt = next_tile(live, has_key, cur + 1, nt);
    if (nxt < nt) {
      load_tile<DP, kSplitThreads>(ks + (stage ^ 1) * kTile * LD, k + base, nxt * kTile, s, d,
                                   vec, tid);
      load_tile<DP, kSplitThreads>(vs + (stage ^ 1) * kTile * LD, v + base, nxt * kTile, s, d,
                                   vec, tid);
      if (keep_bh)
        load_keep<kSplitThreads>(kw + (stage ^ 1) * 2 * kTile, keep_bh, q0, s, nxt * 2, tid);
    }
    cp_commit();
    float sc[4][4];
    logits32<NK>(sc, qs, rg * 16, ks + (stage * kTile + kh * 32) * LD, LD, pad,
                 cur * kTile + kh * 32, s, scale2, lane);
    const uint32_t w[2] = {keep_bh ? kw[(stage * kTile + rr0) * 2 + kh] : ~0u,
                           keep_bh ? kw[(stage * kTile + rr1) * 2 + kh] : ~0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = ex2(sc[j][e] - mrow[h]) * inv[h];
        const bool kept = (w[h] >> (8 * j + 2 * t4 + (e & 1))) & 1u;
        sc[j][e] = kept ? (keep_bh ? p * dinv : p) : 0.f;
      }
    }
    const bf16* vt = vs + (stage * kTile + kh * 32) * LD;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int dpi = 0; dpi < ND / 2; ++dpi) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vt + a_off(lane, kk * 16, dpi * 16, LD));
        mma(o[2 * dpi], pa, vb[0], vb[1]);
        mma(o[2 * dpi + 1], pa, vb[2], vb[3]);
      }
    }
    stage ^= 1;
    cur = nxt;
  }
  __syncthreads();  // every warp is done with the tiles: their memory takes the sum
  if (!sum_halves<ND>(o, reinterpret_cast<float*>(ks), rg, kh, lane)) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + (h ? rr1 : rr0);
    if (r >= s) continue;
    if (t4 == 0) {
      row_m[(size_t)bh * s + r] = mrow[h];
      row_l[(size_t)bh * s + r] = lsum[h];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        if (c < d) {
          const float x = o[j][2 * h + e];
          out[base + (size_t)r * d + c] = __float2bfloat16(x);
          out32[base + (size_t)r * d + c] = x;
        }
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kDkdvThreads)
mhsa_train_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ key_pad,
                    const uint32_t* __restrict__ keep, const bf16* __restrict__ dout,
                    const float* __restrict__ row_m, const float* __restrict__ row_l,
                    const float* __restrict__ row_d, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int s, int d, int heads, float scale, float dinv, int vec) {
  using namespace amma;
  constexpr int LD = ld<DP>();
  constexpr int NK = DP / 16;
  constexpr int DV = dkdv_cols<DP>();
  constexpr int ND = DV / 8;  // 8-column tiles of dK, dV this block keeps
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bf16* ks = reinterpret_cast<bf16*>(mma_smem);  // this block's keys [64][LD]
  bf16* vs = ks + kTile * LD;
  bf16* qs = vs + kTile * LD;                    // the streamed query tile [2][64][LD]
  bf16* gs = qs + 2 * kTile * LD;                // its dO [2][64][LD]
  float* st = reinterpret_cast<float*>(gs + 2 * kTile * LD);  // [2][m, l, D][64]
  uint32_t* kw = reinterpret_cast<uint32_t*>(st + 6 * kTile);  // [2][64 queries][2]

  const int bh = blockIdx.y, b = bh / heads, k0 = blockIdx.x * kTile;
  const int c0 = DV == DP ? 0 : blockIdx.z * DV;  // this block's first output column
  const size_t base = (size_t)bh * s * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kg = warp & 3, qh = warp >> 2;  // 16 keys kg*16.., queries qh*32.. of each tile
  const int nt = (s + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;
  const uint32_t* keep_bh = keep == nullptr ? nullptr : keep + (size_t)bh * s * ((s + 31) / 32);

  // the skip rule: zeros for a padded key tile of an image with a real key
  int any_image = 0, any_tile = 0;
  for (int kk = tid; kk < s; kk += kDkdvThreads) {
    const int real = key_pad == nullptr || key_pad[(size_t)b * s + kk] == 0;
    any_image |= real;
    any_tile |= real && kk >= k0 && kk < k0 + kTile;
  }
  const bool has_key = __syncthreads_or(any_image) != 0;
  if (has_key && __syncthreads_or(any_tile) == 0) {
    const int n = min(kTile, s - k0) * DV;
    for (int i = tid; i < n; i += kDkdvThreads) {
      const int c = c0 + i % DV;
      if (c >= d) continue;
      const size_t o = base + (size_t)(k0 + i / DV) * d + c;
      dk[o] = __float2bfloat16(0.f);
      dv[o] = __float2bfloat16(0.f);
    }
    return;
  }

  const float* const rows[3] = {row_m + (size_t)bh * s, row_l + (size_t)bh * s,
                                row_d + (size_t)bh * s};
  load_tile<DP, kDkdvThreads>(ks, k + base, k0, s, d, vec, tid);
  load_tile<DP, kDkdvThreads>(vs, v + base, k0, s, d, vec, tid);
  load_tile<DP, kDkdvThreads>(qs, q + base, 0, s, d, vec, tid);
  load_tile<DP, kDkdvThreads>(gs, dout + base, 0, s, d, vec, tid);
#pragma unroll
  for (int x = 0; x < 3; ++x) load_row_stats<kDkdvThreads>(st + x * kTile, rows[x], 0, s, tid);
  if (keep_bh) load_keep<kDkdvThreads>(kw, keep_bh, 0, s, k0 / 32, tid);
  cp_commit();

  const int kr0 = k0 + kg * 16 + g, kr1 = kr0 + 8;
  auto bias_of = [&](int kr) {
    return kr < s ? ((key_pad != nullptr && key_pad[(size_t)b * s + kr]) ? kNegBig2 : 0.f)
                  : -INFINITY;
  };
  const float kb[2] = {bias_of(kr0), bias_of(kr1)};
  const int kbit = (kg & 1) * 16 + g, kword = kg >> 1;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  int stage = 0;
  for (int qt = 0; qt < nt; ++qt) {
    cp_wait<0>();
    __syncthreads();  // this query tile has landed; the other stage is free
    if (qt + 1 < nt) {
      const int n = stage ^ 1, q1 = (qt + 1) * kTile;
      load_tile<DP, kDkdvThreads>(qs + n * kTile * LD, q + base, q1, s, d, vec, tid);
      load_tile<DP, kDkdvThreads>(gs + n * kTile * LD, dout + base, q1, s, d, vec, tid);
#pragma unroll
      for (int x = 0; x < 3; ++x)
        load_row_stats<kDkdvThreads>(st + (n * 3 + x) * kTile, rows[x], q1, s, tid);
      if (keep_bh) load_keep<kDkdvThreads>(kw + n * 2 * kTile, keep_bh, q1, s, k0 / 32, tid);
    }
    cp_commit();
    const bf16* qt_s = qs + stage * kTile * LD;
    const bf16* gt_s = gs + stage * kTile * LD;
    const float* mrow = st + stage * 3 * kTile;
    const float* lrow = mrow + kTile;
    const float* drow = lrow + kTile;
    const uint32_t* wq = kw + stage * 2 * kTile;
    const int q0 = qt * kTile;

    // S^T = K . Q^T and dPd^T = V . dO^T: 16 keys x 32 queries
    float sT[4][4], pT[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = pT[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ks + a_off(lane, kg * 16, kk * 16, LD));
      ldsm_x4(va, vs + a_off(lane, kg * 16, kk * 16, LD));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t qb[4], gb[4];
        ldsm_x4(qb, qt_s + b_off(lane, qh * 32 + np * 16, kk * 16, LD));
        mma(sT[2 * np], ka, qb[0], qb[1]);
        mma(sT[2 * np + 1], ka, qb[2], qb[3]);
        ldsm_x4(gb, gt_s + b_off(lane, qh * 32 + np * 16, kk * 16, LD));
        mma(pT[2 * np], va, gb[0], gb[1]);
        mma(pT[2 * np + 1], va, gb[2], gb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = qh * 32 + 8 * j + 2 * t4 + (e & 1), h = e >> 1;
        // rows past s have zeros for m and l here: the select drops them
        const float pr = ex2(__fmaf_rn(sT[j][e], scale2, kb[h]) - mrow[qc]) * rcp(lrow[qc]);
        const float p = q0 + qc < s ? pr : 0.f;
        float pd = p, dpv = pT[j][e];
        if (keep_bh) {
          const bool kept = (wq[qc * 2 + kword] >> (kbit + 8 * h)) & 1u;
          pd = kept ? pd * dinv : 0.f;
          dpv = kept ? dpv * dinv : 0.f;
        }
        sT[j][e] = pd;                    // T(pd)^T once packed
        pT[j][e] = p * (dpv - drow[qc]);  // T(dS)^T once packed
      }
    }
    // dV += T(pd)^T . dO, dK += T(dS)^T . Q over this warp's 32 queries
#pragma unroll
    for (int kq = 0; kq < 2; ++kq) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, sT[2 * kq], sT[2 * kq + 1]);
      acc_to_a(sa, pT[2 * kq], pT[2 * kq + 1]);
#pragma unroll
      for (int dpi = 0; dpi < ND / 2; ++dpi) {
        uint32_t gb[4], qb[4];
        ldsm_x4_t(gb, gt_s + a_off(lane, qh * 32 + kq * 16, c0 + dpi * 16, LD));
        mma(dva[2 * dpi], pa, gb[0], gb[1]);
        mma(dva[2 * dpi + 1], pa, gb[2], gb[3]);
        ldsm_x4_t(qb, qt_s + a_off(lane, qh * 32 + kq * 16, c0 + dpi * 16, LD));
        mma(dka[2 * dpi], sa, qb[0], qb[1]);
        mma(dka[2 * dpi + 1], sa, qb[2], qb[3]);
      }
    }
    stage ^= 1;
  }
  __syncthreads();  // every warp is done with the tiles: their memory takes the sums

  // the two query halves, summed in a fixed order (half 0 + half 1)
  float* red = reinterpret_cast<float*>(qs);  // [4 key groups][dK, dV] over Q/dO
  const bool keeper = sum_halves<ND>(dka, red, kg, qh, lane);
  sum_halves<ND>(dva, red + 4 * ND * 4 * 32, kg, qh, lane);
  if (!keeper) return;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = e < 2 ? kr0 : kr1, c = c0 + 8 * j + 2 * t4 + (e & 1);
      if (kr < s && c < d) {
        const size_t o = base + (size_t)kr * d + c;
        dk[o] = __float2bfloat16(dka[j][e] * scale);
        dv[o] = __float2bfloat16(dva[j][e]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kSplitThreads, split_min_blocks<DP>())
mhsa_train_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const uint8_t* __restrict__ key_pad,
                  const uint32_t* __restrict__ keep, const bf16* __restrict__ dout,
                  const float* __restrict__ row_m, const float* __restrict__ row_l,
                  const float* __restrict__ row_d, bf16* __restrict__ dq, int s, int d,
                  int heads, float scale, float dinv, int vec) {
  using namespace amma;
  constexpr int LD = ld<DP>();
  constexpr int NK = DP / 16;
  constexpr int ND = DP / 8;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // this block's queries [64][LD]
  bf16* gs = qs + kTile * LD;                    // their dO
  bf16* ks = gs + kTile * LD;                    // the streamed key tile [2][64][LD]
  bf16* vs = ks + 2 * kTile * LD;
  uint32_t* kw = reinterpret_cast<uint32_t*>(vs + 2 * kTile * LD);  // [2][64][2]
  uint8_t* pad = reinterpret_cast<uint8_t*>(kw + 4 * kTile + 4 * kTile);  // past the row stats
  uint8_t* live = pad + round16(s);

  const int bh = blockIdx.y, b = bh / heads, q0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * s * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, kh = warp >> 2, rr0 = rg * 16 + g, rr1 = rr0 + 8;
  const int nt = (s + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;
  const uint32_t* keep_bh = keep == nullptr ? nullptr : keep + (size_t)bh * s * ((s + 31) / 32);

  const bool has_key = scan_mask<kSplitThreads>(key_pad, b, s, pad, live, tid);
  load_tile<DP, kSplitThreads>(qs, q + base, q0, s, d, vec, tid);
  load_tile<DP, kSplitThreads>(gs, dout + base, q0, s, d, vec, tid);
  int cur = next_tile(live, has_key, 0, nt);
  load_tile<DP, kSplitThreads>(ks, k + base, cur * kTile, s, d, vec, tid);
  load_tile<DP, kSplitThreads>(vs, v + base, cur * kTile, s, d, vec, tid);
  if (keep_bh) load_keep<kSplitThreads>(kw, keep_bh, q0, s, cur * 2, tid);
  cp_commit();
  float mrow[2], inv[2], drow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows past s: m = +inf, so p = 0
    const int r = q0 + (h ? rr1 : rr0);
    const size_t o = (size_t)bh * s + r;
    mrow[h] = r < s ? row_m[o] : INFINITY;
    inv[h] = r < s ? rcp(row_l[o]) : 0.f;
    drow[h] = r < s ? row_d[o] : 0.f;
  }

  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  int stage = 0;
  while (cur < nt) {
    cp_wait<0>();
    __syncthreads();  // this key tile has landed; the other stage is free
    const int nxt = next_tile(live, has_key, cur + 1, nt);
    if (nxt < nt) {
      load_tile<DP, kSplitThreads>(ks + (stage ^ 1) * kTile * LD, k + base, nxt * kTile, s, d,
                                   vec, tid);
      load_tile<DP, kSplitThreads>(vs + (stage ^ 1) * kTile * LD, v + base, nxt * kTile, s, d,
                                   vec, tid);
      if (keep_bh)
        load_keep<kSplitThreads>(kw + (stage ^ 1) * 2 * kTile, keep_bh, q0, s, nxt * 2, tid);
    }
    cp_commit();
    const bf16* kt = ks + (stage * kTile + kh * 32) * LD;
    const bf16* vt = vs + (stage * kTile + kh * 32) * LD;

    float sc[4][4], dpd[4][4];
    logits32<NK>(sc, qs, rg * 16, kt, LD, pad, cur * kTile + kh * 32, s, scale2, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) dpd[j][0] = dpd[j][1] = dpd[j][2] = dpd[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ga[4];
      ldsm_x4(ga, gs + a_off(lane, rg * 16, kk * 16, LD));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t vb[4];
        ldsm_x4(vb, vt + b_off(lane, np * 16, kk * 16, LD));
        mma(dpd[2 * np], ga, vb[0], vb[1]);
        mma(dpd[2 * np + 1], ga, vb[2], vb[3]);
      }
    }
    const uint32_t w[2] = {keep_bh ? kw[(stage * kTile + rr0) * 2 + kh] : ~0u,
                           keep_bh ? kw[(stage * kTile + rr1) * 2 + kh] : ~0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = ex2(sc[j][e] - mrow[h]) * inv[h];
        float dpv = dpd[j][e];
        if (keep_bh) dpv = (w[h] >> (8 * j + 2 * t4 + (e & 1))) & 1u ? dpv * dinv : 0.f;
        sc[j][e] = p * (dpv - drow[h]);  // dS, T(dS) once packed
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // dQ += T(dS) . K, 16 keys at a time
      uint32_t sa[4];
      acc_to_a(sa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int dpi = 0; dpi < ND / 2; ++dpi) {
        uint32_t kb[4];
        ldsm_x4_t(kb, kt + a_off(lane, kk * 16, dpi * 16, LD));
        mma(dqa[2 * dpi], sa, kb[0], kb[1]);
        mma(dqa[2 * dpi + 1], sa, kb[2], kb[3]);
      }
    }
    stage ^= 1;
    cur = nxt;
  }
  __syncthreads();  // every warp is done with the tiles: their memory takes the sum
  if (!sum_halves<ND>(dqa, reinterpret_cast<float*>(ks), rg, kh, lane)) return;

#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + (e < 2 ? rr0 : rr1), c = 8 * j + 2 * t4 + (e & 1);
      if (r < s && c < d) dq[base + (size_t)r * d + c] = __float2bfloat16(dqa[j][e] * scale);
    }
  }
}

template <int DP>
cudaError_t launch_fwd_mma(const Args& a) {
  const int vec = amma::copy_vec(a.d, {a.q, a.k, a.v});
  cudaError_t err;
  if (a.keep != nullptr) {
    const size_t bytes = amma::scan_smem(a.s);
    err = amma::allow_smem<keep_bits_kernel>(bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((a.s + kBitsRows - 1) / kBitsRows, a.bh);
    keep_bits_kernel<<<grid, kBitsThreads, bytes, a.stream>>>(
        static_cast<const uint8_t*>(a.key_pad), static_cast<uint32_t*>(a.keep), a.s, a.heads,
        a.dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t bytes = split_tiles_smem<DP>() + amma::scan_smem(a.s);
  err = amma::allow_smem<mhsa_train_fwd_mma<DP>>(bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.s + amma::kTile - 1) / amma::kTile, a.bh);
  mhsa_train_fwd_mma<DP><<<grid, kSplitThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.key_pad), static_cast<const uint32_t*>(a.keep),
      static_cast<bf16*>(a.out), static_cast<float*>(a.out32), static_cast<float*>(a.row_m),
      static_cast<float*>(a.row_l), a.s, a.d, a.heads, a.scale, a.dp.inv, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_mma(const Args& a) {
  const int rows = a.bh * a.s;
  rowdot_kernel<bf16><<<(rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.out32),
      static_cast<float*>(a.row_d), rows, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int vec = amma::copy_vec(a.d, {a.q, a.k, a.v, a.dout});
  dim3 grid((a.s + amma::kTile - 1) / amma::kTile, a.bh);
  const dim3 kv_grid(grid.x, grid.y, DP / dkdv_cols<DP>());
  const size_t kv_bytes = amma::tiles_smem<DP>(6) + 6 * amma::kTile * sizeof(float) +
                          4 * amma::kTile * sizeof(uint32_t);
  err = amma::allow_smem<mhsa_train_dkdv_mma<DP>>(kv_bytes);
  if (err != cudaSuccess) return err;
  mhsa_train_dkdv_mma<DP><<<kv_grid, kDkdvThreads, kv_bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.key_pad), static_cast<const uint32_t*>(a.keep),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.row_m),
      static_cast<const float*>(a.row_l), static_cast<const float*>(a.row_d),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.s, a.d, a.heads, a.scale, a.dp.inv,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t q_bytes = split_tiles_smem<DP>() + amma::scan_smem(a.s);
  err = amma::allow_smem<mhsa_train_dq_mma<DP>>(q_bytes);
  if (err != cudaSuccess) return err;
  mhsa_train_dq_mma<DP><<<grid, kSplitThreads, q_bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.key_pad), static_cast<const uint32_t*>(a.keep),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.row_m),
      static_cast<const float*>(a.row_l), static_cast<const float*>(a.row_d),
      static_cast<bf16*>(a.dq), a.s, a.d, a.heads, a.scale, a.dp.inv, vec);
  return cudaGetLastError();
}

template <bool kBwd>
cudaError_t dispatch_mma(const Args& a) {
  switch (amma::pad16(a.d)) {
    case 16: return kBwd ? launch_bwd_mma<16>(a) : launch_fwd_mma<16>(a);
    case 32: return kBwd ? launch_bwd_mma<32>(a) : launch_fwd_mma<32>(a);
    case 48: return kBwd ? launch_bwd_mma<48>(a) : launch_fwd_mma<48>(a);
    case 64: return kBwd ? launch_bwd_mma<64>(a) : launch_fwd_mma<64>(a);
    case 80: return kBwd ? launch_bwd_mma<80>(a) : launch_fwd_mma<80>(a);
    case 96: return kBwd ? launch_bwd_mma<96>(a) : launch_fwd_mma<96>(a);
    case 112: return kBwd ? launch_bwd_mma<112>(a) : launch_fwd_mma<112>(a);
    case 128: return kBwd ? launch_bwd_mma<128>(a) : launch_fwd_mma<128>(a);
  }
  // the wide instances: head dims padded to 192 or to 256
  if (a.d <= 192) return kBwd ? launch_bwd_mma<192>(a) : launch_fwd_mma<192>(a);
  return kBwd ? launch_bwd_mma<256>(a) : launch_fwd_mma<256>(a);
}

template <bool kBwd>
int run(const Args& a, int dtype) {
  if (a.bh < 1 || a.s < 1 || a.d < 1 || a.d > (dtype == 0 ? kMaxHeadDimF32 : kMaxHeadDim) ||
      a.heads < 1 || a.bh % a.heads != 0 ||
      a.bh > 65535 || a.dp.mode < 0 || a.dp.mode > 2 || (a.dp.mode == 1 && a.dp.bits == nullptr) ||
      (dtype == 1 && (a.dp.mode != 0) != (a.keep != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch<float, kBwd>(a);
  if (dtype == 1) return (int)dispatch_mma<kBwd>(a);
  return (int)cudaErrorInvalidValue;
}

Dropout make_dropout(const void* bits, unsigned seed, unsigned offset, unsigned threshold,
                     float inv, int mode) {
  return Dropout{static_cast<const uint32_t*>(bits), seed, offset, threshold, inv, mode};
}

}  // namespace

// q, k, v, out: [bh, s, d] contiguous, heads folded into the batch (bh = B*heads);
// out32 [bh, s, d] and row_m, row_l [bh, s] are float32 outputs kept for the
// backward (bf16: row_m in base 2, the logits times log2 e). key_pad: [B, s]
// bytes, nonzero = padded key; may be null. dtype: 0 = float32, 1 = bfloat16.
// Dropout mode 0 = none, 1 = bits ([bh, s, s] uint32), 2 = Philox from (seed,
// offset); an element is dropped where its bits < threshold, survivors scaled
// by inv. keep: bf16 with dropout, int32 [bh, s, ceil(s / 32)] scratch that
// receives the keep bits for the backward (null otherwise). Returns the
// cudaError_t of the launches.
extern "C" int i2r_mhsa_train_fwd(const void* q, const void* k, const void* v,
                                  const void* key_pad, void* out, void* out32, void* row_m,
                                  void* row_l, int bh, int s, int d, int heads, float scale,
                                  int dtype, const void* bits, unsigned seed, unsigned offset,
                                  unsigned threshold, float inv, int mode, void* keep,
                                  void* stream) {
  Args a{q, k, v, key_pad, nullptr, out, out32, row_m, row_l, nullptr, nullptr, nullptr, nullptr,
         keep, bh, s, d, heads, scale, make_dropout(bits, seed, offset, threshold, inv, mode),
         static_cast<cudaStream_t>(stream)};
  return run<false>(a, dtype);
}

// dout, dq, dk, dv: [bh, s, d] of the activation type; out32, row_m, row_l
// (and keep) from the forward; row_d: [bh, s] float32 scratch. Other arguments
// as the forward.
extern "C" int i2r_mhsa_train_bwd(const void* q, const void* k, const void* v,
                                  const void* key_pad, const void* dout, const void* out32,
                                  const void* row_m, const void* row_l, void* row_d, void* dq,
                                  void* dk, void* dv, int bh, int s, int d, int heads,
                                  float scale, int dtype, const void* bits, unsigned seed,
                                  unsigned offset, unsigned threshold, float inv, int mode,
                                  const void* keep, void* stream) {
  Args a{q, k, v, key_pad, dout, nullptr, const_cast<void*>(out32), const_cast<void*>(row_m),
         const_cast<void*>(row_l), row_d, dq, dk, dv, const_cast<void*>(keep), bh, s, d, heads,
         scale,
         make_dropout(bits, seed, offset, threshold, inv, mode),
         static_cast<cudaStream_t>(stream)};
  return run<true>(a, dtype);
}
