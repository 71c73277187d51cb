// HRFormer window-attention half block, training backward (kernel 9), for
// Hopper (sm_90a).
//
// Replaces the backward of
// i2rnet_tpu/ops/pallas/hrformer_block_train.py::window_attn_block_train: the
// host relayout of da2 (:395-402), _attn_bwd_kernel (K1, :163-240) and
// _ln_bwd_kernel (K2, :247-288). The forward (window_attn_block.cu, kTrain)
// computes out = x + T(s (WindowMHSA(LN1(x)))) and saves the window tokens
// t2 = T(LN1(x)) [P, nwin, 49, C], 0 at pad tokens. Given dy, this computes,
// with T the activation type:
//     da2  = T(s dy) on the windows, 0 at pad tokens
//     K1, per (window, person) and head, from t2 (q, k, v recomputed):
//       q, k, v = T(t2 . W + b)           (q scaled by d^-1/2, as the forward)
//       P       = softmax(q . k^T)         f32, kept unrounded
//       o       = T(T(P) . v)
//       dO      = T(da2 . Wo^T)            the head's columns
//       dV      = T(P)^T . dO,  dP = dO . v^T
//       dS      = T(P (dP - rowsum(dP P)))
//       dQ      = dS . k,  dK = dS^T . q
//       dt2    += T(dQ) . Wq^T + T(dK) . Wk^T + T(dV) . Wv^T   (f32, then T)
//     K2, per row of pixels: un-window dt2 (pad positions dropped), LN1's
//     statistics from x again, dgamma += dt2 xhat, dbeta += dt2,
//       dx = dy + T(rstd (g dt2 - mean(g dt2) - xhat mean(g dt2 xhat)))
//     weight gradients, dW = sum over tokens (the torch Linear layout [out][in]):
//       dWq = d^-1/2 T(dQ)^T t2, dWk = T(dK)^T t2, dWv = T(dV)^T t2, dWo = da2^T o
//     bias gradients: the f32 dQ, dK, dV (d^-1/2 on dbq) and da2 summed over
//     every token, pad tokens included (their q, k, v are the biases, and they
//     are attended to)
// A sample with s = 0 has da2 = 0, so it adds nothing to any gradient and
// its dx is dy.
//
// What bounds it on the H100: per person at branch 0 of a 256x192 input
// (64x48x78, 70 windows of 49 tokens, 2 heads of d = 39) K1's products are
// 2 * 3430 * 78 * (3 * 78 + 78 + 3 * 78) (q/k/v, dO, dt2) plus 4 * 5 * 49 * 39
// per window row and head of attention, about 0.33 GFLOP, and the weight
// gradients 4 * 2 * 3430 * 78^2 = 0.17 GFLOP, against about 6 * 3430 * 78 * 2 B
// = 3.2 MB of token arrays in bf16: the memory bounds it at the card's rates
// (about 1 us against 0.5 us of tensor-core work). These simple kernels run
// their products on CUDA cores in f32, so the FMA rate and the shared-memory
// reads that feed it bound them in practice.
//
// Design (not the Pallas one, which grids over 7-row strips with 128-lane
// heads and accumulates the weight gradients across a sequential grid):
// * K1: one block of 256 threads per (7x7 window, person), Kernel E's item
//   shape (one output column x one window row of 7 tokens). q/k/v are
//   recomputed per head over 32-channel chunks of t2 staged in shared memory;
//   the head's dO over chunks of da2; P and dP/dS as [49][49] f32 tiles; the
//   window's dt2 accumulates over heads in a [49][C] f32 tile (216 KB of
//   shared memory at C = 624 in f32). K1 writes da2, o, T(dQ), T(dK), T(dV)
//   and dt2 per token, and each block's f32 bias sums.
// * weight gradients: no [C, C] partial per block (6.2 MB a block at C = 624).
//   A tiled reduction over 16 row slices of the token arrays and a sum of the
//   slices in a fixed order (common.cuh, as Kernel D): no atomics.
// * K2: one block per (row of pixels, person), one warp per pixel, per-warp
//   partial sums of dgamma and dbeta added in a fixed order.
// Head dim d is a runtime value (39 on HRFormer-B, unpadded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWin = 7;
constexpr int kTok = kWin * kWin;
constexpr int kKC = 32;  // input channels per chunk of the q/k/v and dO products

// K1's shared memory: token coordinates, then f32 (q/k/v, P, dP/dS, dO,
// dQ/dK/dV, the dt2 accumulator), then the T chunk tiles
template <typename T>
size_t k1_smem(int c, int d) {
  return sizeof(int) * 2 * kTok +
         sizeof(float) * ((size_t)6 * kTok * d + 2 * kTok * kTok + (size_t)kTok * d +
                          (size_t)kTok * c) +
         sizeof(T) * ((size_t)kTok * kKC + (size_t)kKC * 3 * d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ t2, const T* __restrict__ dy, const float* __restrict__ s,
                const T* __restrict__ wqkv, const float* __restrict__ bqkv,
                const T* __restrict__ wot, T* __restrict__ da2, T* __restrict__ o3,
                T* __restrict__ dqkv, T* __restrict__ dt2, float* __restrict__ bias_part, int h,
                int w, int c, int heads, size_t rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = c / heads, n3 = 3 * d;
  int* s_row = reinterpret_cast<int*>(smem_raw);  // [49]: map row, or -1 for padding
  int* s_col = s_row + kTok;
  float* qkv = reinterpret_cast<float*>(s_col + kTok);  // [3][49][d]
  float* pr = qkv + 3 * kTok * d;                       // [49][49] P
  float* ds = pr + kTok * kTok;                         // [49][49] dP, then T(dS)
  float* doh = ds + kTok * kTok;                        // [49][d] T(dO)
  float* dg = doh + kTok * d;                           // [3][49][d] dQ, dK, dV
  float* acc_t2 = dg + 3 * kTok * d;                    // [49][c]
  T* ct = reinterpret_cast<T*>(acc_t2 + (size_t)kTok * c);  // [49][kKC]
  T* wt = ct + kTok * kKC;                                   // [kKC][3d]

  const int pad_h = (kWin - h % kWin) % kWin, pad_w = (kWin - w % kWin) % kWin;
  const int nw = (w + pad_w) / kWin;
  const int wy = blockIdx.x / nw, wx = blockIdx.x % nw;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t base = blk * kTok;  // the window's first token row
  const T* dyp = dy + (size_t)blockIdx.y * h * w * c;
  const T* t2p = t2 + base * c;
  T* da2p = da2 + base * c;
  T* o3p = o3 + base * c;
  float* bp = bias_part + blk * 4 * c;  // dbq, dbk, dbv, dbo partials of this block
  const float sc = s[blockIdx.y];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int t = tid; t < kTok; t += kThreads) {
    const int r = wy * kWin + t / kWin - pad_h / 2, q = wx * kWin + t % kWin - pad_w / 2;
    s_row[t] = (r >= 0 && r < h && q >= 0 && q < w) ? r : -1;
    s_col[t] = q;
  }
  __syncthreads();
  // da2 = T(s dy) on the window (0 at pad tokens) and its column sums (dbo)
  for (int col = tid; col < c; col += kThreads) {
    float sum = 0.f;
    for (int t = 0; t < kTok; ++t) {
      float v = 0.f;
      if (s_row[t] >= 0)
        v = round_to<T>(sc * to_f32(dyp[((size_t)s_row[t] * w + s_col[t]) * c + col]));
      da2p[(size_t)t * c + col] = from_f32<T>(v);
      sum += v;
    }
    bp[3 * c + col] = sum;
  }
  for (int i = tid; i < kTok * c; i += kThreads) acc_t2[i] = 0.f;

  const float* qs = qkv;
  const float* ks = qkv + kTok * d;
  const float* vs = ks + kTok * d;
  for (int hd = 0; hd < heads; ++hd) {
    __syncthreads();  // da2 written / the previous head's dQ, dK, dV consumed
    for (int i = tid; i < 3 * kTok * d; i += kThreads) qkv[i] = 0.f;
    for (int i = tid; i < kTok * d; i += kThreads) doh[i] = 0.f;
    // q, k, v of this head from t2, in 32-channel chunks (Kernel E's product)
    for (int c0 = 0; c0 < c; c0 += kKC) {
      const int kc = min(kKC, c - c0);
      __syncthreads();  // accumulators zeroed / the previous chunk's tiles consumed
      for (int i = tid; i < kTok * kKC; i += kThreads) {
        const int t = i / kKC, k = i % kKC;
        ct[i] = k < kc ? t2p[(size_t)t * c + c0 + k] : from_f32<T>(0.f);
      }
      for (int i = tid; i < kKC * n3; i += kThreads) {
        const int k = i / n3, j = i % n3;
        wt[i] = k < kc ? wqkv[((size_t)(c0 + k) * heads + hd) * n3 + j] : from_f32<T>(0.f);
      }
      __syncthreads();
      for (int it = tid; it < n3 * kWin; it += kThreads) {
        const int col = it % n3, row = it / n3;
        float acc[kWin];
#pragma unroll
        for (int i = 0; i < kWin; ++i) acc[i] = 0.f;
        for (int k = 0; k < kc; ++k) {
          const float wv = to_f32(wt[k * n3 + col]);
#pragma unroll
          for (int i = 0; i < kWin; ++i) acc[i] += to_f32(ct[(row * kWin + i) * kKC + k]) * wv;
        }
        const int m = col / d, j = col % d;
#pragma unroll
        for (int i = 0; i < kWin; ++i) qkv[(m * kTok + row * kWin + i) * d + j] += acc[i];
      }
    }
    // dO of this head: doh[t][j] = sum over col of da2[t][col] Wo^T[hd d + j][col]
    for (int c0 = 0; c0 < c; c0 += kKC) {
      const int kc = min(kKC, c - c0);
      __syncthreads();
      for (int i = tid; i < kTok * kKC; i += kThreads) {
        const int t = i / kKC, k = i % kKC;
        ct[i] = k < kc ? da2p[(size_t)t * c + c0 + k] : from_f32<T>(0.f);
      }
      for (int i = tid; i < kKC * d; i += kThreads) {
        const int k = i / d, j = i % d;
        wt[i] = k < kc ? wot[(size_t)(hd * d + j) * c + c0 + k] : from_f32<T>(0.f);
      }
      __syncthreads();
      for (int it = tid; it < d * kWin; it += kThreads) {
        const int j = it % d, row = it / d;
        float acc[kWin];
#pragma unroll
        for (int i = 0; i < kWin; ++i) acc[i] = 0.f;
        for (int k = 0; k < kc; ++k) {
          const float wv = to_f32(wt[k * d + j]);
#pragma unroll
          for (int i = 0; i < kWin; ++i) acc[i] += to_f32(ct[(row * kWin + i) * kKC + k]) * wv;
        }
#pragma unroll
        for (int i = 0; i < kWin; ++i) doh[(row * kWin + i) * d + j] += acc[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < 3 * kTok * d; i += kThreads) {
      const int m = i / (kTok * d), j = i % d;
      qkv[i] = round_to<T>(qkv[i] + bqkv[(hd * 3 + m) * d + j]);
    }
    for (int i = tid; i < kTok * d; i += kThreads) doh[i] = round_to<T>(doh[i]);
    __syncthreads();

    // logits: items (key, window row of 7 queries); then the f32 softmax
    for (int it = tid; it < kTok * kWin; it += kThreads) {
      const int key = it % kTok, row = it / kTok;
      float acc[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) acc[i] = 0.f;
      for (int j = 0; j < d; ++j) {
        const float kv = ks[key * d + j];
#pragma unroll
        for (int i = 0; i < kWin; ++i) acc[i] += qs[(row * kWin + i) * d + j] * kv;
      }
#pragma unroll
      for (int i = 0; i < kWin; ++i) pr[(row * kWin + i) * kTok + key] = acc[i];
    }
    __syncthreads();
    for (int t = warp; t < kTok; t += kWarps) {
      float* sr = pr + t * kTok;
      float mx = -INFINITY;
      for (int k = lane; k < kTok; k += 32) mx = fmaxf(mx, sr[k]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int k = lane; k < kTok; k += 32) {
        const float e = expf(sr[k] - mx);
        sr[k] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int k = lane; k < kTok; k += 32) sr[k] = sr[k] / sum;
    }
    __syncthreads();

    // o = T(T(P) . v): items (j, row of 7 queries)
    for (int it = tid; it < d * kWin; it += kThreads) {
      const int j = it % d, row = it / d;
      float acc[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) acc[i] = 0.f;
      for (int key = 0; key < kTok; ++key) {
        const float vv = vs[key * d + j];
#pragma unroll
        for (int i = 0; i < kWin; ++i) acc[i] += round_to<T>(pr[(row * kWin + i) * kTok + key]) * vv;
      }
#pragma unroll
      for (int i = 0; i < kWin; ++i) o3p[(size_t)(row * kWin + i) * c + hd * d + j] = from_f32<T>(acc[i]);
    }
    // dV = T(P)^T . dO: items (j, row of 7 keys)
    for (int it = tid; it < d * kWin; it += kThreads) {
      const int j = it % d, row = it / d;
      float acc[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) acc[i] = 0.f;
      for (int q = 0; q < kTok; ++q) {
        const float dv = doh[q * d + j];
#pragma unroll
        for (int i = 0; i < kWin; ++i) acc[i] += round_to<T>(pr[q * kTok + row * kWin + i]) * dv;
      }
#pragma unroll
      for (int i = 0; i < kWin; ++i) dg[(2 * kTok + row * kWin + i) * d + j] = acc[i];
    }
    // dP = dO . v^T: items (key, row of 7 queries)
    for (int it = tid; it < kTok * kWin; it += kThreads) {
      const int key = it % kTok, row = it / kTok;
      float acc[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) acc[i] = 0.f;
      for (int j = 0; j < d; ++j) {
        const float vv = vs[key * d + j];
#pragma unroll
        for (int i = 0; i < kWin; ++i) acc[i] += doh[(row * kWin + i) * d + j] * vv;
      }
#pragma unroll
      for (int i = 0; i < kWin; ++i) ds[(row * kWin + i) * kTok + key] = acc[i];
    }
    __syncthreads();
    // dS = T(P (dP - rowsum(dP P))), a warp per query row
    for (int t = warp; t < kTok; t += kWarps) {
      float* dr = ds + t * kTok;
      const float* prow = pr + t * kTok;
      float part = 0.f;
      for (int k = lane; k < kTok; k += 32) part += dr[k] * prow[k];
      const float r = warp_sum(part);
      for (int k = lane; k < kTok; k += 32) dr[k] = round_to<T>(prow[k] * (dr[k] - r));
    }
    __syncthreads();
    // dQ = dS . k (items (j, row of 7 queries)), dK = dS^T . q (items (j, row of 7 keys))
    for (int it = tid; it < 2 * d * kWin; it += kThreads) {
      const int which = it / (d * kWin), j = it % d, row = (it / d) % kWin;
      float acc[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) acc[i] = 0.f;
      if (which == 0) {
        for (int key = 0; key < kTok; ++key) {
          const float kv = ks[key * d + j];
#pragma unroll
          for (int i = 0; i < kWin; ++i) acc[i] += ds[(row * kWin + i) * kTok + key] * kv;
        }
      } else {
        for (int q = 0; q < kTok; ++q) {
          const float qv = qs[q * d + j];
#pragma unroll
          for (int i = 0; i < kWin; ++i) acc[i] += ds[q * kTok + row * kWin + i] * qv;
        }
      }
#pragma unroll
      for (int i = 0; i < kWin; ++i) dg[(which * kTok + row * kWin + i) * d + j] = acc[i];
    }
    __syncthreads();
    // the bias partials from the f32 dQ, dK, dV
    for (int i = tid; i < n3; i += kThreads) {
      const int m = i / d, j = i % d;
      float sum = 0.f;
      for (int t = 0; t < kTok; ++t) sum += dg[(m * kTok + t) * d + j];
      bp[m * c + hd * d + j] = sum;
    }
    __syncthreads();
    // T(dQ), T(dK), T(dV): to memory for the weight gradients, and for dt2
    for (int i = tid; i < 3 * kTok * d; i += kThreads) {
      const int m = i / (kTok * d), t = (i / d) % kTok, j = i % d;
      const T v = from_f32<T>(dg[i]);
      dg[i] = to_f32(v);
      dqkv[(size_t)m * rows * c + (base + t) * c + hd * d + j] = v;
    }
    __syncthreads();
    // dt2 += T(dQ) . Wq'^T + T(dK) . Wk^T + T(dV) . Wv^T over this head's
    // columns: items (channel, row of 7 tokens), the weights through L1/L2
    for (int it = tid; it < c * kWin; it += kThreads) {
      const int cc = it % c, row = it / c;
      const T* wr = wqkv + ((size_t)cc * heads + hd) * n3;
      float acc[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) acc[i] = 0.f;
      for (int n = 0; n < n3; ++n) {
        const float wv = to_f32(wr[n]);
        const float* gcol = dg + (n / d) * kTok * d + n % d;
#pragma unroll
        for (int i = 0; i < kWin; ++i) acc[i] += gcol[(row * kWin + i) * d] * wv;
      }
#pragma unroll
      for (int i = 0; i < kWin; ++i) acc_t2[(row * kWin + i) * c + cc] += acc[i];
    }
  }
  __syncthreads();
  for (int i = tid; i < kTok * c; i += kThreads) dt2[base * c + i] = from_f32<T>(acc_t2[i]);
}

// K2: one block per (map row, person), a warp per pixel of the row
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ dt2,
              const float* __restrict__ ln_g, T* __restrict__ dx, float* __restrict__ ln_part,
              int h, int w, int c, float eps) {
  extern __shared__ __align__(16) float part[];  // [kWarps][2c]: dgamma, dbeta
  const int pad_h = (kWin - h % kWin) % kWin, pad_w = (kWin - w % kWin) % kWin;
  const int nw = (w + pad_w) / kWin, nwin = ((h + pad_h) / kWin) * nw;
  const int r = blockIdx.x, rp = r + pad_h / 2;
  const size_t row0 = ((size_t)blockIdx.y * h + r) * w;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* pg = part + (size_t)warp * 2 * c;
  float* pb = pg + c;
  for (int i = lane; i < 2 * c; i += 32) pg[i] = 0.f;
  const float fc = (float)c;
  for (int col = warp; col < w; col += kWarps) {
    const size_t off = (row0 + col) * c;
    const T* xr = x + off;
    const T* dyr = dy + off;
    const int cp = col + pad_w / 2;
    const size_t tok = ((size_t)blockIdx.y * nwin + (rp / kWin) * nw + cp / kWin) * kTok +
                       (rp % kWin) * kWin + cp % kWin;
    const T* dtr = dt2 + tok * c;
    float sum = 0.f;
    for (int i = lane; i < c; i += 32) sum += to_f32(xr[i]);
    const float mean = warp_sum(sum) / fc;
    float sq = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float dl = to_f32(xr[i]) - mean;
      sq += dl * dl;
    }
    const float rstd = rsqrtf(warp_sum(sq) / fc + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float xhat = (to_f32(xr[i]) - mean) * rstd, g = to_f32(dtr[i]);
      pg[i] += g * xhat;
      pb[i] += g;
      const float dyg = g * ln_g[i];
      s1 += dyg;
      s2 += dyg * xhat;
    }
    const float m1 = warp_sum(s1) / fc, m2 = warp_sum(s2) / fc;
    T* dxr = dx + off;
    for (int i = lane; i < c; i += 32) {
      const float xhat = (to_f32(xr[i]) - mean) * rstd;
      const float dxl = rstd * (to_f32(dtr[i]) * ln_g[i] - m1 - xhat * m2);
      dxr[i] = from_f32<T>(to_f32(dyr[i]) + round_to<T>(dxl));
    }
  }
  __syncthreads();
  for (int e = tid; e < 2 * c; e += kThreads) {
    float acc = 0.f;
    for (int wp = 0; wp < kWarps; ++wp) acc += part[(size_t)wp * 2 * c + e];
    ln_part[((size_t)blockIdx.y * h + r) * 2 * c + e] = acc;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const float* s, const void* t2,
                       const float* ln_g, const void* wqkv, const float* bqkv, const void* wot,
                       void* dx, void* tokens, float* bias_part, float* ln_part, float* w_part,
                       float* d_vec, float* dw, int p, int h, int w, int c, int heads, float eps,
                       float q_scale, cudaStream_t st) {
  const int nwin = ((h + kWin - 1) / kWin) * ((w + kWin - 1) / kWin);
  const size_t rows = (size_t)p * nwin * kTok;
  const size_t k1_bytes = k1_smem<T>(c, c / heads);
  const size_t k2_bytes = sizeof(float) * kWarps * 2 * (size_t)c;
  if (k1_bytes > kMaxSmem || k2_bytes > kMaxSmem || rows > (size_t)0x7fffffff)
    return cudaErrorInvalidValue;
  T* tok = static_cast<T*>(tokens);
  T* da2 = tok;  // [rows][c] each: da2, o, dQ, dK, dV, dt2
  T* o3 = tok + rows * c;
  T* dqkv = tok + 2 * rows * c;
  T* dt2 = tok + 5 * rows * c;
  cudaError_t err = set_smem(attn_bwd_kernel<T>, k1_bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_kernel<T><<<dim3(nwin, p), kThreads, k1_bytes, st>>>(
      static_cast<const T*>(t2), static_cast<const T*>(dy), s, static_cast<const T*>(wqkv), bqkv,
      static_cast<const T*>(wot), da2, o3, dqkv, dt2, bias_part, h, w, c, heads, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(ln_bwd_kernel<T>, k2_bytes);
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<T><<<dim3(h, p), kThreads, k2_bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), dt2, ln_g, static_cast<T*>(dx),
      ln_part, h, w, c, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_parts(ln_part, d_vec + 4 * c, p * h, 2 * c, 2 * c, 1.f, st);  // dln_g, dln_b
  if (err != cudaSuccess) return err;
  // bias gradients: dbq (the d^-1/2 fold undone), then dbk, dbv, dbo
  err = sum_parts(bias_part, d_vec, p * nwin, c, 4 * c, q_scale, st);
  if (err != cudaSuccess) return err;
  err = sum_parts(bias_part + c, d_vec + c, p * nwin, 3 * c, 4 * c, 1.f, st);
  if (err != cudaSuccess) return err;
  // weight gradients [out][in]: dWq, dWk, dWv against t2, dWo = da2^T o
  const size_t cc = (size_t)c * c;
  const int nrows = (int)rows;
  for (int m = 0; m < 3; ++m) {
    err = outer_sum<T>(dqkv + m * rows * c, t2, w_part, dw + m * cc, nrows, c, c,
                       m == 0 ? q_scale : 1.f, st);
    if (err != cudaSuccess) return err;
  }
  return outer_sum<T>(da2, o3, w_part, dw + 3 * cc, nrows, c, c, 1.f, st);
}

}  // namespace

// x, dy, dx: [p, h, w, c] contiguous, type T (dtype 0 = float32, 1 = bfloat16);
// s [p] f32; t2 [p, nwin, 49, c] of type T from the forward; ln_g [c] f32;
// wqkv, bqkv, wot as the forward (window_attn_block.cu). Scratch: tokens
// [6, p * nwin * 49, c] of type T; float32 bias_part [p * nwin, 4c], ln_part
// [p * h, 2c], w_part [16, c, c]. Outputs (float32): d_vec [6c] = (dbq, dbk,
// dbv, dbo, dln_g, dln_b), dw [4, c, c] = (dWq, dWk, dWv, dWo) in the torch
// Linear layout; q_scale = d^-1/2 (the fold of the packed q weights). Returns
// the cudaError_t of the launches.
extern "C" int i2r_window_attn_train_bwd(const void* x, const void* dy, const void* s,
                                         const void* t2, const void* ln_g, const void* wqkv,
                                         const void* bqkv, const void* wot, void* dx,
                                         void* tokens, void* bias_part, void* ln_part,
                                         void* w_part, void* d_vec, void* dw, int p, int h, int w,
                                         int c, int heads, float eps, float q_scale, int dtype,
                                         void* stream) {
  if (p < 1 || h < 1 || w < 1 || heads < 1 || c < heads || c % heads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const float* g = static_cast<const float*>(ln_g);
  const float* bq = static_cast<const float*>(bqkv);
  float* bp = static_cast<float*>(bias_part);
  float* lp = static_cast<float*>(ln_part);
  float* wp = static_cast<float*>(w_part);
  float* dv = static_cast<float*>(d_vec);
  float* dwp = static_cast<float*>(dw);
  if (dtype == 0)
    return (int)launch_bwd<float>(x, dy, sf, t2, g, wqkv, bq, wot, dx, tokens, bp, lp, wp, dv,
                                  dwp, p, h, w, c, heads, eps, q_scale, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, dy, sf, t2, g, wqkv, bq, wot, dx, tokens, bp, lp,
                                          wp, dv, dwp, p, h, w, c, heads, eps, q_scale, st);
  return (int)cudaErrorInvalidValue;
}
