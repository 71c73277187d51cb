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
//       dt2     = T(T(dQ) . Wq + T(dK) . Wk + T(dV) . Wv)   one f32 sum over
//                                          all heads, then one rounding
//     K2, per row of pixels: un-window dt2 (pad positions dropped), LN1's
//     statistics from x again, dgamma += dt2 xhat, dbeta += dt2,
//       dx = dy + T(rstd (g dt2 - mean(g dt2) - xhat mean(g dt2 xhat)))
//     weight gradients, dW = sum over tokens (the torch Linear layout [out][in]):
//       dWq = d^-1/2 T(dQ)^T t2, dWk = T(dK)^T t2, dWv = T(dV)^T t2, dWo = da2^T o
//     bias gradients: the f32 dQ, dK, dV (d^-1/2 on dbq) and da2 summed over
//     every token, pad tokens included (their q, k, v are the biases, and they
//     are attended to)
// A sample with s = 0 has da2 = 0, so it adds nothing to any gradient and
// its dx is dy. Every sum runs in a fixed order (no atomics): two calls on
// the same inputs give the same bits.
//
// What bounds it on the H100: at branch 0 of a 256x192 input at P=24
// (64x48x78, 70 windows of 49 tokens a person, 2 heads of d = 39) the
// products (q/k/v recompute, dO and dt2: 7 C^2 a token; the four weight
// gradients: 4 C^2; six attention products a head) are 14.8 GFLOP, 15.0 us
// at the bf16 tensor-core peak, and the bytes (x, dy, dx, t2 and the
// weights once) 47 MB, 14.1 us at 3.35 TB/s: both bound it about equally
// (chip_smoke.py::hrt_train_bound counts the same at every map). What
// bounds the kernels in practice is each block's chain of dependent steps
// (probes/attn_bwd_sweep.py; PERF.md).
//
// Design, bf16 (five launches; the plan is ops/cuda/hrformer_block_train.py::
// attn_bwd_plan, from the card's SM count):
// * pass 1 (attn_bwd_mma_kernel), one block of 8 warps per (window, head
//   group, person): as Kernel E's pass 1 (window_attn.cuh::attn_item_mma),
//   all heads of a window in a block where the grid still holds two blocks
//   per SM, else the largest group that does and whose shared memory fits
//   two blocks per SM. The block stages da2 = T(s dy) of the window in a
//   64-row bf16 tile (rows 49-63, pad tokens and channels past C are 0; dy by
//   cp.async, scaled in place) and runs dO = T(da2 . Wo_h^T) for the group's
//   heads on mma.sync m16n8k16 (Wo's fragments from L2, two k-steps ahead).
//   Then per head: t2's tile by cp.async into the same bytes; q, k, v by the
//   forward's own fragments and loop (the same bits); each warp takes 16
//   query rows against the 64 tile rows: the logits, keys 49-63 masked to
//   -inf (tile rows, not keys; the window's pad tokens are keys, through the
//   biases), the f32 softmax, o = T(T(P) . v) from registers, dP = dO . v^T,
//   dS in registers, dQ = T(dS) . k with T(dS) from registers; T(P) and
//   T(dS) go to shared memory (over t2's tile, done with) so that the warps
//   of key rows read their transposes by ldmatrix.trans for dK = T(dS)^T . q
//   and dV = T(P)^T . dO. The head dim is zero-padded 39 -> 48: with W and b
//   zero past d, q, k, v, dO, dQ, dK, dV are exactly 0 there; dS is 0 on tile
//   rows 49-63 (dO is) and on the masked keys (P is). o, T(dQ), T(dK), T(dV)
//   go to token arrays, the f32 column sums of dQ, dK, dV (bias gradients) to
//   per-window partials in a fixed order.
// * pass 2 (dt2_mma_kernel), one block per (64 token rows, column block):
//   dt2 = T([T(dQ) T(dK) T(dV)] . Wqkv) with k over all heads' 3 pad16(d)
//   columns (Wqkv's fragments, n over C in, packed once per forward), the row
//   tile staged 256 columns at a time in two cp.async stages, the weight
//   fragments read kBAhead k-steps ahead.
// * K2 (ln_bwd_kernel) as the f32 route below.
// * weight gradients (dw_mma_kernel): one launch for the four products A^T B
//   over the token rows, a block per (64 x 64 output tile, row slice), the
//   three q/k/v products of a tile on one staged tile of t2, both operands
//   by ldmatrix.trans from a ring of kWStages cp.async stages; the
//   slice count is the plan's (at least two blocks per SM at every map).
//   Then bwd_sum_kernel sums the slices, the windows' bias partials and K2's
//   LayerNorm partials, each in a fixed order.
//
// Design, f32 (the first CUDA-core template; TF32 would not hold the f32
// checks' 1e-4): K1 one block of 256 threads per (7x7 window, person),
// Kernel E's item shape (one output column x one window row of 7 tokens),
// the window's dt2 accumulated over heads in a [49][C] f32 tile in shared
// memory; the weight gradients through common.cuh::outer_sum (16 row slices
// and a fixed-order sum, as Kernel D); K2 one block per (row of pixels,
// person), one warp per pixel, per-warp partial sums of dgamma and dbeta
// added in a fixed order. Head dim d is a runtime value (39 on HRFormer-B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attn.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// the bf16 backward's constants (ops/cuda/hrformer_block_train.py's plan takes
// them; tests/test_torch_attn_bwd_tiles.py reads them here)
constexpr int kPLd = kRows + 8;     // row stride of the P and dS tiles [64 queries][64 keys]
constexpr int kKChunk = 256;        // K columns of pass 2's row tile a stage
constexpr int kWTile = 64;          // weight-gradient tile edge (m, n), token rows a stage
constexpr int kWStages = 2;         // stages of the weight gradients' cp.async ring
constexpr int kBAhead = 4;          // k-steps pass 2 reads its weight fragments ahead
constexpr int kWProducts = 4;       // dWq, dWk, dWv, dWo
constexpr size_t kTwoPerSm = 113 * 1024;  // shared memory that still fits two blocks per SM
static_assert(kWTile == kRows, "the weight-gradient stages are row tiles of kRows");

// Pass 1's shared memory for width c, head dim d and `group` heads a block:
// the window tile [kRows][pad16(c) + 8] (da2, then t2 per head, then the
// head's T(P) and T(dS) [kRows][kPLd] in the same bytes), q, k, v and the
// group's dO [kRows][pad16(d) + 8] each (bf16), the bias sums [4][3][pad16(d)]
// (f32), the tokens' map rows and columns (ops/cuda/hrformer_block_train.py::
// AttnBwdPlan.smem1 is the same sum).
__host__ __device__ inline size_t bwd_region_bytes(int c) {
  return sizeof(bf16) * kRows * (size_t)(amma::pad16(c) + 8 > 2 * kPLd ? amma::pad16(c) + 8 : 2 * kPLd);
}
__host__ __device__ inline size_t bwd1_smem_bytes(int c, int d, int group) {
  return bwd_region_bytes(c) + sizeof(bf16) * kRows * (amma::pad16(d) + 8) * (size_t)(3 + group) +
         sizeof(float) * 4 * 3 * amma::pad16(d) + sizeof(int) * 2 * kRows;
}
// ... pass 2's: two stages of a row tile [kRows][kKChunk + 8] (AttnBwdPlan.smem2)
inline size_t bwd2_smem_bytes() { return sizeof(bf16) * 2 * kRows * (kKChunk + 8); }
// ... the weight gradients': kWStages stages of four tiles [kWTile][kWTile + 8]
// (the q/k/v products' three of dqkv and one of t2)
inline size_t bwd_w_smem_bytes() { return sizeof(bf16) * kWStages * 4 * kWTile * (kWTile + 8); }

// Whether the bf16 backward takes this plan: the padded head dim, heads in
// groups of `group`, `cols` n-tiles a block of pass 2, `slices` row slices of
// the weight gradients, pass 1's shared memory.
inline bool attn_bwd_fits(int c, int heads, int group, int cols, int slices) {
  return amma::pad16(c / heads) <= kMaxDp && group >= 1 && heads % group == 0 && cols >= 1 &&
         cols <= kMaxCols && slices >= 1 && bwd1_smem_bytes(c, c / heads, group) <= kMaxSmem;
}

// Elements a copy of stage_rows for rows of `ld` elements from `p` whose
// copied columns end at a multiple of `unit`: 8 (16 bytes), 2 (4 bytes) or 1.
__device__ __forceinline__ int copy_width(const void* p, size_t ld, int unit) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (a % 16 == 0 && ld % 8 == 0 && unit % 8 == 0) return 8;
  return a % 4 == 0 && ld % 2 == 0 && unit % 2 == 0 ? 2 : 1;
}

// A tile [kRows][lds] in shared memory from row(t), a pointer to row t's
// first element or null for a row of zeros: columns below `limit` copied,
// the rest of the `ncols` (a multiple of 8) zero. kVec elements a copy: 8 or
// 2 by cp.async, every thread's copies in flight at once (the caller commits
// and waits), 1 by plain loads; a constant, so that with a constant `ncols`
// a copy's row and column cost no division. `any` is a valid address for
// the copies that read nothing.
template <int kVec, typename Row>
__device__ __forceinline__ void stage_rows_v(bf16* dst, int lds, int ncols, int limit,
                                             const bf16* any, Row row) {
  const int per = ncols / kVec;
  for (int e = threadIdx.x; e < kRows * per; e += kThreads) {
    const int t = e / per, i = kVec * (e % per);
    const bf16* src = row(t);
    const bool in = src != nullptr && i < limit;
    if (kVec == 8)
      amma::cp_async16(dst + t * lds + i, in ? src + i : any, in);
    else if (kVec == 2)
      amma::cp_async4(dst + t * lds + i, in ? src + i : any, in);
    else
      dst[t * lds + i] = in ? src[i] : from_f32<bf16>(0.f);
  }
}

// stage_rows_v for a copy width `vec` (copy_width) known at run time
template <typename Row>
__device__ __forceinline__ void stage_rows(bf16* dst, int lds, int ncols, int limit, int vec,
                                           const bf16* any, Row row) {
  if (vec == 8)
    stage_rows_v<8>(dst, lds, ncols, limit, any, row);
  else if (vec == 2)
    stage_rows_v<2>(dst, lds, ncols, limit, any, row);
  else
    stage_rows_v<1>(dst, lds, ncols, limit, any, row);
}

// acc = as[kRows][ld] . B over ks k-steps for n-tiles [0, ntc) of B, n-tile
// j to warp j % kWarps over all four row tiles; B as mma fragments (n-tile
// nt, k-step kk, lane l at wb[(nt * ks + kk) * 32 + l]) from L2, two k-steps
// ahead; then epi(nt, acc) per n-tile. The loop of window_attn.cuh::
// attn_item_mma's q/k/v product, so the recomputed q, k, v are the
// forward's bit for bit (each element sums the same k-steps in the same order).
template <typename Epi>
__device__ __forceinline__ void proj_mma(const bf16* as, int ld, const uint2* __restrict__ wb,
                                         int ks, int ntc, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint2* wl = wb + lane;
  float acc[kProjTiles][4][4];
  uint2 b0[kProjTiles], b1[kProjTiles];
#pragma unroll
  for (int j = 0; j < kProjTiles; ++j) {
    const int nt = warp + kWarps * j;
    const bool in = nt < ntc;
    b0[j] = in ? __ldg(wl + (size_t)nt * ks * 32) : make_uint2(0u, 0u);
    b1[j] = in && ks > 1 ? __ldg(wl + ((size_t)nt * ks + 1) * 32) : make_uint2(0u, 0u);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) acc[j][mt][0] = acc[j][mt][1] = acc[j][mt][2] = acc[j][mt][3] = 0.f;
  }
  for (int kk = 0; kk < ks; ++kk) {
    uint2 bk[kProjTiles];
#pragma unroll
    for (int j = 0; j < kProjTiles; ++j) {
      const int nt = warp + kWarps * j;
      bk[j] = b0[j];
      b0[j] = b1[j];
      if (nt < ntc && kk + 2 < ks) b1[j] = __ldg(wl + ((size_t)nt * ks + kk + 2) * 32);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t a[4];
      amma::ldsm_x4(a, as + amma::a_off(lane, mt * 16, kk * 16, ld));
#pragma unroll
      for (int j = 0; j < kProjTiles; ++j)
        if (warp + kWarps * j < ntc) amma::mma(acc[j][mt], a, bk[j].x, bk[j].y);
    }
  }
#pragma unroll
  for (int j = 0; j < kProjTiles; ++j)
    if (warp + kWarps * j < ntc) epi(warp + kWarps * j, acc[j]);
}

// Pass 1, one block per (window, head group, person): K1 of the group's heads.
// t2 [p, nwin, 49, c] from the forward; dy [p, h, w, c]; s [p]. wf: the
// forward's q/k/v fragments (hrformer_block.py::attn_fragments); bqkv
// [heads][3][d]; wdo: Wo's rows of each head's inputs as fragments (n over
// the head's pad16(d), k over the c outputs; ops/cuda/hrformer_block_train.py::
// attn_bwd_fragments), [heads][pad16(d)/8][pad16(c)/16][32 lanes]. Writes, at
// the window's 49 token rows: da2 and dbo's partial (head group 0), o's
// columns of the group's heads, and dqkv [rows][3][heads][pad16(d)] =
// T(dQ), T(dK), T(dV) (zero past d); the f32 sums of dQ, dK, dV over the
// window into bias_part [p * nwin][4c] at the group's columns.
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_mma_kernel(const bf16* __restrict__ t2, const bf16* __restrict__ dy,
                    const float* __restrict__ s, const uint2* __restrict__ wf,
                    const float* __restrict__ bqkv, const uint2* __restrict__ wdo,
                    bf16* __restrict__ da2, bf16* __restrict__ o3, bf16* __restrict__ dqkv,
                    float* __restrict__ bias_part, int h, int w, int c, int heads, int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nwin = ((h + kWin - 1) / kWin) * ((w + kWin - 1) / kWin);
  const int win = blockIdx.x % nwin, hg = blockIdx.x / nwin, person = blockIdx.y;
  const int d = c / heads, dp = amma::pad16(d), cp = amma::pad16(c);
  const int ldc = cp + 8, ldq = dp + 8, ks1 = cp / 16, nt3 = 3 * dp / 8, nd = dp / 8;
  const int ldx = 3 * heads * dp;  // a token's row of dqkv
  bf16* ts = reinterpret_cast<bf16*>(smem_raw);  // the window tile; then T(P), T(dS)
  bf16* ps = ts;
  bf16* dss = ts + kRows * kPLd;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + bwd_region_bytes(c));
  bf16* kst = qs + kRows * ldq;
  bf16* vs = kst + kRows * ldq;
  bf16* dos = vs + kRows * ldq;  // [group][kRows][ldq]
  float* red = reinterpret_cast<float*>(dos + group * kRows * ldq);  // [4 row tiles][3][dp]
  int* s_row = reinterpret_cast<int*>(red + 12 * dp);  // [kRows]: map row, or -1
  int* s_col = s_row + kRows;

  const int pad_h = (kWin - h % kWin) % kWin, pad_w = (kWin - w % kWin) % kWin;
  const int nw = (w + pad_w) / kWin, wy = win / nw, wx = win % nw;
  const size_t blk = (size_t)person * nwin + win, base = blk * kTok;  // the window's first token row
  const bf16* dyp = dy + (size_t)person * h * w * c;
  float* bp = bias_part + blk * 4 * c;  // dbq, dbk, dbv, dbo partials of the window
  const float scale = s[person];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3), rt = warp & 3, half = warp >> 2;
  const int vdy = copy_width(dy, c, c), vt2 = copy_width(t2, c, c);

  for (int t = tid; t < kRows; t += kThreads) {
    const int r = wy * kWin + t / kWin - pad_h / 2, q = wx * kWin + t % kWin - pad_w / 2;
    s_row[t] = t < kTok && r >= 0 && r < h && q >= 0 && q < w ? r : -1;
    s_col[t] = q;
  }
  __syncthreads();
  // da2 = T(s dy) of the window: dy at its real tokens (0 elsewhere), scaled in place
  stage_rows(ts, ldc, cp, c, vdy, dy, [&](int t) {
    return s_row[t] >= 0 ? dyp + ((size_t)s_row[t] * w + s_col[t]) * c : nullptr;
  });
  amma::cp_commit();
  amma::cp_wait<0>();
  __syncthreads();
  for (int e = tid; e < kTok * c; e += kThreads) {
    const int t = e / c, i = e % c;
    if (s_row[t] >= 0) ts[t * ldc + i] = from_f32<bf16>(scale * to_f32(ts[t * ldc + i]));
  }
  __syncthreads();
  if (hg == 0) {  // da2 at the window's token rows (pad tokens 0) and its sums (dbo)
    for (int i = tid; i < c; i += kThreads) {
      float sum = 0.f;
      for (int t = 0; t < kTok; ++t) {
        const bf16 v = ts[t * ldc + i];
        da2[(base + t) * c + i] = v;
        sum += to_f32(v);
      }
      bp[3 * c + i] = sum;
    }
  }
  // dO = T(da2 . Wo_h^T) of the group's heads: n-tile n is head n / nd's
  // columns (n % nd) * 8..; zero past d and on rows without dy
  const int ndo = group * nd;
  for (int n0 = 0; n0 < ndo; n0 += kWarps * kProjTiles)
    proj_mma(ts, ldc, wdo + ((size_t)hg * ndo + n0) * ks1 * 32, ks1,
             min(kWarps * kProjTiles, ndo - n0), [&](int nt, const float (&acc)[4][4]) {
               const int n = n0 + nt;
               bf16* dst = dos + (n / nd) * kRows * ldq + (n % nd) * 8 + c2;
#pragma unroll
               for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                 for (int hh = 0; hh < 2; ++hh)
                   *reinterpret_cast<uint32_t*>(dst + (mt * 16 + g + 8 * hh) * ldq) =
                       amma::pack(acc[mt][2 * hh], acc[mt][2 * hh + 1]);
             });

  // a warp's T(dX) (m = 0, 1, 2: dQ, dK, dV) of its 16 rows and n-tiles
  // half + 2 jn: to dqkv at the token rows, and its f32 column sums to red
  auto store = [&](const float (&acc)[kPvTiles][4], int m, int hd) {
#pragma unroll
    for (int jn = 0; jn < kPvTiles; ++jn) {
      const int n = half + 2 * jn;
      if (n >= nd) continue;
      float s0 = acc[jn][0] + acc[jn][2], s1 = acc[jn][1] + acc[jn][3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (g == 0) {
        red[(rt * 3 + m) * dp + n * 8 + c2] = s0;
        red[(rt * 3 + m) * dp + n * 8 + c2 + 1] = s1;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = rt * 16 + g + 8 * hh;
        if (t < kTok)
          *reinterpret_cast<uint32_t*>(dqkv + (base + t) * ldx + (size_t)(m * heads + hd) * dp +
                                       n * 8 + c2) =
              amma::pack(acc[jn][2 * hh], acc[jn][2 * hh + 1]);
      }
    }
  };

  for (int hi = 0; hi < group; ++hi) {
    const int hd = hg * group + hi;
    const bf16* doh = dos + hi * kRows * ldq;
    __syncthreads();  // the region free: dO's product / the previous head's dK, dV done
    stage_rows(ts, ldc, cp, c, vt2, t2,
               [&](int t) { return t < kTok ? t2 + (base + t) * c : nullptr; });
    amma::cp_commit();
    amma::cp_wait<0>();
    __syncthreads();
    // q, k, v of the head: + bias, rounded (attn_item_mma's epilogue)
    proj_mma(ts, ldc, wf + (size_t)hd * nt3 * ks1 * 32, ks1, nt3,
             [&](int nt, const float (&acc)[4][4]) {
               const int col = nt * 8 + c2, m = col / dp, jj = col % dp;
               const float* bq = bqkv + (size_t)(hd * 3 + m) * d;
               const float b0 = jj < d ? bq[jj] : 0.f, b1 = jj + 1 < d ? bq[jj + 1] : 0.f;
               bf16* dst = (m == 0 ? qs : m == 1 ? kst : vs) + jj;
#pragma unroll
               for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                 for (int hh = 0; hh < 2; ++hh)
                   *reinterpret_cast<uint32_t*>(dst + (mt * 16 + g + 8 * hh) * ldq) =
                       amma::pack(acc[mt][2 * hh] + b0, acc[mt][2 * hh + 1] + b1);
             });
    __syncthreads();
    // warp (rt, half): query rows 16 rt.. against the 64 tile rows, of which
    // the 49 tokens are keys (the logits and softmax of attn_item_mma)
    float pr[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) pr[j][0] = pr[j][1] = pr[j][2] = pr[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxDp / 16; ++kk) {
      if (kk * 16 < dp) {
        uint32_t qa[4];
        amma::ldsm_x4(qa, qs + amma::a_off(lane, rt * 16, kk * 16, ldq));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kb[4];
          amma::ldsm_x4(kb, kst + amma::b_off(lane, np * 16, kk * 16, ldq));
          amma::mma(pr[2 * np], qa, kb[0], kb[1]);
          amma::mma(pr[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kc = 8 * j + c2;
      if (kc >= kTok) pr[j][0] = pr[j][2] = -INFINITY;
      if (kc + 1 >= kTok) pr[j][1] = pr[j][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(pr[j][0], pr[j][1]));
      mx1 = fmaxf(mx1, fmaxf(pr[j][2], pr[j][3]));
    }
    mx0 = amma::quad_max(mx0);
    mx1 = amma::quad_max(mx1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pr[j][0] = expf(pr[j][0] - mx0);
      pr[j][1] = expf(pr[j][1] - mx0);
      pr[j][2] = expf(pr[j][2] - mx1);
      pr[j][3] = expf(pr[j][3] - mx1);
      l0 += pr[j][0] + pr[j][1];
      l1 += pr[j][2] + pr[j][3];
    }
    l0 = amma::quad_sum(l0);
    l1 = amma::quad_sum(l1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pr[j][0] /= l0;
      pr[j][1] /= l0;
      pr[j][2] /= l1;
      pr[j][3] /= l1;
    }
    // T(P) into the region (t2's last reader, the product above, is done):
    // each warp of a row tile writes its half of the key n-tiles
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((j >> 2) != half) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(ps + (rt * 16 + g + 8 * hh) * kPLd + j * 8 + c2) =
            amma::pack(pr[j][2 * hh], pr[j][2 * hh + 1]);
    }
    {  // o = T(T(P) . v) at the window's 49 token rows, the head's columns
      float ov[kPvTiles][4];
#pragma unroll
      for (int jn = 0; jn < kPvTiles; ++jn) ov[jn][0] = ov[jn][1] = ov[jn][2] = ov[jn][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        amma::acc_to_a(pa, pr[2 * kk], pr[2 * kk + 1]);
#pragma unroll
        for (int jn = 0; jn < kPvTiles; ++jn) {
          const int n = half + 2 * jn;
          if (n < nd) {
            uint32_t vb[2];
            amma::ldsm_x2_t(vb, vs + amma::a_off(lane & 15, kk * 16, n * 8, ldq));
            amma::mma(ov[jn], pa, vb[0], vb[1]);
          }
        }
      }
#pragma unroll
      for (int jn = 0; jn < kPvTiles; ++jn) {
        const int n = half + 2 * jn;
        if (n >= nd) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = rt * 16 + g + 8 * hh;
          if (t >= kTok) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jj = n * 8 + c2 + e;
            if (jj < d) o3[(base + t) * c + hd * d + jj] = from_f32<bf16>(ov[jn][2 * hh + e]);
          }
        }
      }
    }
    // dP = dO . v^T (f32), then dS = T(P (dP - rowsum(dP P))) in place
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxDp / 16; ++kk) {
      if (kk * 16 < dp) {
        uint32_t da[4];
        amma::ldsm_x4(da, doh + amma::a_off(lane, rt * 16, kk * 16, ldq));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t vb[4];
          amma::ldsm_x4(vb, vs + amma::b_off(lane, np * 16, kk * 16, ldq));
          amma::mma(ds[2 * np], da, vb[0], vb[1]);
          amma::mma(ds[2 * np + 1], da, vb[2], vb[3]);
        }
      }
    }
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      r0 += ds[j][0] * pr[j][0] + ds[j][1] * pr[j][1];
      r1 += ds[j][2] * pr[j][2] + ds[j][3] * pr[j][3];
    }
    r0 = amma::quad_sum(r0);
    r1 = amma::quad_sum(r1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ds[j][0] = round_to<bf16>(pr[j][0] * (ds[j][0] - r0));
      ds[j][1] = round_to<bf16>(pr[j][1] * (ds[j][1] - r0));
      ds[j][2] = round_to<bf16>(pr[j][2] * (ds[j][2] - r1));
      ds[j][3] = round_to<bf16>(pr[j][3] * (ds[j][3] - r1));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((j >> 2) != half) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(dss + (rt * 16 + g + 8 * hh) * kPLd + j * 8 + c2) =
            amma::pack(ds[j][2 * hh], ds[j][2 * hh + 1]);
    }
    {  // dQ = T(dS) . k, T(dS) from registers
      float dq[kPvTiles][4];
#pragma unroll
      for (int jn = 0; jn < kPvTiles; ++jn) dq[jn][0] = dq[jn][1] = dq[jn][2] = dq[jn][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t sa[4];
        amma::acc_to_a(sa, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
        for (int jn = 0; jn < kPvTiles; ++jn) {
          const int n = half + 2 * jn;
          if (n < nd) {
            uint32_t kb[2];
            amma::ldsm_x2_t(kb, kst + amma::a_off(lane & 15, kk * 16, n * 8, ldq));
            amma::mma(dq[jn], sa, kb[0], kb[1]);
          }
        }
      }
      store(dq, 0, hd);
    }
    __syncthreads();  // T(P) and T(dS) written
    {  // warp (rt, half): key rows 16 rt..; dK = T(dS)^T . q, dV = T(P)^T . dO
      float dk[kPvTiles][4], dv[kPvTiles][4];
#pragma unroll
      for (int jn = 0; jn < kPvTiles; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[jn][e] = dv[jn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t sa[4], pa[4];
        amma::ldsm_x4_t(sa, dss + amma::b_off(lane, kk * 16, rt * 16, kPLd));
        amma::ldsm_x4_t(pa, ps + amma::b_off(lane, kk * 16, rt * 16, kPLd));
#pragma unroll
        for (int jn = 0; jn < kPvTiles; ++jn) {
          const int n = half + 2 * jn;
          if (n < nd) {
            uint32_t qb[2], ob[2];
            amma::ldsm_x2_t(qb, qs + amma::a_off(lane & 15, kk * 16, n * 8, ldq));
            amma::mma(dk[jn], sa, qb[0], qb[1]);
            amma::ldsm_x2_t(ob, doh + amma::a_off(lane & 15, kk * 16, n * 8, ldq));
            amma::mma(dv[jn], pa, ob[0], ob[1]);
          }
        }
      }
      store(dk, 1, hd);
      store(dv, 2, hd);
    }
    __syncthreads();  // the column sums of the four row tiles in red
    for (int i = tid; i < 3 * d; i += kThreads) {
      const int m = i / d, j = i % d;
      const float* r = red + m * dp + j;
      bp[m * c + hd * d + j] = ((r[0] + r[3 * dp]) + r[6 * dp]) + r[9 * dp];
    }
  }
}

// Pass 2, one block per (kRows token rows, column block): dt2 = T(dX . Wqkv)
// for the output n-tiles [cols cb, cols (cb + 1)) of the pad16(c) / 8, dX =
// dqkv's rows (kdim = 3 heads pad16(d) columns) staged kKChunk columns at a
// time in two cp.async stages, Wqkv as fragments (wdt, n over the c inputs,
// k over dqkv's columns: n-tile j, k-step kk, lane l at wdt[(j * kdim/16 +
// kk) * 32 + l]) read from L2 kBAhead k-steps ahead; one f32 sum over all
// heads, then one rounding (JAX's single rounding point of dt2).
__global__ void __launch_bounds__(kThreads, 2)
dt2_mma_kernel(const bf16* __restrict__ dqkv, const uint2* __restrict__ wdt,
               bf16* __restrict__ dt2, int rows, int c, int kdim, int cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kJ = kMaxCols / kWarps, kLd = kKChunk + 8, kSteps = kKChunk / 16;
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // [2][kRows][kLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const long r0 = (long)blockIdx.x * kRows;
  const int n0 = blockIdx.y * cols, nc = min(cols, amma::pad16(c) / 8 - n0);
  const int ks = kdim / 16, chunks = (kdim + kKChunk - 1) / kKChunk;
  auto stage = [&](int ch) {
    const int k0 = ch * kKChunk;
    stage_rows_v<8>(buf + (ch & 1) * kRows * kLd, kLd, kKChunk, kdim - k0, dqkv, [&](int t) {
      return r0 + t < rows ? dqkv + (size_t)(r0 + t) * kdim + k0 : nullptr;
    });
    amma::cp_commit();
  };
  float acc[kJ][4][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) acc[j][mt][0] = acc[j][mt][1] = acc[j][mt][2] = acc[j][mt][3] = 0.f;
  auto load_b = [&](uint2 (&b)[kJ], int kk) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int n = warp + kWarps * j;
      b[j] = n < nc ? __ldg(wdt + ((size_t)(n0 + n) * ks + kk) * 32 + lane) : make_uint2(0u, 0u);
    }
  };
  static_assert(kSteps % kBAhead == 0, "a stage's k-steps are whole rounds of the ring");
  uint2 ring[kBAhead][kJ];  // k-step kk's fragments in ring[kk % kBAhead]
#pragma unroll
  for (int i = 0; i < kBAhead; ++i)
    if (i < ks) load_b(ring[i], i);
  stage(0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage(ch + 1);
      amma::cp_wait<1>();
    } else {
      amma::cp_wait<0>();
    }
    __syncthreads();
    const bf16* as = buf + (ch & 1) * kRows * kLd;
    const int kend = min(kSteps, ks - ch * kSteps);
    for (int kl0 = 0; kl0 < kend; kl0 += kBAhead) {
#pragma unroll
      for (int i = 0; i < kBAhead; ++i) {
        const int kl = kl0 + i, kk = ch * kSteps + kl;
        if (kl >= kend) break;
        uint2 bk[kJ];
#pragma unroll
        for (int j = 0; j < kJ; ++j) bk[j] = ring[i][j];
        if (kk + kBAhead < ks) load_b(ring[i], kk + kBAhead);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[4];
          amma::ldsm_x4(a, as + amma::a_off(lane, mt * 16, kl * 16, kLd));
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            if (warp + kWarps * j < nc) amma::mma(acc[j][mt], a, bk[j].x, bk[j].y);
        }
      }
    }
    __syncthreads();  // this stage is staged again two chunks on
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int n = warp + kWarps * j, col = (n0 + n) * 8 + c2;
    if (n >= nc || col >= c) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = r0 + mt * 16 + g + 8 * hh;
        if (row >= rows) continue;
        bf16* dst = dt2 + (size_t)row * c + col;
        if (c % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc[j][mt][2 * hh], acc[j][mt][2 * hh + 1]);
        } else {
          dst[0] = from_f32<bf16>(acc[j][mt][2 * hh]);
          if (col + 1 < c) dst[1] = from_f32<bf16>(acc[j][mt][2 * hh + 1]);
        }
      }
  }
}

// The four weight gradients A^T . B over the token rows of one slice:
// dWq,k,v = T(dX)^T . t2 (A: dqkv's columns of m = 0, 1, 2, mq = heads
// pad16(d) of them), dWo = da2^T . o. A block per (64 x 64 output tile,
// slice): the blocks of the first ntq x ntn tiles run the three q/k/v
// products of their tile on one staged tile of t2, the rest dWo's. Token rows
// staged kWTile at a time in a ring of kWStages cp.async stages, kWStages - 1
// in flight while one is multiplied; A^T by ldmatrix.trans as the A operand,
// B by ldmatrix.trans as the B operand, each B fragment serving every
// product of the block; warp (wm, wn) takes output rows 16 wm.. and columns
// 32 wn... Writes the tile's f32 sums to part [slice][product][mmax][nmax].
__global__ void __launch_bounds__(kThreads, 2)
dw_mma_kernel(const bf16* __restrict__ dqkv, const bf16* __restrict__ t2,
              const bf16* __restrict__ da2, const bf16* __restrict__ o3,
              float* __restrict__ part, int rows, int c, int mq, int per, int mmax, int nmax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = kWTile + 8, kTile = kWTile * kLd;
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // [kWStages][A0, A1, A2, B][kWTile][kLd]
  const int ntn = (c + kWTile - 1) / kWTile, ntq = (mq + kWTile - 1) / kWTile;
  const bool qkv = (int)blockIdx.x < ntq * ntn;
  const int tile = qkv ? blockIdx.x : blockIdx.x - ntq * ntn;
  const int m0 = tile / ntn * kWTile, n0 = tile % ntn * kWTile, np = qkv ? 3 : 1;
  const bf16* a = qkv ? dqkv : da2;
  const bf16* b = qkv ? t2 : o3;
  const int lda = qkv ? 3 * mq : c, am = qkv ? mq : c;
  const int va = copy_width(a, lda, am), vb = copy_width(b, c, c);
  const long t0 = (long)blockIdx.y * per, t1 = min((long)rows, t0 + per);
  auto stage = [&](int ch) {  // token rows of chunk ch into stage ch % kWStages
    const long r = t0 + (long)ch * kWTile;
    bf16* st = buf + ch % kWStages * 4 * kTile;
    for (int p = 0; p < np; ++p)
      stage_rows(st + p * kTile, kLd, kWTile, am - m0, va, a, [&](int t) {
        return r + t < t1 ? a + (size_t)(r + t) * lda + p * mq + m0 : nullptr;
      });
    stage_rows(st + 3 * kTile, kLd, kWTile, c - n0, vb, b, [&](int t) {
      return r + t < t1 ? b + (size_t)(r + t) * c + n0 : nullptr;
    });
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3), wm = warp & 3, wn = warp >> 2;
  float acc[3][4][4];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;
  const int chunks = t1 > t0 ? (int)((t1 - t0 + kWTile - 1) / kWTile) : 0;
#pragma unroll
  for (int ch = 0; ch < kWStages - 1; ++ch) {  // one commit group per chunk, empty past the end
    if (ch < chunks) stage(ch);
    amma::cp_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    amma::cp_wait<kWStages - 2>();  // chunk ch has landed
    __syncthreads();                // ... for every thread; chunk ch - 1's stage is free
    if (ch + kWStages - 1 < chunks) stage(ch + kWStages - 1);
    amma::cp_commit();
    const bf16* st = buf + ch % kWStages * 4 * kTile;
#pragma unroll
    for (int kk = 0; kk < kWTile / 16; ++kk) {
      uint32_t bfr[2][4];
#pragma unroll
      for (int np2 = 0; np2 < 2; ++np2)
        amma::ldsm_x4_t(bfr[np2], st + 3 * kTile + amma::a_off(lane, kk * 16, wn * 32 + np2 * 16, kLd));
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        if (p >= np) break;
        uint32_t af[4];
        amma::ldsm_x4_t(af, st + p * kTile + amma::b_off(lane, kk * 16, wm * 16, kLd));
#pragma unroll
        for (int np2 = 0; np2 < 2; ++np2) {
          amma::mma(acc[p][2 * np2], af, bfr[np2][0], bfr[np2][1]);
          amma::mma(acc[p][2 * np2 + 1], af, bfr[np2][2], bfr[np2][3]);
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if (p >= np) break;
    float* out = part + (((size_t)blockIdx.y * kWProducts + (qkv ? p : 3)) * mmax + m0 +
                         wm * 16) * nmax + n0 + wn * 32;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(out + (size_t)(g + 8 * hh) * nmax + j * 8 + c2) =
            make_float2(acc[p][j][2 * hh], acc[p][j][2 * hh + 1]);
  }
}

// The sums of the partials, each in a fixed order: blocks [0, w_blocks) a
// thread per weight-gradient element over the slices (the 1/sqrt(d) fold
// undone on dWq, rows of dqkv's padded head columns mapped back to the
// torch layout [out][in]); the rest a warp per vector element: dbq (the fold
// undone), dbk, dbv, dbo over the windows' bias_part rows, dln_g, dln_b over
// ln_part's, lane l summing rows l, l + 32, ... and the lanes in a fixed tree.
__global__ void __launch_bounds__(kThreads)
bwd_sum_kernel(const float* __restrict__ part, const float* __restrict__ bias_part,
               const float* __restrict__ ln_part, float* __restrict__ d_vec,
               float* __restrict__ dw, int c, int heads, int slices, int mmax, int nmax,
               int windows, int ln_rows, float q_scale, int w_blocks) {
  if ((int)blockIdx.x < w_blocks) {
    const long cc = (long)c * c, e = (long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= kWProducts * cc) return;
    const int prod = (int)(e / cc), i = (int)(e / c % c), j = (int)(e % c);
    const int d = c / heads, row = prod < 3 ? i / d * amma::pad16(d) + i % d : i;
    float acc = 0.f;
    for (int z = 0; z < slices; ++z)
      acc += part[(((size_t)z * kWProducts + prod) * mmax + row) * nmax + j];
    dw[e] = prod == 0 ? q_scale * acc : acc;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int v = ((int)blockIdx.x - w_blocks) * kWarps + (threadIdx.x >> 5);
  if (v >= 6 * c) return;
  const bool bias = v < 4 * c;
  const float* src = bias ? bias_part + v : ln_part + (v - 4 * c);
  const int parts = bias ? windows : ln_rows, stride = bias ? 4 * c : 2 * c;
  float acc = 0.f;
  for (int z = lane; z < parts; z += 32) acc += src[(size_t)z * stride];
  acc = warp_sum(acc);
  if (lane == 0) d_vec[v] = v < c ? q_scale * acc : acc;
}

// The bf16 backward's five launches (group, cols, slices: the plan).
cudaError_t launch_bwd_bf16(const void* x, const void* dy, const float* s, const void* t2,
                            const float* ln_g, const float* bqkv, const void* wf,
                            const void* wdo, const void* wdt, void* dx, void* tokens,
                            void* dqkv, float* bias_part, float* ln_part, float* w_part,
                            float* d_vec, float* dw, int p, int h, int w, int c, int heads,
                            int group, int cols, int slices, float eps, float q_scale,
                            cudaStream_t st) {
  if (!attn_bwd_fits(c, heads, group, cols, slices) || wf == nullptr || wdo == nullptr ||
      wdt == nullptr || dqkv == nullptr)
    return cudaErrorInvalidValue;
  const int nwin = ((h + kWin - 1) / kWin) * ((w + kWin - 1) / kWin);
  const int d = c / heads, dp = amma::pad16(d), mq = heads * dp, kdim = 3 * mq;
  const long rows = (long)p * nwin * kTok;
  const size_t b1 = bwd1_smem_bytes(c, d, group), b2 = bwd2_smem_bytes(),
               bw = bwd_w_smem_bytes(), k2_bytes = sizeof(float) * kWarps * 2 * (size_t)c;
  if (rows > 0x7fffffffL || (long)nwin * (heads / group) > 0x7fffffffL || k2_bytes > kMaxSmem ||
      reinterpret_cast<uintptr_t>(dqkv) % 16 != 0)
    return cudaErrorInvalidValue;
  // the slices of the weight gradients: whole stages of kWTile rows
  const long per = ((rows + slices - 1) / slices + kWTile - 1) / kWTile * kWTile;
  const int nz = (int)((rows + per - 1) / per);
  const int ntn = (c + kWTile - 1) / kWTile, ntq = (mq + kWTile - 1) / kWTile;
  const int mmax = (mq > c ? ntq : ntn) * kWTile, nmax = ntn * kWTile;
  cudaError_t err;
  if ((err = amma::allow_smem<attn_bwd_mma_kernel>(b1)) != cudaSuccess ||
      (err = amma::allow_smem<dt2_mma_kernel>(b2)) != cudaSuccess ||
      (err = amma::allow_smem<dw_mma_kernel>(bw)) != cudaSuccess ||
      (err = set_smem(ln_bwd_kernel<bf16>, k2_bytes)) != cudaSuccess)
    return err;
  bf16* tok = static_cast<bf16*>(tokens);  // [3][rows][c]: da2, o, dt2
  bf16* da2 = tok;
  bf16* o3 = tok + rows * c;
  bf16* dt2 = tok + 2 * rows * c;
  bf16* dx_ = static_cast<bf16*>(dqkv);
  attn_bwd_mma_kernel<<<dim3((unsigned)(nwin * (heads / group)), p), kThreads, b1, st>>>(
      static_cast<const bf16*>(t2), static_cast<const bf16*>(dy), s,
      static_cast<const uint2*>(wf), bqkv, static_cast<const uint2*>(wdo), da2, o3, dx_,
      bias_part, h, w, c, heads, group);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int ntiles = amma::pad16(c) / 8;
  dt2_mma_kernel<<<dim3((unsigned)((rows + kRows - 1) / kRows), (ntiles + cols - 1) / cols),
                   kThreads, b2, st>>>(dx_, static_cast<const uint2*>(wdt), dt2, (int)rows, c,
                                       kdim, cols);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ln_bwd_kernel<bf16><<<dim3(h, p), kThreads, k2_bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), dt2, ln_g,
      static_cast<bf16*>(dx), ln_part, h, w, c, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dw_mma_kernel<<<dim3(ntq * ntn + ntn * ntn, nz), kThreads, bw, st>>>(
      dx_, static_cast<const bf16*>(t2), da2, o3, w_part, (int)rows, c, mq, (int)per, mmax,
      nmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int w_blocks = (int)((kWProducts * (long)c * c + kThreads - 1) / kThreads);
  bwd_sum_kernel<<<w_blocks + (6 * c + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      w_part, bias_part, ln_part, d_vec, dw, c, heads, nz, mmax, nmax, p * nwin, p * h, q_scale,
      w_blocks);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: [p, h, w, c] contiguous, type T (dtype 0 = float32, 1 =
// bfloat16); s [p] f32; t2 [p, nwin, 49, c] of type T from the forward; ln_g
// [c] f32; bqkv [heads][3][d] f32 (q pre-scaled). Outputs (float32): d_vec
// [6c] = (dbq, dbk, dbv, dbo, dln_g, dln_b), dw [4, c, c] = (dWq, dWk, dWv,
// dWo) in the torch Linear layout; q_scale = d^-1/2 (the fold of the packed q
// weights). f32 (the CUDA-core template): wqkv [c][heads][3][d] and wot =
// Wo^T [c][c] in T as the forward's; scratch tokens [6, p * nwin * 49, c],
// bias_part [p * nwin, 4c], ln_part [p * h, 2c], w_part [16, c, c];
// group = cols = slices = 0; wf, wdo, wdt, dqkv unused. bf16 (the tensor-core
// body): wf the forward's q/k/v fragments, wdo and wdt the backward's
// (ops/cuda/hrformer_block_train.py::attn_bwd_fragments); scratch tokens [3,
// p * nwin * 49, c], dqkv [p * nwin * 49, 3 * heads * pad16(d)] (16-byte
// aligned), bias_part and ln_part as f32, w_part [slices, 4, mmax, nmax]
// (mmax, nmax: max(heads pad16(d), c) and c rounded up to 64); group, cols,
// slices the plan (ops/cuda/hrformer_block_train.py::attn_bwd_plan); wqkv
// and wot unused. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for shapes or plans it does not take).
extern "C" int i2r_window_attn_train_bwd(const void* x, const void* dy, const void* s,
                                         const void* t2, const void* ln_g, const void* wqkv,
                                         const void* bqkv, const void* wot, const void* wf,
                                         const void* wdo, const void* wdt, void* dx,
                                         void* tokens, void* dqkv, void* bias_part,
                                         void* ln_part, void* w_part, void* d_vec, void* dw,
                                         int p, int h, int w, int c, int heads, int group,
                                         int cols, int slices, float eps, float q_scale,
                                         int dtype, void* stream) {
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
  if (dtype == 0) {
    if (group != 0 || cols != 0 || slices != 0) return (int)cudaErrorInvalidValue;
    return (int)launch_bwd<float>(x, dy, sf, t2, g, wqkv, bq, wot, dx, tokens, bp, lp, wp, dv,
                                  dwp, p, h, w, c, heads, eps, q_scale, st);
  }
  if (dtype == 1)
    return (int)launch_bwd_bf16(x, dy, sf, t2, g, bq, wf, wdo, wdt, dx, tokens, dqkv, bp, lp, wp,
                                dv, dwp, p, h, w, c, heads, group, cols, slices, eps, q_scale, st);
  return (int)cudaErrorInvalidValue;
}
