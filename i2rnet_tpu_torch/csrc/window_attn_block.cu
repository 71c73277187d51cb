// HRFormer window-attention half block, forward, for Hopper (sm_90a).
//
// Replaces: i2rnet_tpu/ops/pallas/hrformer_block.py::window_attn_block_fused
// (eval, Kernel E) and the forward of
// i2rnet_tpu/ops/pallas/hrformer_block_train.py::window_attn_block_train
// (training, kernel 9: the template's kTrain flag).
//
// Computes x + WindowMHSA(LN1(x)) on a [P, H, W, C] map, rounding where
// _attn_math (hrformer_block.py:109-155) rounds, with T the activation type:
//     y    = T(LN1(x))                    f32 statistics over C, eps
//     windows of 7x7 tokens after zero center padding of H and W to
//     multiples of 7 (pad tokens are 0 after LN, attended through the biases)
//     q    = T(y . Wq' + bq')             Wq' = T(s Wq), bq' = s bq, s = d^-1/2
//     k, v = T(y . W + b)                 f32 accumulation
//     o    = T(T(softmax(q . k^T)) . v)   per head; f32 logits and softmax
//     out  = x + T(o . Wo + bo)           residual in T, real tokens only
// The relative-position bias is not added (the reference quirk).
// With kTrain (kernel 9, _fwd_kernel :104-156) the block also takes the
// per-sample droppath scale s [P] and writes the window tokens t2 = T(y)
// [P, nwin, 49, C] (0 at pad tokens) for the backward, and the last line is
//     out  = x + T(s (o . Wo + bo))        the product in f32
//
// What bounds it on the H100: per person at branch 0 of a 256x192 input
// (64x48x78, padded to 70x49 = 3430 window tokens, 2 heads of d = 39) the
// products are 2*3430*78*234 (q, k, v) + 70*2*2*2*49*49*39 (attention) +
// 2*3072*78*78 (out) = 0.22 GFLOP against 2*3072*78*2 B = 0.96 MB of bf16
// map I/O: about 0.22 us at the bf16 tensor-core peak and 0.29 us at the
// memory rate, so the map's bytes bound it. This kernel runs its products on
// CUDA cores in f32, so what bounds it in practice is the FMA rate and the
// shared-memory reads that feed it.
//
// Design: one block of 256 threads per (window, person). LN statistics of the
// 49 tokens first (a warp per token). Then per head: q, k, v of the window
// accumulate over the C input channels in chunks of 32 (the LN'd token tile
// and the head's weight tile staged in shared memory, the partial sums kept
// in shared f32), logits, softmax and P.V in shared memory; the head's output
// lands in a [49, C] tile in T. Last, the out-projection reads that tile and
// Wo^T through L1/L2, adds bias and residual, and writes the real tokens.
// Every product item is (one output column, one window row of 7 tokens), so
// each weight value read serves seven tokens. The head dim is a runtime value
// (39 on HRFormer-B, no padding), C any width whose tiles fit shared memory
// (176 KB at C = 624 in f32). A later tensor-core version pads d to 48.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWin = 7;
constexpr int kTok = kWin * kWin;
constexpr int kKC = 32;  // input channels per chunk of the q/k/v products
constexpr size_t kMaxSmem = 232448;

// shared memory: 4-byte section (statistics, token coordinates, q/k/v,
// logits), then the T tiles
template <typename T>
size_t smem_bytes(int c, int d) {
  return sizeof(float) * (size_t)(4 * kTok + 3 * kTok * d + kTok * kTok) +
         sizeof(T) * (size_t)(kTok * kKC + kKC * 3 * d + kTok * c);
}

template <typename T, bool kTrain>
__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const T* __restrict__ x, const float* __restrict__ s,
                   const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                   const T* __restrict__ wqkv, const float* __restrict__ bqkv,
                   const T* __restrict__ wot, const float* __restrict__ bo, T* __restrict__ out,
                   T* __restrict__ t2, int h, int w, int c, int heads, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = c / heads, n3 = 3 * d;
  float* s_mean = reinterpret_cast<float*>(smem_raw);
  float* s_rstd = s_mean + kTok;
  int* s_row = reinterpret_cast<int*>(s_rstd + kTok);  // [49]: map row, or -1 for padding
  int* s_col = s_row + kTok;
  float* qkv = reinterpret_cast<float*>(s_col + kTok);  // [3][49][d]
  float* logits = qkv + 3 * kTok * d;  // [49][49]
  T* yt = reinterpret_cast<T*>(logits + kTok * kTok);  // [49][kKC]
  T* wt = yt + kTok * kKC;                              // [kKC][3d]
  T* ot = wt + kKC * n3;                                // [49][c]

  const int pad_h = (kWin - h % kWin) % kWin, pad_w = (kWin - w % kWin) % kWin;
  const int nw = (w + pad_w) / kWin;
  const int wy = blockIdx.x / nw, wx = blockIdx.x % nw;
  const size_t map = (size_t)h * w * c;
  const T* xp = x + (size_t)blockIdx.y * map;
  T* op = out + (size_t)blockIdx.y * map;
  // the window's tokens in t2 (kTrain)
  T* t2p = kTrain ? t2 + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kTok * c : nullptr;
  const float sc = kTrain ? s[blockIdx.y] : 1.f;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float fc = (float)c;

  // LayerNorm statistics of the window's tokens (two-pass, as _ln)
  for (int t = warp; t < kTok; t += kWarps) {
    const int r = wy * kWin + t / kWin - pad_h / 2, q = wx * kWin + t % kWin - pad_w / 2;
    const bool real = r >= 0 && r < h && q >= 0 && q < w;
    float mean = 0.f, rstd = 0.f;
    if (real) {
      const T* xr = xp + ((size_t)r * w + q) * c;
      float sum = 0.f;
      for (int i = lane; i < c; i += 32) sum += to_f32(xr[i]);
      mean = warp_sum(sum) / fc;
      float sq = 0.f;
      for (int i = lane; i < c; i += 32) {
        const float dl = to_f32(xr[i]) - mean;
        sq += dl * dl;
      }
      rstd = rsqrtf(warp_sum(sq) / fc + eps);
    }
    if (lane == 0) {
      s_mean[t] = mean;
      s_rstd[t] = rstd;
      s_row[t] = real ? r : -1;
      s_col[t] = q;
    }
  }

  for (int hd = 0; hd < heads; ++hd) {
    __syncthreads();  // statistics written; the previous head's P.V has read qkv
    for (int i = tid; i < 3 * kTok * d; i += kThreads) qkv[i] = 0.f;
    for (int c0 = 0; c0 < c; c0 += kKC) {
      const int kc = min(kKC, c - c0);
      __syncthreads();  // qkv zeroed / the previous chunk's tiles consumed
      for (int i = tid; i < kTok * kKC; i += kThreads) {
        const int t = i / kKC, k = i % kKC;
        float v = 0.f;
        if (k < kc && s_row[t] >= 0) {
          const int ch = c0 + k;
          const float xv = to_f32(xp[((size_t)s_row[t] * w + s_col[t]) * c + ch]);
          v = (xv - s_mean[t]) * s_rstd[t] * ln_g[ch] + ln_b[ch];
        }
        yt[i] = from_f32<T>(v);
        if (kTrain && hd == 0 && k < kc) t2p[(size_t)t * c + c0 + k] = yt[i];
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
          for (int i = 0; i < kWin; ++i) acc[i] += to_f32(yt[(row * kWin + i) * kKC + k]) * wv;
        }
        const int m = col / d, j = col % d;
#pragma unroll
        for (int i = 0; i < kWin; ++i) qkv[(m * kTok + row * kWin + i) * d + j] += acc[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < 3 * kTok * d; i += kThreads) {
      const int m = i / (kTok * d), j = i % d;
      qkv[i] = round_to<T>(qkv[i] + bqkv[(hd * 3 + m) * d + j]);
    }
    __syncthreads();

    const float* qs = qkv;
    const float* ks = qkv + kTok * d;
    const float* vs = ks + kTok * d;
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
      for (int i = 0; i < kWin; ++i) logits[(row * kWin + i) * kTok + key] = acc[i];
    }
    __syncthreads();
    for (int t = warp; t < kTok; t += kWarps) {
      float* sr = logits + t * kTok;
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
      for (int k = lane; k < kTok; k += 32) sr[k] = round_to<T>(sr[k] / sum);
    }
    __syncthreads();
    for (int it = tid; it < d * kWin; it += kThreads) {
      const int j = it % d, row = it / d;
      float acc[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) acc[i] = 0.f;
      for (int key = 0; key < kTok; ++key) {
        const float vv = vs[key * d + j];
#pragma unroll
        for (int i = 0; i < kWin; ++i) acc[i] += logits[(row * kWin + i) * kTok + key] * vv;
      }
#pragma unroll
      for (int i = 0; i < kWin; ++i) ot[(row * kWin + i) * c + hd * d + j] = from_f32<T>(acc[i]);
    }
  }
  __syncthreads();

  // out-projection, bias, residual; rows of the window without a real token are skipped
  for (int it = tid; it < c * kWin; it += kThreads) {
    const int col = it % c, row = it / c;
    bool any = false;
#pragma unroll
    for (int i = 0; i < kWin; ++i) any |= s_row[row * kWin + i] >= 0;
    if (!any) continue;
    float acc[kWin];
#pragma unroll
    for (int i = 0; i < kWin; ++i) acc[i] = 0.f;
    for (int k = 0; k < c; ++k) {
      const float wv = to_f32(wot[(size_t)k * c + col]);
#pragma unroll
      for (int i = 0; i < kWin; ++i) acc[i] += to_f32(ot[(row * kWin + i) * c + k]) * wv;
    }
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
      const int t = row * kWin + i;
      if (s_row[t] < 0) continue;
      const size_t off = ((size_t)s_row[t] * w + s_col[t]) * c + col;
      const float a = acc[i] + bo[col];
      op[off] = from_f32<T>(to_f32(xp[off]) + round_to<T>(kTrain ? sc * a : a));
    }
  }
}

template <typename T, bool kTrain>
cudaError_t launch(const void* x, const void* s, const void* ln_g, const void* ln_b,
                   const void* wqkv, const void* bqkv, const void* wot, const void* bo, void* out,
                   void* t2, int p, int h, int w, int c, int heads, float eps,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(c, c / heads);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attn_kernel<T, kTrain>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + kWin - 1) / kWin) * ((w + kWin - 1) / kWin), p);
  window_attn_kernel<T, kTrain><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const T*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const T*>(wot), static_cast<const float*>(bo),
      static_cast<T*>(out), static_cast<T*>(t2), h, w, c, heads, eps);
  return cudaGetLastError();
}

template <bool kTrain>
int dispatch(const void* x, const void* s, const void* ln_g, const void* ln_b, const void* wqkv,
             const void* bqkv, const void* wot, const void* bo, void* out, void* t2, int p,
             int h, int w, int c, int heads, float eps, int dtype, void* stream) {
  if (p < 1 || h < 1 || w < 1 || heads < 1 || c < heads || c % heads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, kTrain>(x, s, ln_g, ln_b, wqkv, bqkv, wot, bo, out, t2, p, h, w, c,
                                      heads, eps, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, kTrain>(x, s, ln_g, ln_b, wqkv, bqkv, wot, bo, out, t2, p,
                                              h, w, c, heads, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: [p, h, w, c] contiguous, type T (dtype 0 = float32, 1 = bfloat16).
// ln_g, ln_b: [c] f32. wqkv: [c][heads][3][d] in T (input channel first; q, k,
// v of a head side by side; q pre-scaled), bqkv: [heads][3][d] f32. wot: Wo^T
// [c][c] in T (input channel first), bo: [c] f32. Window 7. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for shapes it does not take).
extern "C" int i2r_window_attn_fwd(const void* x, const void* ln_g, const void* ln_b,
                                   const void* wqkv, const void* bqkv, const void* wot,
                                   const void* bo, void* out, int p, int h, int w, int c,
                                   int heads, float eps, int dtype, void* stream) {
  return dispatch<false>(x, nullptr, ln_g, ln_b, wqkv, bqkv, wot, bo, out, nullptr, p, h, w, c,
                         heads, eps, dtype, stream);
}

// Kernel 9's forward: as above, plus s [p] f32 (the per-sample droppath
// scale) and t2 [p, nwin, 49, c] of type T, the window tokens after LN1 (0
// at pad tokens), nwin = ceil(h / 7) * ceil(w / 7) in row-major window order.
extern "C" int i2r_window_attn_train_fwd(const void* x, const void* s, const void* ln_g,
                                         const void* ln_b, const void* wqkv, const void* bqkv,
                                         const void* wot, const void* bo, void* out, void* t2,
                                         int p, int h, int w, int c, int heads, float eps,
                                         int dtype, void* stream) {
  if (s == nullptr || t2 == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(x, s, ln_g, ln_b, wqkv, bqkv, wot, bo, out, t2, p, h, w, c, heads, eps,
                        dtype, stream);
}
