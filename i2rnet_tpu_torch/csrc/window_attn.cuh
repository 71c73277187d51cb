// The body of Kernel E (HRFormer LN1 + window MHSA + residual) for one
// (7x7 window, person) item, shared by Kernel E and kernel 9's forward
// (window_attn_block.cu) and phase 1 of kernel 7 (full_block.cu), as JAX's
// _attn_math serves both of its kernels: a change to the arithmetic reaches
// all three. window_attn_block.cu describes what it computes and its design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWin = 7;
constexpr int kTok = kWin * kWin;
constexpr int kKC = 32;  // input channels per chunk of the q/k/v products

// shared memory of one item: 4-byte section (statistics, token coordinates,
// q/k/v, logits), then the T tiles
template <typename T>
size_t attn_smem_bytes(int c, int d) {
  return sizeof(float) * (size_t)(4 * kTok + 3 * kTok * d + kTok * kTok) +
         sizeof(T) * (size_t)(kTok * kKC + kKC * 3 * d + kTok * c);
}

// Window `win` (row-major over the ceil(h/7) x ceil(w/7) windows, nwin of
// them) of person `person`: reads x, writes the window's real pixels of out.
// With kTrain, also s [p] (droppath scale) and t2 [p, nwin, 49, c]. All
// threads of the block call it; it starts by writing shared memory, so a
// block running several items syncs between them.
template <typename T, bool kTrain>
__device__ __forceinline__ void window_attn_item(
    const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, const T* __restrict__ wqkv, const float* __restrict__ bqkv,
    const T* __restrict__ wot, const float* __restrict__ bo, T* __restrict__ out,
    T* __restrict__ t2, int h, int w, int c, int heads, float eps, int win, int person, int nwin,
    unsigned char* smem_raw) {
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
  const int wy = win / nw, wx = win % nw;
  const size_t map = (size_t)h * w * c;
  const T* xp = x + (size_t)person * map;
  T* op = out + (size_t)person * map;
  // the window's tokens in t2 (kTrain)
  T* t2p = kTrain ? t2 + ((size_t)person * nwin + win) * kTok * c : nullptr;
  const float sc = kTrain ? s[person] : 1.f;
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

}  // namespace
