// The bodies of Kernel E (HRFormer LN1 + window MHSA + residual), shared by
// Kernel E and kernel 9's forward (window_attn_block.cu) and the attention
// phases of kernel 7 (full_block.cu), as JAX's _attn_math serves both of its
// kernels: a change to the arithmetic reaches all three. Two bodies:
// window_attn_item, the CUDA-core template of every f32 instance (one (7x7
// window, person) item), and the bf16 body on the tensor cores in two
// passes, attn_item_mma (one (window, head group, person) item: LN1, q/k/v,
// softmax(q.k^T).v into the scratch map o) and attn_out_mma (one (64-token
// row block, column block) item: o.Wo + bo, the residual). window_attn_block.cu
// describes what they compute and their design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_mma.cuh"
#include "common.cuh"

namespace {

constexpr int kWin = 7;
constexpr int kTok = kWin * kWin;
constexpr int kKC = 32;  // input channels per chunk of the q/k/v products
// the bf16 body (ops/cuda/hrformer_block.py's plan takes kRows, kMaxDp and
// kMaxCols; tests/test_torch_attn_tiles.py reads them here)
constexpr int kRows = 64;     // rows of a window tile: the 49 tokens, then zeros
constexpr int kMaxDp = 64;    // the head dim zero-padded to a multiple of 16, at most
constexpr int kMaxCols = 16;  // 8-column n-tiles of the out-projection a block, at most
constexpr size_t kThreePerSm = 75 * 1024;  // shared memory that still fits three blocks per SM
constexpr int kProjTiles = 3 * kMaxDp / 8 / kWarps;  // q/k/v n-tiles a warp, at most
constexpr int kPvTiles = kMaxDp / 16;                // P.V n-tiles a warp, at most
static_assert(kRows == 4 * 16 && kWarps == 8, "the bf16 body: 4 row tiles, 2 warps each");

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

// Shared memory of the bf16 body's first pass for width c and head dim d:
// the window tile [kRows][pad16(c) + 8], q, k, v [kRows][pad16(d) + 8] each
// (bf16), the tokens' map rows and columns; where the block holds all heads
// (`fused`), the window's o [kRows][pad16(c) + 8] too
// (ops/cuda/hrformer_block.py::AttnPlan.smem1 is the same sum).
inline size_t attn_mma_smem_bytes(int c, int d, bool fused) {
  return sizeof(__nv_bfloat16) * kRows *
             ((fused ? 2 : 1) * (amma::pad16(c) + 8) + 3 * (amma::pad16(d) + 8)) +
         sizeof(int) * 2 * kRows;
}

// ... and of its second pass: a block of o [kRows][pad16(c) + 8] (AttnPlan.smem2)
inline size_t attn_out_smem_bytes(int c) {
  return sizeof(__nv_bfloat16) * kRows * (amma::pad16(c) + 8);
}

// Whether the bf16 body takes this plan: the padded head dim, heads split
// into groups of `group`, `cols` n-tiles a block of the second pass, shared
// memory.
inline bool attn_mma_fits(int c, int heads, int group, int cols) {
  return amma::pad16(c / heads) <= kMaxDp && group >= 1 && heads % group == 0 && cols >= 1 &&
         cols <= kMaxCols && attn_mma_smem_bytes(c, c / heads, group == heads) <= kMaxSmem &&
         attn_out_smem_bytes(c) <= kMaxSmem;
}

// The out-projection of one tile of 64 rows of o (`as` [kRows][ld] bf16 in
// shared memory, pad16(c) columns, zero past c) for the output n-tiles [n0,
// n0 + nc), nc <= kMaxCols: out = x + T(o . Wo + bo), or with kTrain x + T(s
// (o . Wo + bo)) with the product in f32, at the rows that tok(row) maps to
// a token of the [p h w, c] maps (person = token / hw); rows it maps to -1
// are not written. wof: Wo [c out][c in] as mma B-operand fragments (n-tile
// j, k-step kk, lane l at wof[(j * pad16(c)/16 + kk) * 32 + l]). Warp w takes
// the n-tiles n0 + w, n0 + w + kWarps over all four row tiles, so the block
// reads each fragment once, two k-steps ahead; the epilogue's loads (x, bo,
// s) are all in flight before its stores. out carries no __restrict__
// (kernel 7's xa, read later in the launch).
template <bool kTrain, typename Tok>
__device__ __forceinline__ void out_tile(const __nv_bfloat16* as, int ld,
                                         const __nv_bfloat16* __restrict__ x,
                                         const float* __restrict__ s,
                                         const uint2* __restrict__ wof,
                                         const float* __restrict__ bo, __nv_bfloat16* out, int c,
                                         int hw, int n0, int nc, Tok tok) {
  using bf16 = __nv_bfloat16;
  constexpr int kJ = kMaxCols / kWarps;
  const int ks = amma::pad16(c) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  float acc[kJ][4][4];
  uint2 b0[kJ], b1[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int n = warp + kWarps * j;
    const uint2* wp = wof + (size_t)(n0 + n) * ks * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) acc[j][mt][0] = acc[j][mt][1] = acc[j][mt][2] =
        acc[j][mt][3] = 0.f;
    b0[j] = n < nc ? __ldg(wp) : make_uint2(0u, 0u);
    b1[j] = n < nc && ks > 1 ? __ldg(wp + 32) : make_uint2(0u, 0u);
  }
  for (int kk = 0; kk < ks; ++kk) {
    uint2 bk[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int n = warp + kWarps * j;
      bk[j] = b0[j];
      b0[j] = b1[j];
      if (n < nc && kk + 2 < ks) b1[j] = __ldg(wof + ((size_t)(n0 + n) * ks + kk + 2) * 32 + lane);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t a[4];
      amma::ldsm_x4(a, as + amma::a_off(lane, mt * 16, kk * 16, ld));
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (warp + kWarps * j < nc) amma::mma(acc[j][mt], a, bk[j].x, bk[j].y);
    }
  }
  // the epilogue's operands: the eight rows' tokens and scales, bo and x
  long t[4][2];
  float sc[4][2], bv[kJ][2], xv[kJ][4][2][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      t[mt][hh] = tok(mt * 16 + g + 8 * hh);
      sc[mt][hh] = kTrain && t[mt][hh] >= 0 ? s[t[mt][hh] / hw] : 1.f;
    }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int n = warp + kWarps * j, col = (n0 + n) * 8 + c2;
    const bool in = n < nc && col < c;
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[j][e] = in && col + e < c ? bo[col + e] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        xv[j][mt][hh][0] = xv[j][mt][hh][1] = 0.f;
        if (!in || t[mt][hh] < 0) continue;
        const bf16* xp = x + (size_t)t[mt][hh] * c + col;
        if (c % 2 == 0) {  // col even: both columns inside, 4-byte aligned
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(xp);
          xv[j][mt][hh][0] = __low2float(v);
          xv[j][mt][hh][1] = __high2float(v);
        } else {
          xv[j][mt][hh][0] = to_f32(xp[0]);
          if (col + 1 < c) xv[j][mt][hh][1] = to_f32(xp[1]);
        }
      }
  }
  // + bo (and the droppath scale), rounding, the residual
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int n = warp + kWarps * j, col = (n0 + n) * 8 + c2;
    if (n >= nc || col >= c) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (t[mt][hh] < 0) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[j][mt][2 * hh + e] + bv[j][e];
          v[e] = xv[j][mt][hh][e] + round_to<bf16>(kTrain ? sc[mt][hh] * a : a);
        }
        bf16* op = out + (size_t)t[mt][hh] * c + col;
        if (c % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(op) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          op[0] = from_f32<bf16>(v[0]);
          if (col + 1 < c) op[1] = from_f32<bf16>(v[1]);
        }
      }
  }
}

// Pass 1 of E in bf16 for one item: window `win` (row-major over the
// ceil(h/7) x ceil(w/7) windows, nwin of them), heads [hg * group, (hg + 1) *
// group), person `person`. wf: the q/k/v weights as mma B-operand fragments
// (ops/cuda/hrformer_block.py::pack_attn): for head hd, n-tile j of its
// [3 dp] columns (q, k, v of dp = pad16(d) each, q pre-scaled, zero past d)
// and k-step kk of the pad16(c) input channels, lane l holds
// W[8j + l/4][16kk + 2(l%4) + {0, 1, 8, 9}] at wf[((hd * 3dp/8 + j) *
// pad16(c)/16 + kk) * 32 + l]. bqkv [heads][3][d] f32. Writes the group's
// columns of o [p, h, w, c] (rounded) at the window's real tokens, or, where
// the group is all heads (`fused`), keeps the window's o in shared memory
// and runs the out-projection (out_tile over all output columns; s, wof, bo
// as attn_out_mma takes them) into out at the real tokens itself. With
// kTrain, head group 0 also writes the window tokens t2 [p, nwin, 49, c]. o
// and out carry no __restrict__ (kernel 7 reads them later in the same
// launch). All threads of the block call it; it starts by writing shared
// memory.
template <bool kTrain>
__device__ __forceinline__ void attn_item_mma(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, const uint2* __restrict__ wf, const float* __restrict__ bqkv,
    const float* __restrict__ s, const uint2* __restrict__ wof, const float* __restrict__ bo,
    __nv_bfloat16* o, __nv_bfloat16* out, __nv_bfloat16* __restrict__ t2, int h, int w, int c,
    int heads, int group, float eps, int win, int hg, int person, int nwin,
    unsigned char* smem_raw) {
  using bf16 = __nv_bfloat16;
  const int d = c / heads, dp = amma::pad16(d), cp = amma::pad16(c);
  const int ldy = cp + 8, ldq = dp + 8, ks1 = cp / 16, nt3 = 3 * dp / 8;
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);  // [kRows][ldy]: T(LN1(x)) of the window
  bf16* qs = ys + kRows * ldy;                   // [kRows][ldq] each: q, k, v of one head
  bf16* kst = qs + kRows * ldq;
  bf16* vs = kst + kRows * ldq;
  int* s_row = reinterpret_cast<int*>(vs + kRows * ldq);  // [kRows]: map row, or -1
  int* s_col = s_row + kRows;
  const bool fused = group == heads;
  bf16* os = reinterpret_cast<bf16*>(s_col + kRows);  // fused: [kRows][ldy], the window's o

  const int pad_h = (kWin - h % kWin) % kWin, pad_w = (kWin - w % kWin) % kWin;
  const int nw = (w + pad_w) / kWin;
  const int wy = win / nw, wx = win % nw;
  const size_t map = (size_t)h * w * c;
  const bf16* xp = x + (size_t)person * map;
  bf16* op = o + (size_t)person * map;
  bf16* t2p = kTrain && hg == 0 ? t2 + ((size_t)person * nwin + win) * kTok * c : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const bf16 zero = from_f32<bf16>(0.f);
  const float fc = (float)c;

  // fused: o's columns past c are 0 (the out-projection's k padding)
  if (fused)
    for (int e = tid; e < kRows * (cp - c); e += kThreads)
      os[e / (cp - c) * ldy + c + e % (cp - c)] = zero;
  // the window's tokens: map row (-1 off the map and past the 49) and column
  for (int t = tid; t < kRows; t += kThreads) {
    const int r = wy * kWin + t / kWin - pad_h / 2, q = wx * kWin + t % kWin - pad_w / 2;
    s_row[t] = t < kTok && r >= 0 && r < h && q >= 0 && q < w ? r : -1;
    s_col[t] = q;
  }
  __syncthreads();
  // their rows of x into ys by cp.async, every thread's copies in flight at
  // once (16 or 4 bytes as C allows, zero-filled); other rows and channels
  // past c 0
  if (c % 2 == 0) {
    const int vec = c % 8 == 0 && (reinterpret_cast<uintptr_t>(xp) & 15) == 0 ? 8 : 2;
    const int per = cp / vec;
    for (int e = tid; e < kRows * per; e += kThreads) {
      const int t = e / per, i = vec * (e % per), r = s_row[t];
      const bool in = r >= 0 && i < c;
      const bf16* src = in ? xp + ((size_t)r * w + s_col[t]) * c + i : xp;
      if (vec == 8)
        amma::cp_async16(ys + t * ldy + i, src, in);
      else
        amma::cp_async4(ys + t * ldy + i, src, in);
    }
    amma::cp_commit();
    amma::cp_wait<0>();
  } else {
    for (int e = tid; e < kRows * cp; e += kThreads) {
      const int t = e / cp, i = e % cp, r = s_row[t];
      ys[t * ldy + i] = r >= 0 && i < c ? xp[((size_t)r * w + s_col[t]) * c + i] : zero;
    }
  }
  __syncthreads();
  // LN1 in place, a warp per token (two-pass statistics, as _ln); pad tokens
  // stay 0 (and so do their t2 rows)
  for (int t = warp; t < kTok; t += kWarps) {
    bf16* yr = ys + t * ldy;
    if (s_row[t] < 0) {
      if (kTrain && t2p != nullptr)
        for (int i = lane; i < c; i += 32) t2p[(size_t)t * c + i] = zero;
      continue;
    }
    float sum = 0.f;
    for (int i = lane; i < c; i += 32) sum += to_f32(yr[i]);
    const float mean = warp_sum(sum) / fc;
    float sq = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float dl = to_f32(yr[i]) - mean;
      sq += dl * dl;
    }
    const float rstd = rsqrtf(warp_sum(sq) / fc + eps);
    for (int i = lane; i < c; i += 32) {
      const bf16 v = from_f32<bf16>((to_f32(yr[i]) - mean) * rstd * ln_g[i] + ln_b[i]);
      yr[i] = v;
      if (kTrain && t2p != nullptr) t2p[(size_t)t * c + i] = v;
    }
  }

  const int rt = warp & 3, half = warp >> 2;  // the attention's row tile and P.V share
  for (int hi = 0; hi < group; ++hi) {
    const int hd = hg * group + hi;
    const uint2* wh = wf + (size_t)hd * nt3 * ks1 * 32 + lane;
    __syncthreads();  // ys written / the previous head's attention done with q, k, v
    {
      // q, k, v of the head on mma.sync: n-tile j (8 of the 3 dp columns) to
      // warp j % kWarps, over all four row tiles; B two k-steps ahead
      float acc[kProjTiles][4][4];
      uint2 b0[kProjTiles], b1[kProjTiles];
#pragma unroll
      for (int j = 0; j < kProjTiles; ++j) {
        const int nt = warp + kWarps * j;
        const bool in = nt < nt3;
        b0[j] = in ? __ldg(wh + (size_t)nt * ks1 * 32) : make_uint2(0u, 0u);
        b1[j] = in && ks1 > 1 ? __ldg(wh + ((size_t)nt * ks1 + 1) * 32) : make_uint2(0u, 0u);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) acc[j][mt][0] = acc[j][mt][1] = acc[j][mt][2] =
            acc[j][mt][3] = 0.f;
      }
      for (int kk = 0; kk < ks1; ++kk) {
        uint2 bk[kProjTiles];
#pragma unroll
        for (int j = 0; j < kProjTiles; ++j) {
          const int nt = warp + kWarps * j;
          bk[j] = b0[j];
          b0[j] = b1[j];
          if (nt < nt3 && kk + 2 < ks1) b1[j] = __ldg(wh + ((size_t)nt * ks1 + kk + 2) * 32);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[4];
          amma::ldsm_x4(a, ys + amma::a_off(lane, mt * 16, kk * 16, ldy));
#pragma unroll
          for (int j = 0; j < kProjTiles; ++j)
            if (warp + kWarps * j < nt3) amma::mma(acc[j][mt], a, bk[j].x, bk[j].y);
        }
      }
      // + bias, rounding, into q, k, v; columns past d have zero weights and bias
#pragma unroll
      for (int j = 0; j < kProjTiles; ++j) {
        const int nt = warp + kWarps * j;
        if (nt >= nt3) continue;
        const int col = nt * 8 + c2, m = col / dp, jj = col % dp;
        const float* bp = bqkv + (size_t)(hd * 3 + m) * d;
        const float b0 = jj < d ? bp[jj] : 0.f, b1 = jj + 1 < d ? bp[jj + 1] : 0.f;
        bf16* dst = (m == 0 ? qs : m == 1 ? kst : vs) + jj;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<uint32_t*>(dst + (mt * 16 + g + 8 * hh) * ldq) =
                amma::pack(acc[j][mt][2 * hh] + b0, acc[j][mt][2 * hh + 1] + b1);
      }
    }
    __syncthreads();
    // the head's attention: warp (rt, half) takes query rows 16 rt.. against
    // all 64 tile rows, of which the 49 tokens are keys (pad tokens too:
    // their k, v are the biases); then its half of P.V's n-tiles
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxDp / 16; ++kk) {
      if (kk * 16 < dp) {
        uint32_t qa[4];
        amma::ldsm_x4(qa, qs + amma::a_off(lane, rt * 16, kk * 16, ldq));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kb[4];
          amma::ldsm_x4(kb, kst + amma::b_off(lane, np * 16, kk * 16, ldq));
          amma::mma(sc[2 * np], qa, kb[0], kb[1]);
          amma::mma(sc[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
    }
    // softmax in f32 over the 49 keys (tile rows 49-63 are no keys: -inf)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kc = 8 * j + c2;
      if (kc >= kTok) sc[j][0] = sc[j][2] = -INFINITY;
      if (kc + 1 >= kTok) sc[j][1] = sc[j][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    mx0 = amma::quad_max(mx0);
    mx1 = amma::quad_max(mx1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][0] = expf(sc[j][0] - mx0);
      sc[j][1] = expf(sc[j][1] - mx0);
      sc[j][2] = expf(sc[j][2] - mx1);
      sc[j][3] = expf(sc[j][3] - mx1);
      l0 += sc[j][0] + sc[j][1];
      l1 += sc[j][2] + sc[j][3];
    }
    l0 = amma::quad_sum(l0);
    l1 = amma::quad_sum(l1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][0] /= l0;
      sc[j][1] /= l0;
      sc[j][2] /= l1;
      sc[j][3] /= l1;
    }
    // o = T(P) . v, P rounded from registers (acc_to_a); n-tiles half, half + 2, ...
    const int nd = dp / 8;
    float ov[kPvTiles][4];
#pragma unroll
    for (int jn = 0; jn < kPvTiles; ++jn) ov[jn][0] = ov[jn][1] = ov[jn][2] = ov[jn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      amma::acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
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
    // the head's columns of o, rounded: at the real tokens of the map, or
    // (fused) every row of the window's o
#pragma unroll
    for (int jn = 0; jn < kPvTiles; ++jn) {
      const int n = half + 2 * jn;
      if (n >= nd) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = rt * 16 + g + 8 * hh;
        bf16* dst;
        if (fused)
          dst = os + t * ldy + hd * d;
        else if (t < kTok && s_row[t] >= 0)
          dst = op + ((size_t)s_row[t] * w + s_col[t]) * c + hd * d;
        else
          continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = n * 8 + c2 + e;
          if (jj < d) dst[jj] = from_f32<bf16>(ov[jn][2 * hh + e]);
        }
      }
    }
  }
  if (!fused) return;
  __syncthreads();  // every head's columns of the window's o written
  const long base = (long)person * h * w;
  for (int n0 = 0; n0 < cp / 8; n0 += kMaxCols)
    out_tile<kTrain>(os, ldy, x, s, wof, bo, out, c, h * w, n0, min(kMaxCols, cp / 8 - n0),
                     [&](int t) {
                       return t < kTok && s_row[t] >= 0 ? base + (long)s_row[t] * w + s_col[t]
                                                        : -1L;
                     });
}

// Pass 2 of E in bf16 for one item: rows [kRows rb, kRows (rb + 1)) of the
// rows = p h w tokens of o and x (hw = h w tokens a person), output n-tiles
// [cols cb, cols (cb + 1)) of the pad16(c) / 8. wof: Wo [c out][c in] as mma
// B-operand fragments (n-tile j, k-step kk, lane l at wof[(j * pad16(c)/16 +
// kk) * 32 + l]). out = x + T(o . Wo + bo), or with kTrain x + T(s (o . Wo +
// bo)), the product in f32 (out_tile). o carries no __restrict__ (kernel 7
// wrote it earlier in the launch). All threads of the block call it; it
// starts by writing shared memory.
template <bool kTrain>
__device__ __forceinline__ void attn_out_mma(const __nv_bfloat16* o,
                                             const __nv_bfloat16* __restrict__ x,
                                             const float* __restrict__ s,
                                             const uint2* __restrict__ wof,
                                             const float* __restrict__ bo, __nv_bfloat16* out,
                                             int rows, int hw, int c, int cols, int rb, int cb,
                                             unsigned char* smem_raw) {
  using bf16 = __nv_bfloat16;
  const int cp = amma::pad16(c), ld = cp + 8;
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [kRows][ld]: the rows of o
  const int tid = threadIdx.x, r0 = rb * kRows;
  // the block's rows of o; rows past `rows` and columns past c are 0. 16-byte
  // copies by cp.async.cg (through L2, which kernel 7's writes of o reached)
  // where C allows, all in flight at once; else 4-byte or 2-byte loads
  if (c % 8 == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    const int per = cp / 8;
    for (int e = tid; e < kRows * per; e += kThreads) {
      const int j = e / per, i = 8 * (e % per);
      const bool in = r0 + j < rows && i < c;
      amma::cp_async16(as + j * ld + i, in ? o + (size_t)(r0 + j) * c + i : o, in);
    }
    amma::cp_commit();
    amma::cp_wait<0>();
  } else if (c % 2 == 0) {
    const int half = cp / 2;
#pragma unroll 4
    for (int e = tid; e < kRows * half; e += kThreads) {
      const int j = e / half, i = 2 * (e % half);
      *reinterpret_cast<uint32_t*>(as + j * ld + i) =
          r0 + j < rows && i < c
              ? *reinterpret_cast<const uint32_t*>(o + (size_t)(r0 + j) * c + i)
              : 0u;
    }
  } else {
    for (int e = tid; e < kRows * cp; e += kThreads) {
      const int j = e / cp, i = e % cp;
      as[j * ld + i] = r0 + j < rows && i < c ? o[(size_t)(r0 + j) * c + i] : from_f32<bf16>(0.f);
    }
  }
  __syncthreads();
  const int n0 = cb * cols;
  out_tile<kTrain>(as, ld, x, s, wof, bo, out, c, hw, n0, min(cols, cp / 8 - n0),
                   [&](int j) { return r0 + j < rows ? (long)(r0 + j) : -1L; });
}

}  // namespace
