// The bf16 tensor-core body of the encoder FFN tail, shared by Kernel B
// (encoder_ffn.cu, eval) and Kernel D (encoder_ffn_train.cu, training
// forward and backward):
//     n   = LN1(x)                              (f32 statistics, eps)
//     a   = T(drop1(relu(T(n) . T(W1)^T + b1)))  (f32 accumulation)
//     out = T(LN2(n + drop2(a . T(W2)^T + b2)))  (residual on the f32 n)
// with T() rounding to bf16 at the casting points of the plain versions
// (ops/cuda/encoder_ffn.py::encoder_ffn_torch, ops/cuda/encoder_ffn_train.py::
// encoder_ffn_train_torch) and no dropout in Kernel B.
//
// Replaces: nothing by itself; the Pallas functions are
// i2rnet_tpu/ops/pallas/encoder_ffn.py::encoder_ffn_fused and
// i2rnet_tpu/ops/pallas/encoder_ffn_train.py::encoder_ffn_train.
//
// What bounds it on the H100: at the main-path shapes the products are
// 1.6 GFLOP (Kernel B, R = 21504, C = 96, F = 192: 1.6 us on the tensor
// cores) against 8.3 MB of bf16 activations (2.5 us of device memory), so
// memory bounds the function; in D the dropout bits add one Philox word per
// element of [R, F] and [R, C] (integer work the bound does not count, about
// half of D's forward), and every block copies both weight matrices (f32, 147
// KB at C = 96, F = 192) from L2 into shared memory.
//
// Design (the constants below; ops/cuda/encoder_ffn.py::ffn_plan mirrors them):
// * a block of kTileWarps warps; a warp takes 16 full rows at a time (a unit),
//   unit u going to block u % grid and there to its warps in turn, so that the
//   units spread over every SM (a grid of up to two blocks per SM, as many as
//   there are units); after the weights are loaded no barrier is needed until
//   the block's end. W1 [F][C] and W2 [C][F] (f32, torch layout) are rounded
//   to bf16 as they are copied into shared memory once per block, C
//   zero-padded to 16 (CP) and F to 64 (FP), rows 8 elements longer than that
//   so the 8 rows an ldmatrix reads fall on distinct bank groups; b1, b2 and
//   the LayerNorms' parameters in f32, zero past C and F;
// * LN1: the warp's 16 rows of x by cp.async into shared memory, f32
//   statistics over the C real columns (a row's values sit in the 4 lanes of
//   a quad: two shuffles), T(n) packed straight into the A fragments of the
//   first product (the f32 n is recomputed from x where the residual needs it);
// * the two products per 64-column chunk of F on mma.sync m16n8k16 (bf16 in,
//   f32 accumulation): h_c = T(n) . W1_c^T, then + b1, ReLU, drop1 and the
//   rounding in registers, and those accumulators reused as the A fragments
//   of y += T(a_c) . W2[:, c]^T (attn_mma.cuh's acc_to_a), so the [R, F]
//   hidden activation never leaves registers;
// * z = n + drop2(y + b2), LN2 over the C real columns, T(out) masked to C
//   and to the real rows;
// * the backward (encoder_ffn_train.cu) walks the units with the same
//   helpers, so it recomputes h, a and LN2's statistics bit for bit;
// * dropout bits: the explicit [R, F] and [R, C] words, or Philox word 0
//   keyed by (seed, offset + site - 1) and counted by (column, row), drawn
//   once per element in the forward and once in the backward.
// Widths: C up to 256 (kMaxCp), padded to 16 up to 128 and to the wide
// instances above (inst_cp). These serve the cat_vec inter encoder (C = 174
// -> 176 and 192, F = 192): there the bf16
// weights are 135-147 KB and a block takes 169-184 KB in the forward and
// 188-204 KB in the backward's pass 1, one block an SM, inside the 232448 B a
// block may have, so W2 is not streamed; fits_fwd/fits_bwd refuse a C and F
// whose block does not fit (C = 256 with F = 192 among them).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"
#include "common.cuh"
#include "philox.cuh"

namespace {

// The LayerNorms' parameters, the weights (torch Linear layout) and biases, all f32.
struct Params {
  const float *ln1_w, *ln1_b, *w1, *b1, *w2, *b2, *ln2_w, *ln2_b;
};

struct Dropout {
  const uint32_t* bits1;  // [rows, f] (mode 1)
  const uint32_t* bits2;  // [rows, c] (mode 1)
  uint32_t seed, offset, threshold;
  float inv;  // 1 / (1 - rate)
  int mode;   // 0 none, 1 bits, 2 seed
};

// Whether element (r, col) of dropout site `site` (1: [rows, f] after the
// ReLU, 2: [rows, c] after linear2, `width` columns) is kept.
__device__ __forceinline__ bool kept(const Dropout& dp, int site, long r, int col, int width) {
  const uint32_t u =
      dp.mode == 1 ? (site == 1 ? dp.bits1 : dp.bits2)[r * width + col]
                   : i2r::philox_word0(dp.seed, dp.offset + (uint32_t)(site - 1), (uint32_t)col,
                                       (uint32_t)r, 0u);
  return u >= dp.threshold;
}

namespace ffn {

using bf16 = __nv_bfloat16;

// the body's constants (ops/cuda/encoder_ffn.py's plan takes them;
// tests/test_torch_ffn_tiles.py reads them here)
constexpr int kUnit = 16;                  // rows a warp takes at a time (the mma's m)
constexpr int kTileWarps = 4;              // warps of a block of the forward and of pass 1
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kRows = kUnit * kTileWarps;  // rows of a block's x tile, a unit a warp
constexpr int kChunk = 64;                 // hidden columns a step of the two products
constexpr int kMaxCp = 256;                // C, at most
constexpr int kWTile = 64;                 // dW tile edge (m, n) and token rows a stage
constexpr size_t kTwoPerSm = 113 * 1024;   // shared memory that still fits two blocks per SM

__host__ __device__ constexpr int pad64(int n) { return (n + 63) / 64 * 64; }

// The padded width of the instance that takes C: C padded to 16 up to 128,
// then the wide instances 176, 192 and 256 (each C above 128 rounded up to
// the next; the cat_vec widths 174 and 192 take 176 and 192), so that the
// build compiles three wide bodies, not eight.
__host__ __device__ constexpr int inst_cp(int c) {
  return amma::pad16(c) <= 128 ? amma::pad16(c) : c <= 176 ? 176 : c <= 192 ? 192 : 256;
}

// Shared memory of the forward: W1 [FP][CP + 8], W2 [CP][FP + 8], the x tile
// [kRows][CP + 8] (bf16), b1 [FP], b2, LN1 and LN2 scale and bias [CP] (f32).
__host__ __device__ inline size_t fwd_smem(int cp, int fp) {
  return sizeof(bf16) * ((size_t)fp * (cp + 8) + (size_t)cp * (fp + 8) + (size_t)kRows * (cp + 8)) +
         sizeof(float) * (fp + 5 * (size_t)cp);
}
// ... of pass 1: the forward's, the gate bits [warps][FP / kChunk][32 lanes]
// and the per-warp vector sums [warps][5 CP + FP]
__host__ __device__ inline size_t bwd_smem(int cp, int fp) {
  return fwd_smem(cp, fp) + sizeof(uint32_t) * kTileWarps * (fp / kChunk) * 32 +
         sizeof(float) * kTileWarps * (5 * (size_t)cp + fp);
}
// ... of pass 2: two stages of two tiles [kWTile][kWTile + 8]
constexpr size_t dw_smem() { return sizeof(bf16) * 2 * 2 * kWTile * (kWTile + 8); }

inline bool fits_fwd(int c, int f) {
  return c >= 1 && f >= 1 && c <= kMaxCp && fwd_smem(inst_cp(c), pad64(f)) <= kMaxSmem;
}
inline bool fits_bwd(int c, int f) {
  return fits_fwd(c, f) && bwd_smem(inst_cp(c), pad64(f)) <= kMaxSmem;
}

// fn(std::integral_constant<int, CP>) for the padded width cp, up to 128
template <typename Fn>
cudaError_t with_cp(int cp, Fn fn) {
  switch (cp) {
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 48: return fn(std::integral_constant<int, 48>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 80: return fn(std::integral_constant<int, 80>{});
    case 96: return fn(std::integral_constant<int, 96>{});
    case 112: return fn(std::integral_constant<int, 112>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

// ... for the wide instances (inst_cp; the cat_vec inter encoder, C = 174 or 192)
template <typename Fn>
cudaError_t with_wide_cp(int cp, Fn fn) {
  switch (cp) {
    case 176: return fn(std::integral_constant<int, 176>{});
    case 192: return fn(std::integral_constant<int, 192>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

struct Tile {
  bf16 *w1, *w2, *xs;
  float *b1, *b2, *g1, *be1, *g2, *be2;
};

constexpr int kRowsAhead = 16;  // weight rows whose loads a lane has in flight at once

// dst [rows][ld] (rows, cols: the padded extent) = src [n_rows][n_cols] (f32)
// rounded to bf16, zero past n_rows and n_cols. A warp per kRowsAhead rows,
// a lane per two columns of a 64-column step: every load of the step issued
// before the first store, so a block's copy costs a few memory latencies.
__device__ __forceinline__ void copy_rounded(bf16* dst, int ld, int rows, int cols,
                                             const float* src, int n_rows, int n_cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const bool pairs = (n_cols & 1) == 0 && (reinterpret_cast<uintptr_t>(src) & 7) == 0;
  for (int r0 = warp * kRowsAhead; r0 < rows; r0 += nw * kRowsAhead)
    for (int i = 2 * lane; i < cols; i += 64) {
      float2 v[kRowsAhead];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        const int r = r0 + u;
        const float* row = src + (size_t)r * n_cols;
        v[u] = make_float2(0.f, 0.f);
        if (r >= n_rows || i >= n_cols) continue;
        if (pairs) {
          v[u] = __ldg(reinterpret_cast<const float2*>(row + i));
        } else {
          v[u].x = __ldg(row + i);
          if (i + 1 < n_cols) v[u].y = __ldg(row + i + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u)
        if (r0 + u < rows)
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(r0 + u) * ld + i) =
              __floats2bfloat162_rn(v[u].x, v[u].y);
    }
}

// The block's weights into shared memory (rounded to bf16, zero outside C
// and F); ends with a barrier.
template <int CP>
__device__ Tile load_weights(unsigned char* smem, const Params& p, int c, int f, int fp) {
  Tile s;
  s.w1 = reinterpret_cast<bf16*>(smem);
  s.w2 = s.w1 + (size_t)fp * (CP + 8);
  s.xs = s.w2 + (size_t)CP * (fp + 8);
  s.b1 = reinterpret_cast<float*>(s.xs + (size_t)kRows * (CP + 8));
  s.b2 = s.b1 + fp;
  s.g1 = s.b2 + CP;
  s.be1 = s.g1 + CP;
  s.g2 = s.be1 + CP;
  s.be2 = s.g2 + CP;
  copy_rounded(s.w1, CP + 8, fp, CP, p.w1, f, c);
  copy_rounded(s.w2, fp + 8, CP, fp, p.w2, c, f);
  for (int i = threadIdx.x; i < fp; i += blockDim.x) s.b1[i] = i < f ? p.b1[i] : 0.f;
  for (int i = threadIdx.x; i < CP; i += blockDim.x) {
    const bool in = i < c;
    s.b2[i] = in ? p.b2[i] : 0.f;
    s.g1[i] = in ? p.ln1_w[i] : 0.f;
    s.be1[i] = in ? p.ln1_b[i] : 0.f;
    s.g2[i] = in ? p.ln2_w[i] : 0.f;
    s.be2[i] = in ? p.ln2_b[i] : 0.f;
  }
  __syncthreads();
  return s;
}

// Rows r0..r0+15 of x [rows][c] into the warp's tile xw [16][CP + 8], zero
// past c and past rows; `vec` elements a copy (8, 2: cp.async; 1: loads).
template <int CP>
__device__ __forceinline__ void load_x(bf16* xw, const bf16* x, long r0, int rows, int c, int vec,
                                       int lane) {
  constexpr int LD = CP + 8;
  if (vec == 8) {
    constexpr int kPer = CP / 8;
    for (int e = lane; e < 16 * kPer; e += 32) {
      const int r = e / kPer, i = e % kPer * 8;
      const bool in = r0 + r < rows && i < c;
      amma::cp_async16(xw + r * LD + i, in ? x + (r0 + r) * c + i : x, in);
    }
  } else if (vec == 2) {
    constexpr int kPer = CP / 2;
    for (int e = lane; e < 16 * kPer; e += 32) {
      const int r = e / kPer, i = e % kPer * 2;
      const bool in = r0 + r < rows && i < c;
      amma::cp_async4(xw + r * LD + i, in ? x + (r0 + r) * c + i : x, in);
    }
  } else {
    for (int e = lane; e < 16 * CP; e += 32) {
      const int r = e / CP, i = e % CP;
      xw[r * LD + i] = r0 + r < rows && i < c ? x[(r0 + r) * c + i] : __float2bfloat16(0.f);
    }
  }
  amma::cp_commit();
  amma::cp_wait<0>();
  __syncwarp();
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A LayerNorm's value as the plain version forms it: ((x - mean) * rstd) * g + b
__device__ __forceinline__ float ln_value(float x, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mean, rstd), g), b);
}

// The value of element e of n-tile j (of a 16 x CP set in accumulator
// layout) from the warp's x tile: x at row g + 8 (e / 2), column 8 j + 2 t + e % 2.
template <int CP>
__device__ __forceinline__ float x_at(const bf16* xw, int lane, int j, int e) {
  const float2 v = ld2(xw + ((lane >> 2) + 8 * (e >> 1)) * (CP + 8) + 8 * j + 2 * (lane & 3));
  return (e & 1) ? v.y : v.x;
}

// LN1's statistics of the warp's rows g and g + 8, and T(n) as the A
// fragments of the first product (k-step kk: columns 16 kk..16 kk + 15).
template <int CP>
__device__ __forceinline__ void ln1(const bf16* xw, const Tile& s, int c, float eps, int lane,
                                    float (&mean)[2], float (&rstd)[2],
                                    uint32_t (&na)[CP / 16][4]) {
  constexpr int NJ = CP / 8;
  const int t2 = 2 * (lane & 3);
  const float fc = (float)c;
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e >> 1] += x_at<CP>(xw, lane, j, e);  // zero past c
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) mean[hh] = amma::quad_sum(sum[hh]) / fc;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * j + t2 + (e & 1) < c) {
        const float d = x_at<CP>(xw, lane, j, e) - mean[e >> 1];
        sq[e >> 1] += d * d;
      }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) rstd[hh] = rsqrtf(amma::quad_sum(sq[hh]) / fc + eps);
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) {
    float v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 2 * kk + h, col = 8 * j + t2 + (e & 1);
        v[h][e] = ln_value(x_at<CP>(xw, lane, j, e), mean[e >> 1], rstd[e >> 1], s.g1[col],
                           s.be1[col]);
      }
    amma::acc_to_a(na[kk], v[0], v[1]);
  }
}

// h = T(n) . W1^T over the 64 hidden columns of chunk ch
template <int CP>
__device__ __forceinline__ void linear1(float (&h)[8][4], const uint32_t (&na)[CP / 16][4],
                                        const bf16* w1s, int ch, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t kb[4];
      amma::ldsm_x4(kb, w1s + amma::b_off(lane, ch * kChunk + np * 16, kk * 16, CP + 8));
      amma::mma(h[2 * np], na[kk], kb[0], kb[1]);
      amma::mma(h[2 * np + 1], na[kk], kb[2], kb[3]);
    }
}

// a = T(drop1(relu(h + b1))) of chunk ch, in place and as the A fragments of
// the second product; returns the gate bits (bit 4 j + e: h + b1 > 0 and kept)
__device__ __forceinline__ uint32_t activate(float (&h)[8][4], uint32_t (&af)[4][4],
                                             const Tile& s, const Dropout& dp, long r0, int rows,
                                             int f, int ch, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  uint32_t gate = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = ch * kChunk + 8 * j + t2 + (e & 1);
      const long row = r0 + g + 8 * (e >> 1);
      float v = __fadd_rn(h[j][e], s.b1[col]);
      bool on = v > 0.f;
      v = fmaxf(v, 0.f);
      if (dp.mode != 0) {
        const bool keep = col < f && row < rows && kept(dp, 1, row, col, f);
        on = on && keep;
        v = keep ? __fmul_rn(v, dp.inv) : 0.f;
      }
      h[j][e] = v;
      gate |= (uint32_t)on << (4 * j + e);
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) amma::acc_to_a(af[kk], h[2 * kk], h[2 * kk + 1]);
  return gate;
}

// y += T(a_c) . W2[:, c]^T for chunk ch
template <int CP>
__device__ __forceinline__ void linear2(float (&y)[CP / 8][4], const uint32_t (&af)[4][4],
                                        const bf16* w2s, int fp, int ch, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < CP / 16; ++np) {
      uint32_t kb[4];
      amma::ldsm_x4(kb, w2s + amma::b_off(lane, np * 16, ch * kChunk + kk * 16, fp + 8));
      amma::mma(y[2 * np], af[kk], kb[0], kb[1]);
      amma::mma(y[2 * np + 1], af[kk], kb[2], kb[3]);
    }
}

// drop2's keep bits of a warp's 16 x CP set, element e of n-tile j at bit
// 4 j + e of the words (two words up to C = 128, four at 256)
template <int CP>
struct KeepBits {
  uint32_t w[(CP / 8 * 4 + 31) / 32];
  __device__ __forceinline__ bool operator()(int j, int e) const {
    return (w[(4 * j + e) >> 5] >> ((4 * j + e) & 31)) & 1u;
  }
};

// The forward of the warp's 16 rows up to LN2's normalised value: y (the
// second product) becomes z2 = (z - mean2) * rstd2 with z = n + drop2(y +
// b2); returns drop2's keep bits, rstd2 through rstd2.
template <int CP>
__device__ __forceinline__ KeepBits<CP> residual_ln2(float (&y)[CP / 8][4], const bf16* xw,
                                                 const Tile& s, const float (&mean1)[2],
                                                 const float (&rstd1)[2], const Dropout& dp,
                                                 long r0, int rows, int c, float eps, int lane,
                                                 float (&rstd2)[2]) {
  constexpr int NJ = CP / 8;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const float fc = (float)c;
  KeepBits<CP> keep;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(keep.w) / sizeof(uint32_t)); ++i) keep.w[i] = 0u;
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f}, mean2[2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + t2 + (e & 1), hh = e >> 1;
      const float n =
          ln_value(x_at<CP>(xw, lane, j, e), mean1[hh], rstd1[hh], s.g1[col], s.be1[col]);
      float v = __fadd_rn(y[j][e], s.b2[col]);
      if (dp.mode != 0) {
        const long row = r0 + g + 8 * hh;
        const bool k = col < c && row < rows && kept(dp, 2, row, col, c);
        v = k ? __fmul_rn(v, dp.inv) : 0.f;
        keep.w[(4 * j + e) >> 5] |= (uint32_t)k << ((4 * j + e) & 31);
      }
      y[j][e] = __fadd_rn(n, v);  // 0 past c
      sum[hh] += y[j][e];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) mean2[hh] = amma::quad_sum(sum[hh]) / fc;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * j + t2 + (e & 1) < c) {
        const float d = y[j][e] - mean2[e >> 1];
        sq[e >> 1] += d * d;
      }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) rstd2[hh] = rsqrtf(amma::quad_sum(sq[hh]) / fc + eps);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = __fmul_rn(y[j][e] - mean2[e >> 1], rstd2[e >> 1]);
  return keep;
}

// (v0, v1) rounded to bf16 at row[col], row[col + 1], those below `limit`;
// one 4-byte store where `pairs` (an even row stride, col even)
__device__ __forceinline__ void store2(bf16* row, int col, int limit, float v0, float v1,
                                       bool pairs) {
  if (pairs && col + 1 < limit) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < limit) row[col] = __float2bfloat16(v0);
    if (col + 1 < limit) row[col + 1] = __float2bfloat16(v1);
  }
}

// Forward (Kernel B; Kernel D's forward): out [rows][c] from x [rows][c].
template <int CP>
__global__ void __launch_bounds__(kTileThreads, 2)
fwd_kernel(const bf16* __restrict__ x, Params p, bf16* __restrict__ out, int rows, int c, int f,
           float eps, int vec, Dropout dp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fp = pad64(f);
  const Tile s = load_weights<CP>(smem_raw, p, c, f, fp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  bf16* xw = s.xs + warp * kUnit * (CP + 8);
  const long units = (rows + kUnit - 1) / kUnit;
  for (long u = blockIdx.x + (long)gridDim.x * warp; u < units; u += (long)gridDim.x * kTileWarps) {
    const long r0 = u * kUnit;
    load_x<CP>(xw, x, r0, rows, c, vec, lane);
    float mean1[2], rstd1[2], rstd2[2];
    uint32_t na[CP / 16][4];
    ln1<CP>(xw, s, c, eps, lane, mean1, rstd1, na);
    float y[CP / 8][4];
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
    for (int ch = 0; ch < fp / kChunk; ++ch) {
      float h[8][4];
      uint32_t af[4][4];
      linear1<CP>(h, na, s.w1, ch, lane);
      activate(h, af, s, dp, r0, rows, f, ch, lane);
      linear2<CP>(y, af, s.w2, fp, ch, lane);
    }
    residual_ln2<CP>(y, xw, s, mean1, rstd1, dp, r0, rows, c, eps, lane, rstd2);
#pragma unroll
    for (int j = 0; j < CP / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = r0 + g + 8 * hh;
        const int col = 8 * j + t2;
        if (row < rows && col < c)
          store2(out + row * c, col, c,
                 __fadd_rn(__fmul_rn(y[j][2 * hh], s.g2[col]), s.be2[col]),
                 __fadd_rn(__fmul_rn(y[j][2 * hh + 1], s.g2[col + 1]), s.be2[col + 1]),
                 (c & 1) == 0);
      }
    __syncwarp();  // xw is rewritten by the next unit
  }
}

// ---- Kernel D's backward, pass 1 (encoder_ffn_train.cu has passes 2 and 3)

// A fragment set (16 rows x 16 kk.. columns, acc_to_a's layout) into dst
// [rows][ld] at column c0 + 16 kk, rows r0.. below `rows`
template <int K>
__device__ __forceinline__ void store_frags(bf16* dst, int ld, const uint32_t (&fr)[K][4], long r0,
                                            int rows, int c0, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long row = r0 + g + 8 * (i & 1);
      if (row < rows)
        *reinterpret_cast<uint32_t*>(dst + row * ld + c0 + 16 * kk + 8 * (i >> 1) + t2) = fr[kk][i];
    }
}

// The sum over the warp's 16 rows of a column value held as v (row g) and
// w (row g + 8): the 8 row groups added by shuffles; every lane of a column
// quad position gets it
__device__ __forceinline__ float col_sum(float v, float w) {
  float s = v + w;
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  return s + __shfl_xor_sync(0xffffffffu, s, 16);
}

// acc[col], acc[col + 1] += the column sums of a 16 x 8 n-tile's elements
// (lanes of row group 0 add)
__device__ __forceinline__ void add_cols(float* acc, int col, const float (&v)[4], int lane) {
  const float s0 = col_sum(v[0], v[2]), s1 = col_sum(v[1], v[3]);
  if (lane < 4) {
    acc[col] += s0;
    acc[col + 1] += s1;
  }
}

// Backward pass 1: dx, the weight gradients' operands nb, dyb [rows][CP] =
// T(n), T(dy) and ab, dab [rows][FP] = T(a), T(da) (zero past c and f), and
// the block's sums of the vector gradients, vec_part [block][5c + f] =
// (dln1_w, dln1_b, db1, db2, dln2_w, dln2_b).
template <int CP>
__global__ void __launch_bounds__(kTileThreads, 2)
bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout, Params p,
                bf16* __restrict__ dx, bf16* __restrict__ nb, bf16* __restrict__ ab,
                bf16* __restrict__ dyb, bf16* __restrict__ dab, float* __restrict__ vec_part,
                int rows, int c, int f, float eps, int vec, Dropout dp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NJ = CP / 8, NK = CP / 16;
  const int fp = pad64(f), nch = fp / kChunk, nv = 5 * CP + fp;
  const Tile s = load_weights<CP>(smem_raw, p, c, f, fp);
  uint32_t* gates = reinterpret_cast<uint32_t*>(s.be2 + CP);  // [warps][nch][32]
  float* vacc = reinterpret_cast<float*>(gates + kTileWarps * nch * 32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  bf16* xw = s.xs + warp * kUnit * (CP + 8);
  uint32_t* gw = gates + warp * nch * 32;
  // this warp's sums: dln1_w [CP], dln1_b [CP], db1 [FP], db2, dln2_w, dln2_b [CP]
  float* va = vacc + warp * nv;
  float *v_g1 = va, *v_be1 = va + CP, *v_b1 = va + 2 * CP, *v_b2 = v_b1 + fp, *v_g2 = v_b2 + CP,
        *v_be2 = v_g2 + CP;
  for (int i = lane; i < nv; i += 32) va[i] = 0.f;
  __syncwarp();
  const float fc = (float)c;
  const bool pairs = (c & 1) == 0;
  const long units = (rows + kUnit - 1) / kUnit;
  for (long u = blockIdx.x + (long)gridDim.x * warp; u < units; u += (long)gridDim.x * kTileWarps) {
    const long r0 = u * kUnit;
    load_x<CP>(xw, x, r0, rows, c, vec, lane);
    float mean1[2], rstd1[2], rstd2[2];
    uint32_t na[NK][4];
    ln1<CP>(xw, s, c, eps, lane, mean1, rstd1, na);
    store_frags(nb, CP, na, r0, rows, 0, lane);

    // the forward again, the same loop: y, then z2 in its place
    float y[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      float h[8][4];
      uint32_t af[4][4];
      linear1<CP>(h, na, s.w1, ch, lane);
      gw[ch * 32 + lane] = activate(h, af, s, dp, r0, rows, f, ch, lane);
      store_frags(ab, fp, af, r0, rows, ch * kChunk, lane);
      linear2<CP>(y, af, s.w2, fp, ch, lane);
    }
    const KeepBits<CP> keep2 =
        residual_ln2<CP>(y, xw, s, mean1, rstd1, dp, r0, rows, c, eps, lane, rstd2);

    // LN2 backward: dz into y (the residual hands it to dn), then dy = drop2'(dz)
    float dzh[NJ][4];
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float gv[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = r0 + g + 8 * hh;
        const int col = 8 * j + t2;
        gv[2 * hh] = gv[2 * hh + 1] = 0.f;
        if (row < rows) {
          if (pairs && col + 1 < c) {
            const float2 v = ld2(dout + row * c + col);
            gv[2 * hh] = v.x;
            gv[2 * hh + 1] = v.y;
          } else {
            if (col < c) gv[2 * hh] = __bfloat162float(dout[row * c + col]);
            if (col + 1 < c) gv[2 * hh + 1] = __bfloat162float(dout[row * c + col + 1]);
          }
        }
      }
      float gz[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + t2 + (e & 1);
        gz[e] = gv[e] * y[j][e];
        dzh[j][e] = gv[e] * s.g2[col];
        s1[e >> 1] += dzh[j][e];
        s2[e >> 1] += dzh[j][e] * y[j][e];
      }
      add_cols(v_g2, 8 * j + t2, gz, lane);
      add_cols(v_be2, 8 * j + t2, gv, lane);
    }
    float m1[2], m2[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m1[hh] = amma::quad_sum(s1[hh]) / fc;
      m2[hh] = amma::quad_sum(s2[hh]) / fc;
    }
    uint32_t dya[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      float dy[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kk + h;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + t2 + (e & 1);
          const float dz =
              col < c ? (dzh[j][e] - m1[e >> 1] - y[j][e] * m2[e >> 1]) * rstd2[e >> 1] : 0.f;
          y[j][e] = dz;
          dy[h][e] = dp.mode == 0 ? dz : (keep2(j, e) ? dz * dp.inv : 0.f);
        }
        add_cols(v_b2, 8 * j + t2, dy[h], lane);
      }
      amma::acc_to_a(dya[kk], dy[0], dy[1]);
    }
    store_frags(dyb, CP, dya, r0, rows, 0, lane);

    // per chunk: da = drop1'(T(dy) . W2[:, c]) gated by the ReLU, then dn += T(da) . W1_c
    for (int ch = 0; ch < nch; ++ch) {
      float da[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) da[j][0] = da[j][1] = da[j][2] = da[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kb[4];
          amma::ldsm_x4_t(kb, s.w2 + amma::a_off(lane, kk * 16, ch * kChunk + np * 16, fp + 8));
          amma::mma(da[2 * np], dya[kk], kb[0], kb[1]);
          amma::mma(da[2 * np + 1], dya[kk], kb[2], kb[3]);
        }
      const uint32_t gate = gw[ch * 32 + lane];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = dp.mode == 0 ? da[j][e] : da[j][e] * dp.inv;
          da[j][e] = (gate >> (4 * j + e)) & 1u ? v : 0.f;
        }
        add_cols(v_b1, ch * kChunk + 8 * j + t2, da[j], lane);
      }
      uint32_t daa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) amma::acc_to_a(daa[kk], da[2 * kk], da[2 * kk + 1]);
      store_frags(dab, fp, daa, r0, rows, ch * kChunk, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < NK; ++np) {
          uint32_t kb[4];
          amma::ldsm_x4_t(kb, s.w1 + amma::a_off(lane, ch * kChunk + kk * 16, np * 16, CP + 8));
          amma::mma(y[2 * np], daa[kk], kb[0], kb[1]);
          amma::mma(y[2 * np + 1], daa[kk], kb[2], kb[3]);
        }
    }

    // LN1 backward: dn is y; dzh = dn * g1
    float q1[2] = {0.f, 0.f}, q2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float zn[4], dnz[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + t2 + (e & 1), hh = e >> 1;
        zn[e] = __fmul_rn(x_at<CP>(xw, lane, j, e) - mean1[hh], rstd1[hh]);
        dnz[e] = y[j][e] * zn[e];
        const float d = y[j][e] * s.g1[col];
        q1[hh] += d;
        q2[hh] += d * zn[e];
      }
      add_cols(v_g1, 8 * j + t2, dnz, lane);
      add_cols(v_be1, 8 * j + t2, y[j], lane);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      q1[hh] = amma::quad_sum(q1[hh]) / fc;
      q2[hh] = amma::quad_sum(q2[hh]) / fc;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = r0 + g + 8 * hh;
        const int col = 8 * j + t2;
        if (row >= rows || col >= c) continue;
        float v[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * hh + i;
          const float zn = __fmul_rn(x_at<CP>(xw, lane, j, e) - mean1[hh], rstd1[hh]);
          v[i] = (y[j][e] * s.g1[col + i] - q1[hh] - zn * q2[hh]) * rstd1[hh];
        }
        store2(dx + row * c, col, c, v[0], v[1], pairs);
      }
    __syncwarp();  // xw is rewritten by the next unit
  }

  // the block's sums: the warps' in a fixed order, at the real columns
  __syncthreads();
  const int nreal = 5 * c + f;
  for (int e = threadIdx.x; e < nreal; e += blockDim.x) {
    int i;  // the padded index of real entry e
    if (e < 2 * c)
      i = e / c * CP + e % c;
    else if (e < 2 * c + f)
      i = 2 * CP + (e - 2 * c);
    else
      i = 2 * CP + fp + (e - 2 * c - f) / c * CP + (e - 2 * c - f) % c;
    float acc = 0.f;
    for (int w = 0; w < kTileWarps; ++w) acc += vacc[w * nv + i];
    vec_part[(size_t)blockIdx.x * nreal + e] = acc;
  }
}

// Pass 1's launch at the padded width CP (``with_cp`` for C up to 128 in
// encoder_ffn_train.cu, ``with_wide_cp`` in encoder_ffn_train_wide.cu).
template <int CP>
cudaError_t launch_bwd_rows(const void* x, const void* dout, const Params& p, void* dx, void* nb,
                            void* ab, void* dyb, void* dab, float* vec_part, int rows, int c,
                            int f, float eps, int grid, int vec, const Dropout& dp,
                            cudaStream_t st) {
  const size_t bytes = bwd_smem(CP, pad64(f));
  cudaError_t err = amma::allow_smem<bwd_rows_kernel<CP>>(bytes);
  if (err != cudaSuccess) return err;
  bwd_rows_kernel<CP><<<grid, kTileThreads, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dout), p, static_cast<bf16*>(dx),
      static_cast<bf16*>(nb), static_cast<bf16*>(ab), static_cast<bf16*>(dyb),
      static_cast<bf16*>(dab), vec_part, rows, c, f, eps, vec, dp);
  return cudaGetLastError();
}

// The forward's launch: `grid` blocks walking the 64-row tiles. A template,
// so that a file that never calls it (encoder_ffn_train_wide.cu) compiles
// none of the forward's instances.
template <typename = void>
cudaError_t launch_fwd(const void* x, const Params& p, void* out, int rows, int c, int f,
                              float eps, int grid, const Dropout& dp, cudaStream_t st) {
  if (!fits_fwd(c, f) || grid < 1 || rows < 1) return cudaErrorInvalidValue;
  const int vec = amma::copy_vec(c, {x});
  auto launch = [&](auto k) {
    constexpr int CP = decltype(k)::value;
    const size_t bytes = fwd_smem(CP, pad64(f));
    cudaError_t err = amma::allow_smem<fwd_kernel<CP>>(bytes);
    if (err != cudaSuccess) return err;
    fwd_kernel<CP><<<grid, kTileThreads, bytes, st>>>(static_cast<const bf16*>(x), p,
                                                      static_cast<bf16*>(out), rows, c, f, eps,
                                                      vec, dp);
    return cudaGetLastError();
  };
  return inst_cp(c) <= 128 ? with_cp(inst_cp(c), launch) : with_wide_cp(inst_cp(c), launch);
}

}  // namespace ffn
}  // namespace
