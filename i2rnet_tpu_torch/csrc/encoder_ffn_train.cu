// Post-norm DETR encoder FFN tail with both dropouts, training forward and
// backward, for Hopper (sm_90a).
//
// Replaces: i2rnet_tpu/ops/pallas/encoder_ffn_train.py::encoder_ffn_train.
//
// Computes, per token row x of width C (F hidden units),
//     n   = LN1(x)                              (f32 statistics, eps)
//     h   = T(n) . T(W1)^T + b1                 (f32 accumulation)
//     a   = T(drop1(relu(h)))                   (drop: keep ? v / (1 - rate) : 0)
//     y   = drop2(a . T(W2)^T + b2)
//     out = T(LN2(n + y))                       (residual on the f32 n)
// with T() the activation type, the casting points of encoder_ffn_train.py:
// 84-119, and the backward dx plus the eight parameter gradients (LN1 and LN2
// scale and bias, W1, b1, W2, b2) in f32, recomputing the forward per row as
// encoder_ffn_train.py:132-188 does.
//
// What bounds it on the H100: at the main-path shape (rows = 8*1344 = 10752,
// C = 96, F = 192) the forward's products are 0.79 GFLOP and the backward's
// 2.4 GFLOP (0.8 and 2.4 us on the tensor cores), against 4 MB of
// activations in bf16 (1.3 us of device memory); the dropout bits, one
// Philox word per element of [R, F] and [R, C] (3.1 M words a pass), are
// integer work the bound does not count, and may set the pace.
//
// Design, bf16 (ffn_tile.cuh, shared with Kernel B): the forward is one
// launch of the tile body (warps of 16 rows spread over every SM, W1 and W2
// rounded to bf16 into shared memory once per block, both products on
// mma.sync per 64-column chunk of F with the hidden activation kept in
// registers). The backward is three launches, below:
// * pass 1 (ffn_tile.cuh::bwd_rows_kernel; its instances above C = 128 in
//   encoder_ffn_train_wide.cu, which compiles beside this file), the
//   forward's blocks and units: the same walk
//   recomputes h, a and LN2's statistics bit for bit (each chunk's ReLU gates
//   and dropout keeps kept as bits), then LN2's backward, dy = drop2'(dz),
//   per chunk da_c = T(dy) . W2[:, c] (ldmatrix.trans of the same W2 tile),
//   drop1' and the gate, and dn += T(da_c) . W1_c on a 16 x CP accumulator
//   that starts at dz (the residual), then LN1's backward; it writes dx, the
//   rounded operands of the weight gradients T(n), T(a), T(dy), T(da) (rows of
//   CP or FP, zero past C and F) and each block's f32 sums of the six vector
//   gradients (a warp's over its 8 row groups by shuffles, the warps added in
//   a fixed order);
// * pass 2 (dw_kernel): dW1 = T(da)^T T(n) and dW2 = T(dy)^T T(a) on mma.sync
//   with the rows as k (both operands by ldmatrix.trans from a 2-stage
//   cp.async ring), a block per (product, 64 x 64 output tile, row slice);
// * pass 3 (bwd_sum_kernel): the slices and the blocks' vector sums, each
//   added in a fixed order. No atomics: two calls give the same bits.
// The launch plan is ops/cuda/encoder_ffn.py::ffn_plan.
//
// Design, f32 (the first CUDA-core template; TF32 would not hold the f32
// checks' 1e-4):
// * W1 [F][C] and W2 [C][F] (torch layout) sit in dynamic shared memory as
//   f32 with an odd row stride (C+1, F+1): the lanes of a warp read a column
//   (forward: lane = output unit) or a row (backward: lane = input unit)
//   without bank conflicts, from one copy (149 KB at C=96, F=192);
// * one warp per row: LayerNorms with warp shuffles, the products with one
//   output per lane and the row's vectors in a per-warp shared scratch, so
//   any C and F whose weights fit are taken;
// * parameter gradients without atomics: the row kernel writes the operands
//   of the two weight products (n, a, dy, da) and each block's partial sums
//   of the six vector gradients; dW = sum over rows of an outer product is
//   then common.cuh::outer_sum over row slices with per-slice partials, and
//   a last kernel adds the partials in a fixed order. Deterministic on a
//   given grid.
// Dropout bits (both designs): explicit [R, F] and [R, C] uint32 tensors
// (tests, parity), or Philox4x32-10 (philox.cuh) keyed by (seed, offset) for
// the first site and (seed, offset + 1) for the second, counted by (column,
// row); the backward regenerates them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "ffn_tile.cuh"
#include "philox.cuh"

// encoder_ffn_train_wide.cu: the backward's pass 1 at C above 128
extern "C" int i2r_ffn_bwd_rows_wide(const void* x, const void* dout, const float* ln1_w,
                                     const float* ln1_b, const float* w1, const float* b1,
                                     const float* w2, const float* b2, const float* ln2_w,
                                     const float* ln2_b, void* dx, void* nb, void* ab, void* dyb,
                                     void* dab, float* vec_part, int rows, int c, int f,
                                     float eps, int grid, int vec, const uint32_t* bits1,
                                     const uint32_t* bits2, uint32_t seed, uint32_t offset,
                                     uint32_t threshold, float inv, int mode, cudaStream_t st);

namespace {

// v after dropout site `site` (1: [rows, f] after the ReLU, 2: [rows, c] after linear2)
__device__ __forceinline__ float drop(const Dropout& dp, int site, float v, int r, int col,
                                      int width) {
  if (dp.mode == 0) return v;
  return kept(dp, site, r, col, width) ? v * dp.inv : 0.f;
}

// Shared layout common to both kernels: W1 [f][c+1], W2 [c][f+1], b1 [f],
// b2, g1, be1, g2, be2 [c]; then the per-warp scratch.
struct Smem {
  float *w1, *w2, *b1, *b2, *g1, *be1, *g2, *be2, *scratch;
};

__host__ __device__ inline size_t param_floats(int c, int f) {
  return (size_t)f * (c + 1) + (size_t)c * (f + 1) + f + 5 * (size_t)c;
}

__device__ Smem load_params(float* smem, const float* w1, const float* w2, const float* b1,
                            const float* b2, const float* g1, const float* be1, const float* g2,
                            const float* be2, int c, int f) {
  Smem p;
  p.w1 = smem;
  p.w2 = p.w1 + (size_t)f * (c + 1);
  p.b1 = p.w2 + (size_t)c * (f + 1);
  p.b2 = p.b1 + f;
  p.g1 = p.b2 + c;
  p.be1 = p.g1 + c;
  p.g2 = p.be1 + c;
  p.be2 = p.g2 + c;
  p.scratch = p.be2 + c;
  for (int i = threadIdx.x; i < f * c; i += blockDim.x) p.w1[(i / c) * (c + 1) + i % c] = w1[i];
  for (int i = threadIdx.x; i < c * f; i += blockDim.x) p.w2[(i / f) * (f + 1) + i % f] = w2[i];
  for (int i = threadIdx.x; i < f; i += blockDim.x) p.b1[i] = b1[i];
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    p.b2[i] = b2[i];
    p.g1[i] = g1[i];
    p.be1[i] = be1[i];
    p.g2[i] = g2[i];
    p.be2[i] = be2[i];
  }
  __syncthreads();
  return p;
}

// LN1 of row xr into z1 (normalised, before the affine) and nb = T(n);
// returns rstd1. Lanes own columns lane, lane + 32, ...
template <typename T>
__device__ __forceinline__ float ln1_row(const T* xr, const Smem& p, float* z1, float* nb, int c,
                                         float eps, int lane) {
  const float fc = (float)c;
  float sum = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float xv = to_f32(xr[i]);
    z1[i] = xv;
    sum += xv;
  }
  const float mean = warp_sum(sum) / fc;
  float sq = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float dl = z1[i] - mean;
    z1[i] = dl;
    sq += dl * dl;
  }
  const float rstd = rsqrtf(warp_sum(sq) / fc + eps);
  for (int i = lane; i < c; i += 32) {
    const float z = z1[i] * rstd;
    z1[i] = z;
    nb[i] = round_to<T>(z * p.g1[i] + p.be1[i]);
  }
  __syncwarp();
  return rstd;
}

// h = T(n) . W1^T + b1 into hpre; a = T(drop1(relu(h))) into ab
template <typename T>
__device__ __forceinline__ void linear1_row(const Smem& p, const float* nb, float* hpre, float* ab,
                                            const Dropout& dp, int r, int c, int f, int lane) {
  for (int o = lane; o < f; o += 32) {
    const float* wr = p.w1 + (size_t)o * (c + 1);
    float a = 0.f;
    for (int i = 0; i < c; ++i) a += nb[i] * wr[i];
    a += p.b1[o];
    if (hpre != nullptr) hpre[o] = a;
    ab[o] = round_to<T>(drop(dp, 1, fmaxf(a, 0.f), r, o, f));
  }
  __syncwarp();
}

// z = n + drop2(T(a) . W2^T + b2) into z (n recomputed from z1); returns LN2's
// mean and rstd through mean2, rstd2 after overwriting z with z2 = (z - mean2) * rstd2
__device__ __forceinline__ float linear2_ln2_row(const Smem& p, const float* z1, const float* ab,
                                                 float* z, const Dropout& dp, int r, int c, int f,
                                                 float eps, int lane) {
  const float fc = (float)c;
  float zsum = 0.f;
  for (int o = lane; o < c; o += 32) {
    const float* wr = p.w2 + (size_t)o * (f + 1);
    float a = 0.f;
    for (int i = 0; i < f; ++i) a += ab[i] * wr[i];
    const float zv = (z1[o] * p.g1[o] + p.be1[o]) + drop(dp, 2, a + p.b2[o], r, o, c);
    z[o] = zv;
    zsum += zv;
  }
  const float mean = warp_sum(zsum) / fc;
  float sq = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float dl = z[i] - mean;
    z[i] = dl;
    sq += dl * dl;
  }
  const float rstd = rsqrtf(warp_sum(sq) / fc + eps);
  for (int i = lane; i < c; i += 32) z[i] *= rstd;
  __syncwarp();
  return rstd;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_train_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln1_w,
                     const float* __restrict__ ln1_b, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ ln2_w,
                     const float* __restrict__ ln2_b, T* __restrict__ out, int rows, int c, int f,
                     float eps, Dropout dp) {
  extern __shared__ __align__(16) float smem[];
  const Smem p = load_params(smem, w1, w2, b1, b2, ln1_w, ln1_b, ln2_w, ln2_b, c, f);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* z1 = p.scratch + (size_t)warp * (3 * c + f);
  float* nb = z1 + c;
  float* z = nb + c;
  float* ab = z + c;
  for (int r = blockIdx.x * kWarps + warp; r < rows; r += gridDim.x * kWarps) {
    ln1_row<T>(x + (size_t)r * c, p, z1, nb, c, eps, lane);
    linear1_row<T>(p, nb, nullptr, ab, dp, r, c, f, lane);
    linear2_ln2_row(p, z1, ab, z, dp, r, c, f, eps, lane);
    T* orow = out + (size_t)r * c;
    for (int i = lane; i < c; i += 32) orow[i] = from_f32<T>(z[i] * p.g2[i] + p.be2[i]);
    __syncwarp();  // the scratch is rewritten by the next row
  }
}

// Per-warp f32 partials of the vector gradients, in this order.
__host__ __device__ inline int vec_floats(int c, int f) { return 5 * c + f; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_train_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                          const float* __restrict__ ln1_w, const float* __restrict__ ln1_b,
                          const float* __restrict__ w1, const float* __restrict__ b1,
                          const float* __restrict__ w2, const float* __restrict__ b2,
                          const float* __restrict__ ln2_w, const float* __restrict__ ln2_b,
                          T* __restrict__ dx, T* __restrict__ nb_out, T* __restrict__ ab_out,
                          T* __restrict__ dyb_out, T* __restrict__ dab_out,
                          float* __restrict__ vec_part, int rows, int c, int f, float eps,
                          Dropout dp) {
  extern __shared__ __align__(16) float smem[];
  const Smem p = load_params(smem, w1, w2, b1, b2, ln1_w, ln1_b, ln2_w, ln2_b, c, f);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = vec_floats(c, f);
  float* z1 = p.scratch + (size_t)warp * (5 * c + 2 * f + nvec);
  float* nb = z1 + c;
  float* z2 = nb + c;
  float* dyb = z2 + c;
  float* dn = dyb + c;
  float* hd = dn + c;    // h before the ReLU, then T(da)
  float* ab = hd + f;
  float* part = ab + f;  // dln1_w [c], dln1_b [c], db1 [f], db2 [c], dln2_w [c], dln2_b [c]
  float* p_g1 = part;
  float* p_be1 = p_g1 + c;
  float* p_b1 = p_be1 + c;
  float* p_b2 = p_b1 + f;
  float* p_g2 = p_b2 + c;
  float* p_be2 = p_g2 + c;
  for (int i = lane; i < nvec; i += 32) part[i] = 0.f;
  const float fc = (float)c;

  for (int r = blockIdx.x * kWarps + warp; r < rows; r += gridDim.x * kWarps) {
    const float rstd1 = ln1_row<T>(x + (size_t)r * c, p, z1, nb, c, eps, lane);
    linear1_row<T>(p, nb, hd, ab, dp, r, c, f, lane);
    const float rstd2 = linear2_ln2_row(p, z1, ab, z2, dp, r, c, f, eps, lane);

    // LN2 backward (dz into dn: the residual hands dz to n), dropout2
    const T* g = dout + (size_t)r * c;
    float s1 = 0.f, s2 = 0.f;
    for (int o = lane; o < c; o += 32) {
      const float gv = to_f32(g[o]), dzh = gv * p.g2[o];
      p_g2[o] += gv * z2[o];
      p_be2[o] += gv;
      s1 += dzh;
      s2 += dzh * z2[o];
    }
    const float m1 = warp_sum(s1) / fc, m2 = warp_sum(s2) / fc;
    for (int o = lane; o < c; o += 32) {
      const float dz = (to_f32(g[o]) * p.g2[o] - m1 - z2[o] * m2) * rstd2;
      dn[o] = dz;
      const float dy = drop(dp, 2, dz, r, o, c);
      p_b2[o] += dy;
      dyb[o] = round_to<T>(dy);
    }
    __syncwarp();

    // linear2 backward, dropout1, ReLU gate: da = drop1'(T(dy) . W2)
    for (int i = lane; i < f; i += 32) {
      float a = 0.f;
      for (int o = 0; o < c; ++o) a += dyb[o] * p.w2[(size_t)o * (f + 1) + i];
      float da = drop(dp, 1, a, r, i, f);
      if (!(hd[i] > 0.f)) da = 0.f;
      p_b1[i] += da;
      hd[i] = round_to<T>(da);
    }
    __syncwarp();

    // linear1 backward plus the residual, then LN1 backward
    float t1 = 0.f, t2 = 0.f;
    for (int i = lane; i < c; i += 32) {
      float a = 0.f;
      for (int o = 0; o < f; ++o) a += hd[o] * p.w1[(size_t)o * (c + 1) + i];
      const float dnv = dn[i] + a;
      dn[i] = dnv;
      p_g1[i] += dnv * z1[i];
      p_be1[i] += dnv;
      const float dzh = dnv * p.g1[i];
      t1 += dzh;
      t2 += dzh * z1[i];
    }
    const float q1 = warp_sum(t1) / fc, q2 = warp_sum(t2) / fc;
    T* dxr = dx + (size_t)r * c;
    for (int i = lane; i < c; i += 32)
      dxr[i] = from_f32<T>((dn[i] * p.g1[i] - q1 - z1[i] * q2) * rstd1);

    // the rounded operands of dW1 = sum T(da)^T T(n) and dW2 = sum T(dy)^T T(a)
    for (int i = lane; i < c; i += 32) {
      nb_out[(size_t)r * c + i] = from_f32<T>(nb[i]);
      dyb_out[(size_t)r * c + i] = from_f32<T>(dyb[i]);
    }
    for (int i = lane; i < f; i += 32) {
      ab_out[(size_t)r * f + i] = from_f32<T>(ab[i]);
      dab_out[(size_t)r * f + i] = from_f32<T>(hd[i]);
    }
    __syncwarp();
  }

  // the block's vector partials: the warps' sums in a fixed order
  __syncthreads();
  const size_t stride = 5 * (size_t)c + 2 * f + nvec;
  for (int e = threadIdx.x; e < nvec; e += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += p.scratch[(size_t)w * stride + 5 * c + 2 * f + e];
    vec_part[(size_t)blockIdx.x * nvec + e] = acc;
  }
}

size_t fwd_smem(int c, int f) {
  return sizeof(float) * (param_floats(c, f) + (size_t)kWarps * (3 * c + f));
}

size_t bwd_smem(int c, int f) {
  return sizeof(float) *
         (param_floats(c, f) + (size_t)kWarps * (5 * c + 2 * f + vec_floats(c, f)));
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const Params& p, void* out, int rows, int c, int f,
                       float eps, int grid, Dropout dp, cudaStream_t st) {
  const size_t bytes = fwd_smem(c, f);
  cudaError_t err = set_smem(ffn_train_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  ffn_train_fwd_kernel<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), p.ln1_w, p.ln1_b, p.w1, p.b1, p.w2, p.b2, p.ln2_w, p.ln2_b,
      static_cast<T*>(out), rows, c, f, eps, dp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dout, const Params& p, void* dx, void* nb,
                       void* ab, void* dyb, void* dab, float* vec_part, float* w_part,
                       float* d_vec, float* dw1, float* dw2, int rows, int c, int f, float eps,
                       int grid, Dropout dp, cudaStream_t st) {
  const size_t bytes = bwd_smem(c, f);
  cudaError_t err = set_smem(ffn_train_bwd_rows_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  ffn_train_bwd_rows_kernel<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout), p.ln1_w, p.ln1_b, p.w1, p.b1, p.w2,
      p.b2, p.ln2_w, p.ln2_b, static_cast<T*>(dx), static_cast<T*>(nb), static_cast<T*>(ab),
      static_cast<T*>(dyb), static_cast<T*>(dab), vec_part, rows, c, f, eps, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nvec = vec_floats(c, f);
  err = sum_parts(vec_part, d_vec, grid, nvec, nvec, 1.f, st);
  if (err != cudaSuccess) return err;
  err = outer_sum<T>(dab, nb, w_part, dw1, rows, f, c, 1.f, st);  // dW1 [f][c]
  if (err != cudaSuccess) return err;
  return outer_sum<T>(dyb, ab, w_part, dw2, rows, c, f, 1.f, st);  // dW2 [c][f]
}

// ---------------------------------------------------------------------------
// bf16: the backward's three kernels on ffn_tile.cuh's body

namespace ffn {

// Backward pass 2: the two weight gradients over the token rows of one
// slice, dW1 = T(da)^T . T(n) [FP][CP64] and dW2 = T(dy)^T . T(a) [CP64][FP]
// (CP64: CP rounded up to 64), a block per (product, 64 x 64 output tile,
// slice): blocks [0, FP/64 x CP64/64) dW1's tiles, the rest dW2's. Token rows
// staged kWTile at a time in two cp.async stages, one in flight while the
// other is multiplied; A^T by ldmatrix.trans as the A operand, B by
// ldmatrix.trans as the B operand; warp (wm, wn) takes output rows 16 wm..
// and columns 32 wn.. Writes the tile's f32 sums to part [slice][2][FP *
// CP64] (dW1's block, then dW2's).
__global__ void __launch_bounds__(kThreads, 2)
dw_kernel(const bf16* __restrict__ dab, const bf16* __restrict__ nb, const bf16* __restrict__ dyb,
          const bf16* __restrict__ ab, float* __restrict__ part, int rows, int cp, int fp,
          int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = kWTile + 8, kTileE = kWTile * kLd, kPerRow = kWTile / 8;
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // [2 stages][A, B][kWTile][kLd]
  const int cpt = (cp + kWTile - 1) / kWTile, fpt = fp / kWTile, cp64 = cpt * kWTile;
  const bool first = (int)blockIdx.x < fpt * cpt;
  const int tile = first ? blockIdx.x : blockIdx.x - fpt * cpt, ntn = first ? cpt : fpt;
  const int m0 = tile / ntn * kWTile, n0 = tile % ntn * kWTile;
  const bf16* a = first ? dab : dyb;
  const bf16* b = first ? nb : ab;
  const int lda = first ? fp : cp, ldb = first ? cp : fp;
  const long t0 = (long)blockIdx.y * per, t1 = min((long)rows, t0 + per);
  auto stage = [&](int ch) {  // token rows of chunk ch into stage ch % 2
    const long r = t0 + (long)ch * kWTile;
    bf16* st = buf + (ch & 1) * 2 * kTileE;
    for (int e = threadIdx.x; e < 2 * kWTile * kPerRow; e += kThreads) {
      const int which = e / (kWTile * kPerRow), q = e % (kWTile * kPerRow);
      const int t = q / kPerRow, i = q % kPerRow * 8;
      const bf16* src = which ? b : a;
      const int ld = which ? ldb : lda, col = (which ? n0 : m0) + i;
      const bool in = r + t < t1 && col < ld;
      amma::cp_async16(st + which * kTileE + t * kLd + i, in ? src + (size_t)(r + t) * ld + col : src,
                       in);
    }
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3), wm = warp & 3, wn = warp >> 2;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int chunks = t1 > t0 ? (int)((t1 - t0 + kWTile - 1) / kWTile) : 0;
  if (chunks > 0) stage(0);
  amma::cp_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    amma::cp_wait<0>();  // chunk ch has landed
    __syncthreads();     // ... for every thread; chunk ch - 1's stage is free
    if (ch + 1 < chunks) stage(ch + 1);
    amma::cp_commit();
    const bf16* st = buf + (ch & 1) * 2 * kTileE;
#pragma unroll
    for (int kk = 0; kk < kWTile / 16; ++kk) {
      uint32_t bfr[2][4], af[4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        amma::ldsm_x4_t(bfr[np], st + kTileE + amma::a_off(lane, kk * 16, wn * 32 + np * 16, kLd));
      amma::ldsm_x4_t(af, st + amma::b_off(lane, kk * 16, wm * 16, kLd));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        amma::mma(acc[2 * np], af, bfr[np][0], bfr[np][1]);
        amma::mma(acc[2 * np + 1], af, bfr[np][2], bfr[np][3]);
      }
    }
  }
  const int nmax = first ? cp64 : fp;
  float* out = part + (size_t)blockIdx.y * 2 * fp * cp64 + (first ? 0 : (size_t)fp * cp64) +
               (size_t)(m0 + wm * 16) * nmax + n0 + wn * 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(out + (size_t)(g + 8 * hh) * nmax + j * 8 + c2) =
          make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
}

// Backward pass 3, the sums, each in a fixed order: blocks [0, w_blocks) a
// thread per element of dW1 [f][c] then dW2 [c][f] over the slices; the rest
// a warp per vector element over the blocks' sums of pass 1, lane l adding
// blocks l, l + 32, ... and the lanes in a fixed tree.
__global__ void __launch_bounds__(kThreads)
bwd_sum_kernel(const float* __restrict__ part, const float* __restrict__ vec_part,
               float* __restrict__ d_vec, float* __restrict__ dw1, float* __restrict__ dw2,
               int c, int f, int cp64, int fp, int slices, int blocks, int w_blocks) {
  if ((int)blockIdx.x < w_blocks) {
    const long fc = (long)f * c, e = (long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= 2 * fc) return;
    size_t off;
    float* dst;
    if (e < fc) {
      off = (size_t)(e / c) * cp64 + e % c;
      dst = dw1 + e;
    } else {
      const long e2 = e - fc;
      off = (size_t)fp * cp64 + (size_t)(e2 / f) * fp + e2 % f;
      dst = dw2 + e2;
    }
    const size_t stride = 2 * (size_t)fp * cp64;
    float acc = 0.f;
    for (int z = 0; z < slices; ++z) acc += part[z * stride + off];
    *dst = acc;
    return;
  }
  const int lane = threadIdx.x & 31, nvec = 5 * c + f;
  const int v = ((int)blockIdx.x - w_blocks) * kWarps + (threadIdx.x >> 5);
  if (v >= nvec) return;
  float acc = 0.f;
  for (int z = lane; z < blocks; z += 32) acc += vec_part[(size_t)z * nvec + v];
  acc = warp_sum(acc);
  if (lane == 0) d_vec[v] = acc;
}

// The backward's three launches: pass 1 on `grid` blocks, pass 2 on row
// slices of `slice_rows` rows (whole stages of kWTile rows), pass 3.
inline cudaError_t launch_bwd(const void* x, const void* dout, const Params& p, void* dx,
                              void* nb, void* ab, void* dyb, void* dab, float* vec_part,
                              float* w_part, float* d_vec, float* dw1, float* dw2, int rows,
                              int c, int f, float eps, int grid, int slice_rows,
                              const Dropout& dp, cudaStream_t st) {
  if (!fits_bwd(c, f) || grid < 1 || slice_rows < 1 || slice_rows % kWTile != 0 || rows < 1)
    return cudaErrorInvalidValue;
  const int cp = inst_cp(c), fp = pad64(f), cp64 = pad64(cp);
  const int nz = (rows + slice_rows - 1) / slice_rows;
  const int vec = amma::copy_vec(c, {x});
  // pass 1: C up to 128 here, the wide instances in encoder_ffn_train_wide.cu
  cudaError_t err =
      cp <= 128
          ? with_cp(cp, [&](auto k) {
              return launch_bwd_rows<decltype(k)::value>(x, dout, p, dx, nb, ab, dyb, dab,
                                                         vec_part, rows, c, f, eps, grid, vec,
                                                         dp, st);
            })
          : static_cast<cudaError_t>(i2r_ffn_bwd_rows_wide(
                x, dout, p.ln1_w, p.ln1_b, p.w1, p.b1, p.w2, p.b2, p.ln2_w, p.ln2_b, dx, nb, ab,
                dyb, dab, vec_part, rows, c, f, eps, grid, vec, dp.bits1, dp.bits2, dp.seed,
                dp.offset, dp.threshold, dp.inv, dp.mode, st));
  if (err != cudaSuccess) return err;
  dw_kernel<<<dim3(2 * (fp / kWTile) * (cp64 / kWTile), nz), kThreads, dw_smem(), st>>>(
      static_cast<const bf16*>(dab), static_cast<const bf16*>(nb), static_cast<const bf16*>(dyb),
      static_cast<const bf16*>(ab), w_part, rows, cp, fp, slice_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int w_blocks = (int)((2L * f * c + kThreads - 1) / kThreads);
  bwd_sum_kernel<<<w_blocks + (5 * c + f + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      w_part, vec_part, d_vec, dw1, dw2, c, f, cp64, fp, nz, grid, w_blocks);
  return cudaGetLastError();
}

}  // namespace ffn

}  // namespace

// x, out: [rows, c] contiguous, type T (dtype 0 = float32, 1 = bfloat16). w1: [f, c]
// and w2: [c, f] (torch Linear layout), b1 [f], b2 [c] and the LayerNorms' scales
// and biases [c], all float32 (the bf16 body rounds the weights as it loads
// them). Dropout mode 0 = none, 1 = bits (bits1 [rows, f], bits2 [rows, c]
// uint32), 2 = Philox from (seed, offset) and (seed, offset + 1); dropped where
// bits < threshold, survivors scaled by inv. grid: the number of blocks walking
// the rows (bf16: ffn_plan's grid). Returns the cudaError_t of the launch.
extern "C" int i2r_ffn_train_fwd(const void* x, const void* ln1_w, const void* ln1_b,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 const void* ln2_w, const void* ln2_b, void* out, int rows, int c,
                                 int f, float eps, int dtype, int grid, const void* bits1,
                                 const void* bits2, unsigned seed, unsigned offset,
                                 unsigned threshold, float inv, int mode, void* stream) {
  if (rows < 1 || c < 1 || f < 1 || grid < 1 || mode < 0 || mode > 2 ||
      (mode == 1 && (bits1 == nullptr || bits2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
                 static_cast<const float*>(w1),    static_cast<const float*>(b1),
                 static_cast<const float*>(w2),    static_cast<const float*>(b2),
                 static_cast<const float*>(ln2_w), static_cast<const float*>(ln2_b)};
  const Dropout dp{static_cast<const uint32_t*>(bits1), static_cast<const uint32_t*>(bits2), seed,
                   offset, threshold, inv, mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fwd<float>(x, p, out, rows, c, f, eps, grid, dp, st);
  if (dtype == 1) return (int)ffn::launch_fwd(x, p, out, rows, c, f, eps, grid, dp, st);
  return (int)cudaErrorInvalidValue;
}

// dout, dx: [rows, c] of type T. Outputs (float32): d_vec [5c + f] = (dln1_w,
// dln1_b, db1, db2, dln2_w, dln2_b), dw1 [f, c], dw2 [c, f]. Scratch, f32 (the
// CUDA-core template; slice_rows = 0): nb, dyb [rows, c] and ab, dab [rows, f] in
// T, vec_part [grid, 5c + f], w_part [16, f, c]. Scratch, bf16 (the tensor-core
// body; grid and slice_rows from ffn_plan): nb, dyb [rows, CP] and ab, dab
// [rows, FP] in bf16 (CP = c padded to 16, FP = f padded to 64), vec_part
// [grid, 5c + f], w_part [slices, 2, FP * CP64] (slices = rows / slice_rows
// rounded up, CP64 = CP padded to 64). Other arguments as the forward.
extern "C" int i2r_ffn_train_bwd(const void* x, const void* dout, const void* ln1_w,
                                 const void* ln1_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* ln2_w,
                                 const void* ln2_b, void* dx, void* nb, void* ab, void* dyb,
                                 void* dab, void* vec_part, void* w_part, void* d_vec, void* dw1,
                                 void* dw2, int rows, int c, int f, float eps, int dtype,
                                 int grid, int slice_rows, const void* bits1, const void* bits2,
                                 unsigned seed, unsigned offset, unsigned threshold, float inv,
                                 int mode, void* stream) {
  if (rows < 1 || c < 1 || f < 1 || grid < 1 || mode < 0 || mode > 2 ||
      (mode == 1 && (bits1 == nullptr || bits2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
                 static_cast<const float*>(w1),    static_cast<const float*>(b1),
                 static_cast<const float*>(w2),    static_cast<const float*>(b2),
                 static_cast<const float*>(ln2_w), static_cast<const float*>(ln2_b)};
  const Dropout dp{static_cast<const uint32_t*>(bits1), static_cast<const uint32_t*>(bits2), seed,
                   offset, threshold, inv, mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* vp = static_cast<float*>(vec_part);
  float* wp = static_cast<float*>(w_part);
  float* dv = static_cast<float*>(d_vec);
  float* g1 = static_cast<float*>(dw1);
  float* g2 = static_cast<float*>(dw2);
  if (dtype == 0) {
    if (slice_rows != 0) return (int)cudaErrorInvalidValue;
    return (int)launch_bwd<float>(x, dout, p, dx, nb, ab, dyb, dab, vp, wp, dv, g1, g2, rows, c,
                                  f, eps, grid, dp, st);
  }
  if (dtype == 1)
    return (int)ffn::launch_bwd(x, dout, p, dx, nb, ab, dyb, dab, vp, wp, dv, g1, g2, rows, c, f,
                                eps, grid, slice_rows, dp, st);
  return (int)cudaErrorInvalidValue;
}
