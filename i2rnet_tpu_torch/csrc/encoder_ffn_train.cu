// Post-norm DETR encoder FFN tail with both dropouts, training forward and
// backward, for Hopper (sm_90a).
//
// Replaces: i2rnet_tpu/ops/pallas/encoder_ffn_train.py::encoder_ffn_train.
//
// Computes, per token row x of width C (F hidden units),
//     n   = LN1(x)                              (f32 statistics, eps)
//     h   = T(n) . W1^T + b1                    (f32 accumulation)
//     a   = T(drop1(relu(h)))                   (drop: keep ? v / (1 - rate) : 0)
//     y   = drop2(a . W2^T + b2)
//     out = T(LN2(n + y))                       (residual on the f32 n)
// with T() the activation type, the casting points of encoder_ffn_train.py:
// 84-119, and the backward dx plus the eight parameter gradients (LN1 and LN2
// scale and bias, W1, b1, W2, b2) in f32, recomputing the forward per row as
// encoder_ffn_train.py:132-188 does.
//
// What bounds it on the H100: at the main-path shape (rows = 8*1344 = 10752,
// C = 96, F = 192) the forward's products are 0.79 GFLOP and the backward's
// 2.4 GFLOP, against 4 MB of activations in bf16. Every row rereads all of
// W1 and W2, so what bounds these simple kernels is shared-memory bandwidth;
// the [R, F] hidden activations are what the fusion keeps out of device
// memory in the forward.
//
// Design:
// * W1 [F][C] and W2 [C][F] (torch layout) sit in dynamic shared memory as
//   f32 with an odd row stride (C+1, F+1): the lanes of a warp read a column
//   (forward: lane = output unit) or a row (backward: lane = input unit)
//   without bank conflicts, from one copy (149 KB at C=96, F=192);
// * one warp per row, as encoder_ffn.cu: LayerNorms with warp shuffles, the
//   products with one output per lane and the row's vectors in a per-warp
//   shared scratch, so any C and F whose weights fit are taken;
// * dropout bits: explicit [R, F] and [R, C] uint32 tensors (tests, parity),
//   or Philox4x32-10 (philox.cuh) keyed by (seed, offset) for the first site
//   and (seed, offset + 1) for the second, counted by (column, row); the
//   backward regenerates them;
// * parameter gradients without atomics: the row kernel writes the rounded
//   operands of the two weight products (T(n), T(a), T(dy), T(da)) and each
//   block's f32 partial sums of the six vector gradients; dW = sum over rows
//   of an outer product is then a hand-written tiled reduction over row
//   slices with per-slice partials, and a last kernel adds the partials in a
//   fixed order. Deterministic on a given grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

struct Dropout {
  const uint32_t* bits1;  // [rows, f] (mode 1)
  const uint32_t* bits2;  // [rows, c] (mode 1)
  uint32_t seed, offset, threshold;
  float inv;              // 1 / (1 - rate)
  int mode;               // 0 none, 1 bits, 2 seed
};

// v after dropout site `site` (1: [rows, f] after the ReLU, 2: [rows, c] after linear2)
__device__ __forceinline__ float drop(const Dropout& dp, int site, float v, int r, int col,
                                      int width) {
  if (dp.mode == 0) return v;
  const uint32_t u =
      dp.mode == 1 ? (site == 1 ? dp.bits1 : dp.bits2)[(size_t)r * width + col]
                   : i2r::philox_word0(dp.seed, dp.offset + (uint32_t)(site - 1), (uint32_t)col,
                                       (uint32_t)r, 0u);
  return u < dp.threshold ? 0.f : v * dp.inv;
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

struct Params {
  const float *ln1_w, *ln1_b, *w1, *b1, *w2, *b2, *ln2_w, *ln2_b;
};

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

}  // namespace

// x, out: [rows, c] contiguous, type T (dtype 0 = float32, 1 = bfloat16). w1: [f, c]
// and w2: [c, f] (torch Linear layout), b1 [f], b2 [c] and the LayerNorms' scales
// and biases [c], all float32 (the weights already rounded to T). Dropout mode
// 0 = none, 1 = bits (bits1 [rows, f], bits2 [rows, c] uint32), 2 = Philox from
// (seed, offset) and (seed, offset + 1); dropped where bits < threshold,
// survivors scaled by inv. grid: the number of blocks walking the rows.
// Returns the cudaError_t of the launch.
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
  if (dtype == 1) return (int)launch_fwd<__nv_bfloat16>(x, p, out, rows, c, f, eps, grid, dp, st);
  return (int)cudaErrorInvalidValue;
}

// dout, dx: [rows, c] of type T. Scratch of type T: nb, dyb [rows, c]; ab, dab
// [rows, f]. Float32 scratch: vec_part [grid, 5c + f], w_part [16, f, c].
// Outputs (float32): d_vec [5c + f] = (dln1_w, dln1_b, db1, db2, dln2_w,
// dln2_b), dw1 [f, c], dw2 [c, f]. Other arguments as the forward.
extern "C" int i2r_ffn_train_bwd(const void* x, const void* dout, const void* ln1_w,
                                 const void* ln1_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* ln2_w,
                                 const void* ln2_b, void* dx, void* nb, void* ab, void* dyb,
                                 void* dab, void* vec_part, void* w_part, void* d_vec, void* dw1,
                                 void* dw2, int rows, int c, int f, float eps, int dtype,
                                 int grid, const void* bits1, const void* bits2, unsigned seed,
                                 unsigned offset, unsigned threshold, float inv, int mode,
                                 void* stream) {
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
  if (dtype == 0)
    return (int)launch_bwd<float>(x, dout, p, dx, nb, ab, dyb, dab, vp, wp, dv, g1, g2, rows, c,
                                  f, eps, grid, dp, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, dout, p, dx, nb, ab, dyb, dab, vp, wp, dv, g1, g2,
                                          rows, c, f, eps, grid, dp, st);
  return (int)cudaErrorInvalidValue;
}
