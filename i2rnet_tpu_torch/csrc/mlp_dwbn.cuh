// The body of Kernels F and G (HRFormer MlpDWBN, BatchNorms folded) for one
// (output tile, person) item, shared by Kernels F and G (mlp_dwbn.cu) and
// phase 2 of kernel 7 (full_block.cu), as JAX's _mlp_math serves both of its
// kernels: a change to the arithmetic reaches all three. mlp_dwbn.cu
// describes what it computes and its design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kDC = 32;  // hidden channels per chunk: one per lane
constexpr int kPix = 4;  // pixels per warp step of the products
constexpr size_t kTwoPerSm = 113 * 1024;  // shared memory that still fits two blocks per SM

// GELU with erf(x / sqrt 2) = tanh(x (c0 + x^2 (c1 + ...))) (_gelu_tanh_erf)
__device__ __forceinline__ float gelu_tanh_erf(float x) {
  const float z = x * x;
  const float p = x * (7.978695036392e-01f +
                       z * (3.639282100698e-02f +
                            z * (-8.813181379539e-05f +
                                 z * (-3.663829767474e-05f + z * 1.422091515310e-06f))));
  return 0.5f * x * (1.f + tanhf(p));
}

// GELU with the Abramowitz & Stegun 7.1.26 erf (_gelu_exact)
__device__ __forceinline__ float gelu_exact(float x) {
  const float u = x * 0.7071067811865476f;
  const float au = fabsf(u);
  const float t = 1.f / (1.f + 0.3275911f * au);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * expf(-au * au);
  const float erf = u > 0.f ? e : (u < 0.f ? -e : 0.f);
  return 0.5f * x * (1.f + erf);
}

// F rounds to T at its stages and uses the tanh form; G stays in f32
template <typename T, bool kBlock> __device__ __forceinline__ float stage(float x) {
  if (kBlock) return to_f32(from_f32<T>(gelu_tanh_erf(x)));
  return gelu_exact(x);
}

template <typename T>
size_t mlp_smem_bytes(int c, int th, int tw) {
  const size_t npix = (size_t)(th + 2) * (tw + 2), nout = (size_t)th * tw;
  return sizeof(float) * (npix * kDC + nout * kDC + nout * c) + sizeof(T) * npix * c;
}

// the output tile: 8x8, or 4x4 where 8x8's shared memory would hold one block per SM
template <typename T>
int mlp_tile(int c) {
  return mlp_smem_bytes<T>(c, 8, 8) > kTwoPerSm ? 4 : 8;
}

// Output tile `tile` (row-major over ceil(h/th) x ceil(w/tw) tiles) of person
// `person`: reads the tile and its 1-pixel halo of x, writes the tile's
// pixels of out. T: activation type of x and out; W: weight type (T for F,
// float for G). x carries no __restrict__: in kernel 7 it is the map that
// phase 1 of the same launch wrote, which the read-only (non-coherent) load
// path must not serve. All threads of the block call it; it starts by
// writing shared memory, so a block running several items syncs between them.
template <typename T, typename W, bool kBlock>
__device__ __forceinline__ void mlp_item(
    const T* x, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    const W* __restrict__ w1t, const float* __restrict__ b1, const float* __restrict__ dwt,
    const float* __restrict__ bdw, const W* __restrict__ w2t, const float* __restrict__ b2,
    T* out, int h, int w, int c, int dh, float eps, int th, int tw, int tile, int person,
    unsigned char* smem_raw) {
  const int hw = th + 2, ww = tw + 2, npix = hw * ww, nout = th * tw;
  float* hid = reinterpret_cast<float*>(smem_raw);  // [npix][kDC]: the expanded chunk, tile + halo
  float* hdw = hid + npix * kDC;  // [nout][kDC]: after the depthwise conv
  float* acc = hdw + nout * kDC;  // [nout][c]: the contract's f32 sums
  T* ys = reinterpret_cast<T*>(acc + (size_t)nout * c);  // [npix][c]: the expand's input

  const int tiles_w = (w + tw - 1) / tw;
  const int oy = (tile / tiles_w) * th, ox = (tile % tiles_w) * tw;
  const size_t map = (size_t)h * w * c;
  const T* xp = x + (size_t)person * map;
  T* op = out + (size_t)person * map;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float fc = (float)c;

  // the expand's input for tile + halo: T(LN2(x)) for F, x for G; 0 off the map
  for (int pix = warp; pix < npix; pix += kWarps) {
    const int r = oy - 1 + pix / ww, q = ox - 1 + pix % ww;
    T* yr = ys + (size_t)pix * c;
    if (r < 0 || r >= h || q < 0 || q >= w) {
      for (int i = lane; i < c; i += 32) yr[i] = from_f32<T>(0.f);
      continue;
    }
    const T* xr = xp + ((size_t)r * w + q) * c;
    if (kBlock) {
      float sum = 0.f;
      for (int i = lane; i < c; i += 32) sum += to_f32(xr[i]);
      const float mean = warp_sum(sum) / fc;
      float sq = 0.f;
      for (int i = lane; i < c; i += 32) {
        const float dl = to_f32(xr[i]) - mean;
        sq += dl * dl;
      }
      const float rstd = rsqrtf(warp_sum(sq) / fc + eps);
      for (int i = lane; i < c; i += 32)
        yr[i] = from_f32<T>((to_f32(xr[i]) - mean) * rstd * ln_g[i] + ln_b[i]);
    } else {
      for (int i = lane; i < c; i += 32) yr[i] = xr[i];
    }
  }
  for (int i = tid; i < nout * c; i += kThreads) acc[i] = 0.f;

  for (int d0 = 0; d0 < dh; d0 += kDC) {
    const int dc = min(kDC, dh - d0);
    __syncthreads();  // ys ready / the previous chunk's hdw consumed
    // 1x1 expand: lane = hidden channel, a warp per kPix pixels at a time
    for (int p0 = warp * kPix; p0 < npix; p0 += kWarps * kPix) {
      float a[kPix];
#pragma unroll
      for (int i = 0; i < kPix; ++i) a[i] = 0.f;
      if (lane < dc) {
        for (int k = 0; k < c; ++k) {
          const float wv = to_f32(w1t[(size_t)k * dh + d0 + lane]);
#pragma unroll
          for (int i = 0; i < kPix; ++i)
            if (p0 + i < npix) a[i] += to_f32(ys[(size_t)(p0 + i) * c + k]) * wv;
        }
      }
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int pix = p0 + i;
        if (pix >= npix) break;
        const int r = oy - 1 + pix / ww, q = ox - 1 + pix % ww;
        const bool inside = r >= 0 && r < h && q >= 0 && q < w && lane < dc;
        hid[pix * kDC + lane] = inside ? stage<T, kBlock>(a[i] + b1[d0 + lane]) : 0.f;
      }
    }
    __syncthreads();
    // depthwise 3x3 on the tile, f32 taps, zero border
    for (int i = tid; i < nout * kDC; i += kThreads) {
      const int o = i / kDC, j = i % kDC;
      float v = 0.f;
      if (j < dc) {
        const int ty = o / tw, tx = o % tw;
        float s = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            s += hid[((ty + dy) * ww + tx + dx) * kDC + j] * dwt[(dy * 3 + dx) * dh + d0 + j];
        v = stage<T, kBlock>(s + bdw[d0 + j]);
      }
      hdw[i] = v;
    }
    __syncthreads();
    // this chunk's share of the 1x1 contract into acc: lane = output channel
    for (int o0 = warp * kPix; o0 < nout; o0 += kWarps * kPix) {
      for (int col = lane; col < c; col += 32) {
        float a[kPix];
#pragma unroll
        for (int i = 0; i < kPix; ++i) a[i] = o0 + i < nout ? acc[(o0 + i) * c + col] : 0.f;
        for (int j = 0; j < dc; ++j) {
          const float wv = to_f32(w2t[(size_t)(d0 + j) * c + col]);
#pragma unroll
          for (int i = 0; i < kPix; ++i)
            if (o0 + i < nout) a[i] += hdw[(o0 + i) * kDC + j] * wv;
        }
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          if (o0 + i < nout) acc[(o0 + i) * c + col] = a[i];
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nout * c; i += kThreads) {
    const int o = i / c, col = i % c;
    const int r = oy + o / tw, q = ox + o % tw;
    if (r >= h || q >= w) continue;
    const size_t off = ((size_t)r * w + q) * c + col;
    const float v = stage<T, kBlock>(acc[i] + b2[col]);
    op[off] = kBlock ? from_f32<T>(to_f32(xp[off]) + v) : from_f32<T>(v);
  }
}

}  // namespace
