// HRFormer MlpDWBN, forward (eval, BatchNorms folded), for Hopper (sm_90a):
// two kernels from one template.
//
// Replaces: i2rnet_tpu/ops/pallas/hrformer_block.py::mlp_block_fused
//   (Kernel F, entry i2r_mlp_block_fwd), and
// Replaces: i2rnet_tpu/ops/pallas/mlp_dwbn.py::mlp_dwbn_fused
//   (Kernel G, entry i2r_mlp_dwbn_fwd).
//
// Computes, per person on a [H, W, C] map with hidden width D = 4C,
//   F: x + T(g(T(g(dw3x3(T(g(T(LN2(x)) . W1 + b1))) + bdw)) . W2 + b2))
//      with T the activation type, weights in T, the tanh-form GELU g
//      (_gelu_tanh_erf) and the rounding points of _mlp_math (:158-185);
//   G: T(g(g(dw3x3(g(x . W1 + b1)) + bdw) . W2 + b2)) with x, weights and the
//      hidden map in f32, the Abramowitz-Stegun erf GELU g (_gelu_exact) and
//      one cast at the end (mlp_dwbn.py:73-95).
// The depthwise 3x3 reads a zero border around the H x W hidden map (zero,
// not g(b1), outside the map); its nine taps are f32, summed in (dy, dx)
// row-major order.
//
// What bounds it on the H100: per person at branch 0 of a 256x192 input
// (64x48x78, D = 312) the products are 2*3072*78*312*2 + 2*9*3072*312 =
// 0.32 GFLOP against 2*3072*78*2 B = 0.96 MB of bf16 map I/O: 0.32 us at the
// bf16 tensor-core peak, 0.29 us at the memory rate -- balanced. This kernel
// runs the products on CUDA cores in f32, so the FMA rate and the L1 and
// shared-memory reads that feed it bound it.
//
// Design: one block of 256 threads per (output tile of TH x TW pixels,
// person); the wrapper-side launcher picks 8x8, or 4x4 where 8x8's shared
// memory would hold one block per SM. The block loads the tile and its
// 1-pixel halo, LN'd (F) or as is (G), into shared memory, then walks the D
// hidden channels in chunks of 32: the 1x1 expand for tile + halo (a lane per
// hidden channel, a warp per 4 pixels, W1 read through L1), GELU and
// rounding; the depthwise 3x3 on the tile, GELU and rounding; and the
// chunk's share of the 1x1 contract added into an f32 [TH*TW, C]
// accumulator in shared memory. So the hidden map never leaves the block and
// never has to fit whole (2496 channels at 384x288's branch 3). Last: bias,
// GELU, rounding, residual (F), and the store of the pixels inside the map.
// tanhf, not tanh.approx.f32, whose error would show in the f32 checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDC = 32;  // hidden channels per chunk: one per lane
constexpr int kPix = 4;  // pixels per warp step of the products
constexpr size_t kMaxSmem = 232448;
constexpr size_t kTwoPerSm = 113 * 1024;  // shared memory that still fits two blocks per SM

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

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
size_t smem_bytes(int c, int th, int tw) {
  const size_t npix = (size_t)(th + 2) * (tw + 2), nout = (size_t)th * tw;
  return sizeof(float) * (npix * kDC + nout * kDC + nout * c) + sizeof(T) * npix * c;
}

// T: activation type of x and out; W: weight type (T for F, float for G)
template <typename T, typename W, bool kBlock>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
           const float* __restrict__ ln_b, const W* __restrict__ w1t,
           const float* __restrict__ b1, const float* __restrict__ dwt,
           const float* __restrict__ bdw, const W* __restrict__ w2t,
           const float* __restrict__ b2, T* __restrict__ out, int h, int w, int c, int dh,
           float eps, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hw = th + 2, ww = tw + 2, npix = hw * ww, nout = th * tw;
  float* hid = reinterpret_cast<float*>(smem_raw);  // [npix][kDC]: the expanded chunk, tile + halo
  float* hdw = hid + npix * kDC;  // [nout][kDC]: after the depthwise conv
  float* acc = hdw + nout * kDC;  // [nout][c]: the contract's f32 sums
  T* ys = reinterpret_cast<T*>(acc + (size_t)nout * c);  // [npix][c]: the expand's input

  const int tiles_w = (w + tw - 1) / tw;
  const int oy = (blockIdx.x / tiles_w) * th, ox = (blockIdx.x % tiles_w) * tw;
  const size_t map = (size_t)h * w * c;
  const T* xp = x + (size_t)blockIdx.y * map;
  T* op = out + (size_t)blockIdx.y * map;
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

template <typename T, typename W, bool kBlock>
cudaError_t launch(const void* x, const void* ln_g, const void* ln_b, const void* w1t,
                   const void* b1, const void* dwt, const void* bdw, const void* w2t,
                   const void* b2, void* out, int p, int h, int w, int c, int dh, float eps,
                   cudaStream_t stream) {
  int th = 8, tw = 8;
  if (smem_bytes<T>(c, th, tw) > kTwoPerSm) th = tw = 4;
  const size_t bytes = smem_bytes<T>(c, th, tw);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<T, W, kBlock>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + th - 1) / th) * ((w + tw - 1) / tw), p);
  mlp_kernel<T, W, kBlock><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const W*>(w1t), static_cast<const float*>(b1), static_cast<const float*>(dwt),
      static_cast<const float*>(bdw), static_cast<const W*>(w2t), static_cast<const float*>(b2),
      static_cast<T*>(out), h, w, c, dh, eps, th, tw);
  return cudaGetLastError();
}

bool bad_shape(int p, int h, int w, int c, int dh) {
  return p < 1 || p > 65535 || h < 1 || w < 1 || c < 1 || dh < 1;
}

}  // namespace

// Kernel F. x, out: [p, h, w, c] contiguous, type T (dtype 0 = float32,
// 1 = bfloat16); ln_g, ln_b [c] f32; w1t = W1^T [c][dh] and w2t = W2^T [dh][c]
// in T; dwt [3][3][dh], b1 [dh], bdw [dh], b2 [c] f32. Returns the cudaError_t.
extern "C" int i2r_mlp_block_fwd(const void* x, const void* ln_g, const void* ln_b,
                                 const void* w1t, const void* b1, const void* dwt,
                                 const void* bdw, const void* w2t, const void* b2, void* out,
                                 int p, int h, int w, int c, int dh, float eps, int dtype,
                                 void* stream) {
  if (bad_shape(p, h, w, c, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float, float, true>(x, ln_g, ln_b, w1t, b1, dwt, bdw, w2t, b2, out, p, h, w, c,
                                     dh, eps, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16, true>(x, ln_g, ln_b, w1t, b1, dwt, bdw, w2t, b2,
                                                     out, p, h, w, c, dh, eps, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Kernel G. As Kernel F without LN and residual; every weight f32.
extern "C" int i2r_mlp_dwbn_fwd(const void* x, const void* w1t, const void* b1, const void* dwt,
                                const void* bdw, const void* w2t, const void* b2, void* out,
                                int p, int h, int w, int c, int dh, int dtype, void* stream) {
  if (bad_shape(p, h, w, c, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float, float, false>(x, nullptr, nullptr, w1t, b1, dwt, bdw, w2t, b2, out, p, h,
                                      w, c, dh, 0.f, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, float, false>(x, nullptr, nullptr, w1t, b1, dwt, bdw, w2t, b2,
                                              out, p, h, w, c, dh, 0.f, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
