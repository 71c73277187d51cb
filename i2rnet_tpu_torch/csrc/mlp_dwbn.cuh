// The bodies of Kernels F and G (HRFormer MlpDWBN, BatchNorms folded), shared
// by Kernels F and G (mlp_dwbn.cu) and phases 2-3 of kernel 7 (full_block.cu),
// as JAX's _mlp_math serves both of its kernels: a change to the arithmetic
// reaches all three. Three bodies: mlp_item, the CUDA-core template of F's
// and kernel 7's f32 instances (one (output tile, person) item);
// mlp_item_mma, F's bf16 body on the tensor cores (one (output tile, hidden
// slice, person) item), whose slices mlp_finish sums; and mlp_item_tf32x3,
// G's body on the tensor cores in three TF32 passes (the same walk, f32
// buffers), whose slices mlp32_finish sums. mlp_dwbn.cu describes what they
// compute and their design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_mma.cuh"
#include "common.cuh"

namespace {

constexpr int kDC = 32;  // hidden channels per chunk: one per lane
constexpr int kPix = 4;  // pixels per warp step of the products
constexpr size_t kTwoPerSm = 113 * 1024;  // shared memory that still fits two blocks per SM
// the bf16 body (ops/cuda/mlp_dwbn.py's plan takes kHC, kMaxTw, kTwoPerSm and
// kMaxSmem; tests/test_torch_mlp_tiles.py reads them here)
constexpr int kHC = 64;        // hidden channels per chunk: one 8-channel n-tile per warp
constexpr int kHLd = kHC + 8;  // row stride (bf16) of the chunk buffer
constexpr int kBoxTiles = 7;   // 16-row tiles of tile + halo: at most 112 pixels
constexpr int kOutTiles = 4;   // 16-row tiles of the output tile: at most 64 pixels
constexpr int kMaxTw = 8;      // output tile width
constexpr int kRing = 4;       // W1 fragments a warp keeps in flight from L2
constexpr int kGroup = 4;      // output tiles a warp contracts at a time
static_assert(kHC == 8 * kWarps, "the expand gives each warp one 8-channel n-tile of a chunk");
// G's body (ops/cuda/mlp_dwbn.py's mlp32_plan takes kPad32 with the bf16
// body's kHC, kMaxTw, kBoxTiles, kOutTiles and limits; tests/test_torch_mlp32_tiles.py
// reads them here)
constexpr int kPad32 = 4;   // row padding (floats) of its f32 buffers: a row stride of 4 mod 8
                            // words puts the 32 loads of an A fragment in 32 banks
constexpr int kHLd32 = kHC + kPad32;  // row stride (floats) of its chunk buffer
constexpr int kCGroup = 4;  // output-channel n-tiles a warp contracts on one A fragment

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

// F rounds to T at its stages and uses the tanh form
template <typename T> __device__ __forceinline__ float stage(float x) {
  return round_to<T>(gelu_tanh_erf(x));
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
// pixels of out. T: activation type of x, out and the weights (float: F's
// and kernel 7's f32 instances). x carries no __restrict__: in kernel 7 it is the map that
// phase 1 of the same launch wrote, which the read-only (non-coherent) load
// path must not serve. All threads of the block call it; it starts by
// writing shared memory, so a block running several items syncs between them.
template <typename T>
__device__ __forceinline__ void mlp_item(
    const T* x, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    const T* __restrict__ w1t, const float* __restrict__ b1, const float* __restrict__ dwt,
    const float* __restrict__ bdw, const T* __restrict__ w2t, const float* __restrict__ b2,
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

  // the expand's input for tile + halo: T(LN2(x)); 0 off the map
  for (int pix = warp; pix < npix; pix += kWarps) {
    const int r = oy - 1 + pix / ww, q = ox - 1 + pix % ww;
    T* yr = ys + (size_t)pix * c;
    if (r < 0 || r >= h || q < 0 || q >= w) {
      for (int i = lane; i < c; i += 32) yr[i] = from_f32<T>(0.f);
      continue;
    }
    const T* xr = xp + ((size_t)r * w + q) * c;
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
        hid[pix * kDC + lane] = inside ? stage<T>(a[i] + b1[d0 + lane]) : 0.f;
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
        v = stage<T>(s + bdw[d0 + j]);
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
    const float v = stage<T>(acc[i] + b2[col]);
    op[off] = from_f32<T>(to_f32(xp[off]) + v);
  }
}

// F's final value of one output element: residual + T(g(sum + b2))
template <typename T>
__device__ __forceinline__ T mlp_out(T x, float sum, float b2) {
  return from_f32<T>(to_f32(x) + round_to<T>(gelu_tanh_erf(sum + b2)));
}

// Shared memory of the bf16 body for width c, tile th x tw on an h x w map,
// dh hidden channels in `slices` slices: the expand's input (tile + halo,
// LN'd), the chunk's expanded hidden map, the slice after the depthwise conv
// (ops/cuda/mlp_dwbn.py::_mma_smem is the same sum).
inline size_t mlp_mma_smem_bytes(int c, int h, int w, int th, int tw, int dh, int slices) {
  const size_t box = amma::pad16((th + 2 < h ? th + 2 : h) * (tw + 2 < w ? tw + 2 : w));
  const int per = ((dh + kHC - 1) / kHC + slices - 1) / slices;  // chunks of the largest slice
  return sizeof(__nv_bfloat16) * (box * (amma::pad16(c) + 8) + box * kHLd +
                                  (size_t)amma::pad16(th * tw) * (per * kHC + 8));
}

// Whether the bf16 body takes this plan: tile + halo in kBoxTiles row tiles,
// the output tile in kOutTiles, at least one chunk a slice, shared memory.
inline bool mlp_mma_fits(int c, int h, int w, int th, int tw, int dh, int slices) {
  const int box = (th + 2 < h ? th + 2 : h) * (tw + 2 < w ? tw + 2 : w);
  return th >= 1 && tw >= 1 && tw <= kMaxTw && amma::pad16(box) <= 16 * kBoxTiles &&
         amma::pad16(th * tw) <= 16 * kOutTiles && slices >= 1 &&
         slices <= (dh + kHC - 1) / kHC &&
         mlp_mma_smem_bytes(c, h, w, th, tw, dh, slices) <= kMaxSmem;
}

// F in bf16 for one item: output tile `tile` (row-major over ceil(h/th) x
// ceil(w/tw) tiles), hidden slice `slice` of `slices` (slice s takes the
// 64-channel chunks [s n / S, (s + 1) n / S) of n = ceil(dh / 64)), person
// `person`. w1f, w2f: W1 [dh][c] and W2 [c][dh] as mma B-operand fragments
// (ops/cuda/mlp_dwbn.py::pack_fragments): for n-tile j and k-step kk, lane l
// holds M[8j + l/4][16kk + 2(l%4) + {0, 1, 8, 9}] as bf16 pairs, zero past
// the matrix, W1's n padded to a multiple of 64, W2's k too. With one slice
// it writes the tile's pixels of out; with several, the tile's f32 sums of
// the contract to part [slices][p][h][w][c], which mlp_finish completes.
// x carries no __restrict__ (kernel 7: written earlier in the launch). All
// threads of the block call it; it starts by writing shared memory.
__device__ __forceinline__ void mlp_item_mma(
    const __nv_bfloat16* x, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    const uint2* __restrict__ w1f, const float* __restrict__ b1, const float* __restrict__ dwt,
    const float* __restrict__ bdw, const uint2* __restrict__ w2f, const float* __restrict__ b2,
    __nv_bfloat16* out, float* part, int p, int h, int w, int c, int dh, float eps, int th,
    int tw, int slices, int tile, int slice, int person, unsigned char* smem_raw) {
  using bf16 = __nv_bfloat16;
  const int tiles_w = (w + tw - 1) / tw;
  const int oy = (tile / tiles_w) * th, ox = (tile % tiles_w) * tw;
  // the box: tile + 1-pixel halo, cut to the map (off the map the hidden map is 0)
  const int br0 = max(oy - 1, 0), bq0 = max(ox - 1, 0);
  const int bw = min(ox + tw, w - 1) - bq0 + 1;
  const int box = (min(oy + th, h - 1) - br0 + 1) * bw;
  const int mte = (box + 15) / 16, nout = th * tw, mtc = (nout + 15) / 16;
  const int cp = amma::pad16(c), ldy = cp + 8, ks1 = cp / 16;
  const int nchunk = (dh + kHC - 1) / kHC, ks2 = nchunk * (kHC / 16);
  const int ch0 = slice * nchunk / slices, ch1 = (slice + 1) * nchunk / slices;
  const int sld = (ch1 - ch0) * kHC + 8;
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);  // [16 mte][ldy]: T(LN2(x)) of the box
  bf16* hid = ys + (size_t)mte * 16 * ldy;       // [16 mte][kHLd]: the chunk, expanded
  bf16* hds = hid + (size_t)mte * 16 * kHLd;     // [16 mtc][sld]: the slice after the conv
  const size_t map = (size_t)h * w * c;
  const bf16* xp = x + (size_t)person * map;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const bf16 zero = from_f32<bf16>(0.f);
  const float fc = (float)c;

  // the box's rows of x into ys, every thread's loads in flight at once
  if (c % 2 == 0) {
    const int half = c / 2;
#pragma unroll 4
    for (int e = tid; e < box * half; e += kThreads) {
      const int j = e / half, i = 2 * (e % half);
      *reinterpret_cast<uint32_t*>(ys + j * ldy + i) = *reinterpret_cast<const uint32_t*>(
          xp + ((size_t)(br0 + j / bw) * w + bq0 + j % bw) * c + i);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < box * c; e += kThreads) {
      const int j = e / c, i = e % c;
      ys[j * ldy + i] = xp[((size_t)(br0 + j / bw) * w + bq0 + j % bw) * c + i];
    }
  }
  // the slice buffer's padding rows stay 0
  for (int i = tid; i < (mtc * 16 - nout) * sld; i += kThreads) hds[nout * sld + i] = zero;
  __syncthreads();
  // LN2 in place, a warp per row; rows past the box and channels past c are 0
  for (int j = warp; j < mte * 16; j += kWarps) {
    bf16* yr = ys + (size_t)j * ldy;
    if (j >= box) {
      for (int i = lane; i < cp; i += 32) yr[i] = zero;
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
    for (int i = lane; i < cp; i += 32)
      yr[i] = i < c ? from_f32<bf16>((to_f32(yr[i]) - mean) * rstd * ln_g[i] + ln_b[i]) : zero;
  }

  uint2 ring[kRing];
  for (int ch = ch0; ch < ch1; ++ch) {
    const int d0 = ch * kHC;
    // the expand's first W1 fragments and b1, loaded while the block meets at the barrier
    const uint2* wp = w1f + (size_t)(ch * kWarps + warp) * ks1 * 32 + lane;
#pragma unroll
    for (int u = 0; u < kRing; ++u) ring[u] = u < ks1 ? __ldg(wp + u * 32) : make_uint2(0u, 0u);
    const int ecol = warp * 8 + c2, ed = d0 + ecol;
    const float eb0 = ed < dh ? b1[ed] : 0.f, eb1 = ed + 1 < dh ? b1[ed + 1] : 0.f;
    __syncthreads();  // ys ready / the previous chunk's hid consumed
    {
      // 1x1 expand of the box on mma.sync: this warp's 8 hidden channels, every
      // row tile; W1's fragments kRing k-steps ahead
      float e[kBoxTiles][4];
#pragma unroll
      for (int mt = 0; mt < kBoxTiles; ++mt) e[mt][0] = e[mt][1] = e[mt][2] = e[mt][3] = 0.f;
      for (int k0 = 0; k0 < ks1; k0 += kRing) {
#pragma unroll
        for (int u = 0; u < kRing; ++u) {
          const int kk = k0 + u;
          if (kk < ks1) {
            const uint2 b = ring[u];
            if (kk + kRing < ks1) ring[u] = __ldg(wp + (size_t)(kk + kRing) * 32);
#pragma unroll
            for (int mt = 0; mt < kBoxTiles; ++mt) {
              if (mt < mte) {
                uint32_t a[4];
                amma::ldsm_x4(a, ys + amma::a_off(lane, mt * 16, kk * 16, ldy));
                amma::mma(e[mt], a, b.x, b.y);
              }
            }
          }
        }
      }
      // + b1, GELU, rounding (pack); hidden channels past dh have zero weights: g(0) = 0
#pragma unroll
      for (int mt = 0; mt < kBoxTiles; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + 8 * half;
          if (mt < mte && r < box)
            *reinterpret_cast<uint32_t*>(hid + r * kHLd + ecol) =
                amma::pack(gelu_tanh_erf(e[mt][2 * half] + eb0),
                           gelu_tanh_erf(e[mt][2 * half + 1] + eb1));
        }
      }
    }
    __syncthreads();
    // depthwise 3x3 on the tile into the slice buffer: a thread per (tile row,
    // channel pair), f32 taps in (dy, dx) order, zero outside the map (a zero
    // tap adds exactly 0, as a skipped one); a 3x3 window of the rounded
    // hidden values slides along the row. + bdw, GELU, rounding
    for (int item = tid; item < th * (kHC / 2); item += kThreads) {
      const int ty = item / (kHC / 2), col = 2 * (item % (kHC / 2)), d = d0 + col;
      float t0[9], t1[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        t0[k] = d < dh ? dwt[k * dh + d] : 0.f;
        t1[k] = d + 1 < dh ? dwt[k * dh + d + 1] : 0.f;
      }
      const float bias0 = d < dh ? bdw[d] : 0.f, bias1 = d + 1 < dh ? bdw[d + 1] : 0.f;
      const int r = oy + ty;
      bf16* dst = hds + (size_t)ty * tw * sld + (ch - ch0) * kHC + col;
      float2 win[3][3];  // [column q - 1, q, q + 1][row r - 1, r, r + 1]
      auto load_col = [&](int qq, float2(&v)[3]) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int rr = r + dy - 1;
          v[dy] = make_float2(0.f, 0.f);
          if (rr >= 0 && rr < h && qq >= 0 && qq < w) {
            const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(
                hid + ((rr - br0) * bw + qq - bq0) * kHLd + col);
            v[dy] = make_float2(__low2float(hv), __high2float(hv));
          }
        }
      };
      load_col(ox - 1, win[0]);
      load_col(ox, win[1]);
      // the row's sums first, then its GELUs: independent chains
      float s0[kMaxTw], s1[kMaxTw];
#pragma unroll
      for (int tx = 0; tx < kMaxTw; ++tx) {
        if (tx < tw) {
          load_col(ox + tx + 1, win[2]);
          s0[tx] = s1[tx] = 0.f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              s0[tx] += win[dx][dy].x * t0[dy * 3 + dx];
              s1[tx] += win[dx][dy].y * t1[dy * 3 + dx];
            }
          }
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            win[0][dy] = win[1][dy];
            win[1][dy] = win[2][dy];
          }
        }
      }
#pragma unroll
      for (int tx = 0; tx < kMaxTw; ++tx) {
        if (tx < tw)  // pixels of a ragged tile past the map: 0
          *reinterpret_cast<uint32_t*>(dst + (size_t)tx * sld) =
              r < h && ox + tx < w ? amma::pack(gelu_tanh_erf(s0[tx] + bias0),
                                                gelu_tanh_erf(s1[tx] + bias1))
                                   : 0u;
      }
    }
  }
  __syncthreads();  // the slice's conv output complete

  // the 1x1 contract of the slice on mma.sync: the 16 x 8 output tiles (row
  // tile t % mtc, output-channel tile t / mtc) go round-robin to the warps,
  // kGroup at a time, each over the slice's k-steps with its own W2
  // fragments one k-step ahead; then out (one slice) or the slice's partial
  // sums for the tile's pixels inside the map
  const int ks = (ch1 - ch0) * (kHC / 16), ntiles = mtc * (cp / 8);
  for (int t0 = warp; t0 < ntiles; t0 += kWarps * kGroup) {
    float acc[kGroup][4];
    const uint2* wp[kGroup];
    int row[kGroup];
    uint2 b[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int t = t0 + kWarps * j < ntiles ? t0 + kWarps * j : t0;
      row[j] = (t % mtc) * 16;
      wp[j] = w2f + ((size_t)(t / mtc) * ks2 + ch0 * (kHC / 16)) * 32 + lane;
      b[j] = __ldg(wp[j]);
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    for (int kk = 0; kk < ks; ++kk) {
      uint2 next[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) next[j] = kk + 1 < ks ? __ldg(wp[j] + (kk + 1) * 32) : b[j];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (t0 + kWarps * j < ntiles) {
          uint32_t a[4];
          amma::ldsm_x4(a, hds + amma::a_off(lane, row[j], kk * 16, sld));
          amma::mma(acc[j], a, b[j].x, b[j].y);
        }
        b[j] = next[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int t = t0 + kWarps * j;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = (t % mtc) * 16 + g + 8 * (k >> 1), col = (t / mtc) * 8 + c2 + (k & 1);
        const int r = oy + o / tw, q = ox + o % tw;
        if (t >= ntiles || o >= nout || col >= c || r >= h || q >= w) continue;
        const size_t off = ((size_t)r * w + q) * c + col;
        if (slices == 1)
          out[(size_t)person * map + off] = mlp_out(xp[off], acc[j][k], b2[col]);
        else
          part[((size_t)slice * p + person) * map + off] = acc[j][k];
      }
    }
  }
}

// The slices' sums of element i of [n] = [p, h, w, c], added in the order
// s = 0 ... slices - 1, then F's last stage. x, part: plain loads (kernel 7
// wrote them earlier in the launch).
template <typename T>
__device__ __forceinline__ void mlp_finish(const T* x, const float* part,
                                           const float* __restrict__ b2, T* out, size_t n, int c,
                                           int slices, size_t i) {
  float sum = part[i];
  for (int s = 1; s < slices; ++s) sum += part[(size_t)s * n + i];
  out[i] = mlp_out(x[i], sum, b2[i % c]);
}

// ---- Kernel G's body: both products on the tensor cores in three TF32 passes ----

__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero
// (cvt.rna), as f32 bits with the 13 low mantissa bits cleared: the
// instruction leaves them unspecified, and hi is used as an f32 value in a - hi
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// d += a . b: A 16x8 (row), B 8x8 (col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A operand of rows r0..r0+15, columns k0..k0+7 of an f32 buffer of row
// stride ld, split as it is read: hi = tf32(a), lo = tf32(a - hi). Lane l
// holds rows l/4 and l/4 + 8 at columns l%4 and l%4 + 4 (registers 0-3:
// (row, column) = (l/4, l%4), (l/4 + 8, l%4), (l/4, l%4 + 4), (l/4 + 8, l%4 + 4)).
__device__ __forceinline__ void a_split(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* s,
                                        int r0, int k0, int ld, int lane) {
  const float* q = s + (r0 + (lane >> 2)) * ld + k0 + (lane & 3);
  const float v[4] = {q[0], q[8 * ld], q[4], q[8 * ld + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(v[i]);
    lo[i] = tf32_rna(v[i] - __uint_as_float(hi[i]));
  }
}

// d += a . b to about f32 accuracy, the small terms first: a_lo b_hi, a_hi
// b_lo, then a_hi b_hi (a_lo b_lo, below 2^-22 of the product, is left
// out); b = (hi of b0, b1, lo of b0, b1) as ops/cuda/mlp_dwbn.py::pack_tf32x3 packs it
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint4 b) {
  mma_tf32(d, lo, b.x, b.y);
  mma_tf32(d, hi, b.z, b.w);
  mma_tf32(d, hi, b.x, b.y);
}

// Shared memory of G's body for width c, tile th x tw on an h x w map, dh
// hidden channels in `slices` slices, all f32: x of the box (tile + halo cut
// to the map, channels padded to 8), the chunk's expanded hidden map, the
// slice after the depthwise conv (ops/cuda/mlp_dwbn.py::_mma32_smem is the same sum).
inline size_t mlp32_smem_bytes(int c, int h, int w, int th, int tw, int dh, int slices) {
  const size_t box = amma::pad16((th + 2 < h ? th + 2 : h) * (tw + 2 < w ? tw + 2 : w));
  const int per = ((dh + kHC - 1) / kHC + slices - 1) / slices;  // chunks of the largest slice
  return sizeof(float) * (box * (pad8(c) + kPad32) + box * kHLd32 +
                          (size_t)amma::pad16(th * tw) * (per * kHC + kPad32));
}

// Whether G's body takes this plan: as mlp_mma_fits, with its shared memory.
inline bool mlp32_fits(int c, int h, int w, int th, int tw, int dh, int slices) {
  const int box = (th + 2 < h ? th + 2 : h) * (tw + 2 < w ? tw + 2 : w);
  return th >= 1 && tw >= 1 && tw <= kMaxTw && amma::pad16(box) <= 16 * kBoxTiles &&
         amma::pad16(th * tw) <= 16 * kOutTiles && slices >= 1 &&
         slices <= (dh + kHC - 1) / kHC &&
         mlp32_smem_bytes(c, h, w, th, tw, dh, slices) <= kMaxSmem;
}

// G for one item, mlp_item_mma's walk in f32: output tile `tile` (row-major
// over ceil(h/th) x ceil(w/tw) tiles), hidden slice `slice` of `slices`
// (slice s takes the 64-channel chunks [s n / S, (s + 1) n / S) of n =
// ceil(dh / 64)), person `person`. x, out: [p, h, w, c] in T. w1f, w2f: W1
// [dh][c] and W2 [c][dh] as B-operand fragments of mma m16n8k8 in TF32
// (ops/cuda/mlp_dwbn.py::pack_tf32x3): for n-tile j and k-step kk, lane l
// holds the hi and lo parts of M[8j + l/4][8kk + l%4 + {0, 4}], zero past
// the matrix, W1's n padded to a multiple of 64 and its k to 8, W2's n to 8
// and its k to a multiple of 64. With one slice it writes the tile's pixels
// of out; with several, the tile's f32 sums of the contract to part
// [slices][p][h][w][c], which mlp32_finish completes. All threads of the
// block call it; it starts by writing shared memory.
template <typename T>
__device__ __forceinline__ void mlp_item_tf32x3(
    const T* __restrict__ x, const uint4* __restrict__ w1f, const float* __restrict__ b1,
    const float* __restrict__ dwt, const float* __restrict__ bdw, const uint4* __restrict__ w2f,
    const float* __restrict__ b2, T* __restrict__ out, float* __restrict__ part, int p, int h,
    int w, int c, int dh, int th, int tw, int slices, int tile, int slice, int person,
    unsigned char* smem_raw) {
  const int tiles_w = (w + tw - 1) / tw;
  const int oy = (tile / tiles_w) * th, ox = (tile % tiles_w) * tw;
  // the box: tile + 1-pixel halo, cut to the map (off the map the hidden map is 0)
  const int br0 = max(oy - 1, 0), bq0 = max(ox - 1, 0);
  const int bw = min(ox + tw, w - 1) - bq0 + 1;
  const int box = (min(oy + th, h - 1) - br0 + 1) * bw;
  const int mte = (box + 15) / 16, nout = th * tw, mtc = (nout + 15) / 16;
  const int c8 = pad8(c), ldy = c8 + kPad32, ks1 = c8 / 8;
  const int nchunk = (dh + kHC - 1) / kHC, ks2 = nchunk * (kHC / 8);
  const int ch0 = slice * nchunk / slices, ch1 = (slice + 1) * nchunk / slices;
  const int sld = (ch1 - ch0) * kHC + kPad32;
  float* ys = reinterpret_cast<float*>(smem_raw);  // [16 mte][ldy]: x of the box
  float* hid = ys + (size_t)mte * 16 * ldy;        // [16 mte][kHLd32]: the chunk, expanded
  float* hds = hid + (size_t)mte * 16 * kHLd32;    // [16 mtc][sld]: the slice after the conv
  const size_t map = (size_t)h * w * c;
  const T* xp = x + (size_t)person * map;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  // the box's rows of x into ys in f32, every thread's loads in flight at
  // once; channels past c and rows past the box 0 (zero products)
#pragma unroll 4
  for (int e = tid; e < box * c; e += kThreads) {
    const int j = e / c, i = e - j * c;
    ys[j * ldy + i] = to_f32(xp[((size_t)(br0 + j / bw) * w + bq0 + j % bw) * c + i]);
  }
  const int padc = c8 - c;
  for (int e = tid; e < box * padc; e += kThreads) ys[(e / padc) * ldy + c + e % padc] = 0.f;
  for (int e = tid; e < (mte * 16 - box) * c8; e += kThreads)
    ys[(box + e / c8) * ldy + e % c8] = 0.f;
  // the slice buffer's padding rows stay 0
  for (int i = tid; i < (mtc * 16 - nout) * sld; i += kThreads) hds[nout * sld + i] = 0.f;

  uint4 ring[kRing];
  for (int ch = ch0; ch < ch1; ++ch) {
    const int d0 = ch * kHC;
    // the expand's first W1 fragments and b1, loaded while the block meets at the barrier
    const uint4* wp = w1f + (size_t)(ch * kWarps + warp) * ks1 * 32 + lane;
#pragma unroll
    for (int u = 0; u < kRing; ++u)
      ring[u] = u < ks1 ? __ldg(wp + u * 32) : make_uint4(0u, 0u, 0u, 0u);
    const int ecol = warp * 8 + c2, ed = d0 + ecol;
    const float eb0 = ed < dh ? b1[ed] : 0.f, eb1 = ed + 1 < dh ? b1[ed + 1] : 0.f;
    __syncthreads();  // ys ready / the previous chunk's hid consumed
    {
      // 1x1 expand of the box: this warp's 8 hidden channels, every row tile,
      // A split as it is read; W1's fragments kRing k-steps ahead
      float e[kBoxTiles][4];
#pragma unroll
      for (int mt = 0; mt < kBoxTiles; ++mt) e[mt][0] = e[mt][1] = e[mt][2] = e[mt][3] = 0.f;
      for (int k0 = 0; k0 < ks1; k0 += kRing) {
#pragma unroll
        for (int u = 0; u < kRing; ++u) {
          const int kk = k0 + u;
          if (kk < ks1) {
            const uint4 b = ring[u];
            if (kk + kRing < ks1) ring[u] = __ldg(wp + (size_t)(kk + kRing) * 32);
#pragma unroll
            for (int mt = 0; mt < kBoxTiles; ++mt) {
              if (mt < mte) {
                uint32_t hi[4], lo[4];
                a_split(hi, lo, ys, mt * 16, kk * 8, ldy, lane);
                mma3(e[mt], hi, lo, b);
              }
            }
          }
        }
      }
      // + b1, GELU; hidden channels past dh have zero weights and bias: g(0) = 0
#pragma unroll
      for (int mt = 0; mt < kBoxTiles; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + 8 * half;
          if (mt < mte && r < box)
            *reinterpret_cast<float2*>(hid + r * kHLd32 + ecol) =
                make_float2(gelu_exact(e[mt][2 * half] + eb0),
                            gelu_exact(e[mt][2 * half + 1] + eb1));
        }
      }
    }
    __syncthreads();
    // depthwise 3x3 on the tile into the slice buffer, as mlp_item_mma: a
    // thread per (tile row, channel pair), f32 taps in (dy, dx) order, zero
    // outside the map, a 3x3 window sliding along the row; + bdw, GELU
    const int items = th * (kHC / 2);
    for (int item = tid; item < items; item += kThreads) {
      const int ty = item / (kHC / 2), col = 2 * (item % (kHC / 2)), d = d0 + col;
      float t0[9], t1[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        t0[k] = d < dh ? dwt[k * dh + d] : 0.f;
        t1[k] = d + 1 < dh ? dwt[k * dh + d + 1] : 0.f;
      }
      const float bias0 = d < dh ? bdw[d] : 0.f, bias1 = d + 1 < dh ? bdw[d + 1] : 0.f;
      const int r = oy + ty;
      float* dst = hds + (size_t)ty * tw * sld + (ch - ch0) * kHC + col;
      float2 win[3][3];  // [column q - 1, q, q + 1][row r - 1, r, r + 1]
      auto load_col = [&](int qq, float2(&v)[3]) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int rr = r + dy - 1;
          v[dy] = rr >= 0 && rr < h && qq >= 0 && qq < w
                      ? *reinterpret_cast<const float2*>(
                            hid + ((rr - br0) * bw + qq - bq0) * kHLd32 + col)
                      : make_float2(0.f, 0.f);
        }
      };
      load_col(ox - 1, win[0]);
      load_col(ox, win[1]);
      float s0[kMaxTw], s1[kMaxTw];
#pragma unroll
      for (int tx = 0; tx < kMaxTw; ++tx) {
        if (tx < tw) {
          load_col(ox + tx + 1, win[2]);
          s0[tx] = s1[tx] = 0.f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              s0[tx] += win[dx][dy].x * t0[dy * 3 + dx];
              s1[tx] += win[dx][dy].y * t1[dy * 3 + dx];
            }
          }
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            win[0][dy] = win[1][dy];
            win[1][dy] = win[2][dy];
          }
        }
      }
#pragma unroll
      for (int tx = 0; tx < kMaxTw; ++tx) {
        if (tx < tw)  // pixels of a ragged tile past the map: 0
          *reinterpret_cast<float2*>(dst + (size_t)tx * sld) =
              r < h && ox + tx < w ? make_float2(gelu_exact(s0[tx] + bias0),
                                                 gelu_exact(s1[tx] + bias1))
                                   : make_float2(0.f, 0.f);
      }
    }
  }
  __syncthreads();  // the slice's conv output complete

  // the 1x1 contract of the slice: units of (16-row tile, kCGroup output
  // n-tiles) go round-robin to the warps; per k-step one A fragment, split
  // once, meets the unit's W2 fragments (one k-step ahead); then out (one
  // slice) or the slice's partial sums for the tile's pixels inside the map
  const int ks = (ch1 - ch0) * (kHC / 8), nt = c8 / 8;
  const int units = mtc * ((nt + kCGroup - 1) / kCGroup);
  for (int u = warp; u < units; u += kWarps) {
    const int r0 = (u % mtc) * 16, n0 = (u / mtc) * kCGroup;
    float acc[kCGroup][4];
    const uint4* wp[kCGroup];
    uint4 b[kCGroup];
#pragma unroll
    for (int j = 0; j < kCGroup; ++j) {
      wp[j] = w2f + ((size_t)min(n0 + j, nt - 1) * ks2 + ch0 * (kHC / 8)) * 32 + lane;
      b[j] = __ldg(wp[j]);
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    for (int kk = 0; kk < ks; ++kk) {
      uint4 next[kCGroup];
#pragma unroll
      for (int j = 0; j < kCGroup; ++j)
        next[j] = kk + 1 < ks ? __ldg(wp[j] + (size_t)(kk + 1) * 32) : b[j];
      uint32_t hi[4], lo[4];
      a_split(hi, lo, hds, r0, kk * 8, sld, lane);
#pragma unroll
      for (int j = 0; j < kCGroup; ++j) {
        if (n0 + j < nt) mma3(acc[j], hi, lo, b[j]);
        b[j] = next[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kCGroup; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = r0 + g + 8 * (k >> 1), col = (n0 + j) * 8 + c2 + (k & 1);
        const int r = oy + o / tw, q = ox + o % tw;
        if (n0 + j >= nt || o >= nout || col >= c || r >= h || q >= w) continue;
        const size_t off = ((size_t)r * w + q) * c + col;
        if (slices == 1)
          out[(size_t)person * map + off] = from_f32<T>(gelu_exact(acc[j][k] + b2[col]));
        else
          part[((size_t)slice * p + person) * map + off] = acc[j][k];
      }
    }
  }
}

// The slices' sums of element i of [n] = [p, h, w, c], added in the order
// s = 0 ... slices - 1, then G's last stage: T(g(sum + b2)).
template <typename T>
__device__ __forceinline__ void mlp32_finish(const float* __restrict__ part,
                                             const float* __restrict__ b2, T* __restrict__ out,
                                             size_t n, int c, int slices, size_t i) {
  float sum = part[i];
  for (int s = 1; s < slices; ++s) sum += part[(size_t)s * n + i];
  out[i] = from_f32<T>(gelu_exact(sum + b2[i % c]));
}

}  // namespace
