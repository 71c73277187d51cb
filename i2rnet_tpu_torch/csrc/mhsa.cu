// Masked multi-head self-attention, forward (eval), for Hopper (sm_90a).
//
// Replaces: i2rnet_tpu/ops/pallas/mhsa.py::masked_mhsa_pallas.
//
// Computes, per (batch*head) and query row,
//     out = softmax(q . K^T * scale + bias) . V
// with bias = -1e30 at padded keys (key_padding_mask true) and 0 elsewhere,
// softmax and accumulation in f32, output cast to the input type.
//
// What bounds it on the H100: at the main-path shape (B=16 images, S=N*192=
// 1344 tokens, head dim 96, one head) the two products over the keys the mask
// leaves are about 5.4 GFLOP while q, k, v and out are 16.5 MB in bf16, so the
// tensor cores bound it (5.4 us at 989 TFLOP/s), not device memory (4.9 us).
// The [S, S] logits must stay out of device memory.
//
// Design, bf16 (attn_mma.cuh has the building blocks and the skip rule): one
// block of 4 warps per (batch*head, 64-query tile), 3 blocks an SM; each warp
// reads its 16 query rows' mma.sync A fragments from shared memory. 64-key
// tiles of K and V stay bf16 in shared memory, double-buffered with
// cp.async, the next tile in flight while the current one is multiplied (one
// barrier a tile). S = q . K^T on the tensor cores into f32 registers, scaled
// in f32 (not q before the product: q * scale would round to bf16) and kept
// in base 2 (times log2 e, so each weight is one ex2), the bias added, an
// online softmax on those registers (running max from the finite -1e30 log2
// e, row max and sum over the quad of lanes that holds a row), P rounded to
// bf16 in registers as the A operand of P . V, O accumulated in f32 and
// divided by the row sum at the end. Key tiles that the mask pads entirely are skipped
// where the image has an unpadded key; a fully padded image is computed in
// full and is the uniform average over its S keys, finite, as masked_mhsa_xla
// gives it. Keys past S get weight exactly 0.
//
// Head dims: instances for d padded to 16 up to 128 (3 blocks an SM), and
// wide ones for d padded to 192 and to 256 (the cat_vec inter encoder: C =
// 96 + 96 = 192 on the TPH recipes, 78 + 96 = 174 on the HRT ones) with
// the same body at one block an SM (mma_min_blocks): 255 registers a thread
// hold the 96 or 128 f32 output values, and the five tiles take 128 or 169 KB.
//
// float32 keeps the first design (CUDA-core FMAs on f32 shared-memory tiles,
// four lanes per query row): it is the parity route of the f32 model checks,
// and the tensor cores' TF32 would not hold their 1e-4 tolerance. Its head-dim
// tiles go to 192 and 256 as well (165 and 214 KB of shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kMaxHeadDim = 256;  // the widest instance (ops/cuda/mhsa.py::MAX_HEAD_DIM)
constexpr int kThreads = 256;  // 4 threads per query row
constexpr int kLdP = kBlockK + 1;
using amma::kNegBig;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// DT: head-dim tile, a multiple of 4 and >= d. Row stride DT + 1 keeps the
// four lanes of a row, and the eight rows of a warp, on distinct banks.
template <int DT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(3 * kBlockQ * (DT + 1) + kBlockQ * kLdP + kBlockK);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
mhsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const uint8_t* __restrict__ key_pad, T* __restrict__ out,
                int s, int d, int heads, float scale) {
  constexpr int LD = DT + 1;
  constexpr int NJ = kBlockK / 4;  // logits per thread per tile
  constexpr int NO = DT / 4;       // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBlockQ][LD], pre-scaled
  float* ks = qs + kBlockQ * LD;      // [kBlockK][LD]
  float* vs = ks + kBlockK * LD;      // [kBlockK][LD]
  float* ps = vs + kBlockK * LD;      // [kBlockQ][kLdP]
  float* bias = ps + kBlockQ * kLdP;  // [kBlockK]

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)bh * s * d;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int quarter = tid & 3;

  for (int i = tid; i < kBlockQ * DT; i += kThreads) {
    const int r = i / DT, c = i % DT, qr = q0 + r;
    qs[r * LD + c] = (qr < s && c < d) ? to_f32(q[base + (size_t)qr * d + c]) * scale : 0.f;
  }

  float m = kNegBig, l = 0.f;
  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < s; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K/V readers are done
    for (int i = tid; i < kBlockK * DT; i += kThreads) {
      const int r = i / DT, c = i % DT, kr = k0 + r;
      const bool in = kr < s && c < d;
      ks[r * LD + c] = in ? to_f32(k[base + (size_t)kr * d + c]) : 0.f;
      vs[r * LD + c] = in ? to_f32(v[base + (size_t)kr * d + c]) : 0.f;
    }
    if (tid < kBlockK) {
      const int kr = k0 + tid;
      bias[tid] = kr >= s ? -INFINITY
                          : ((key_pad != nullptr && key_pad[(size_t)b * s + kr]) ? kNegBig : 0.f);
    }
    __syncthreads();

    float sc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) sc[j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qv = qs[row * LD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[j] += qv * ks[(quarter + 4 * j) * LD + c];
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      sc[j] += bias[quarter + 4 * j];
      tmax = fmaxf(tmax, sc[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);  // finite: m starts at -1e30
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
      ps[row * kLdP + quarter + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] *= alpha;
    __syncwarp();  // a row's probabilities are written and read by its own 4 lanes

    for (int kk = 0; kk < kBlockK; ++kk) {
      const float p = ps[row * kLdP + kk];
      const float* vr = vs + kk * LD + quarter;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[j] += p * vr[4 * j];
    }
  }

  const int qr = q0 + row;
  if (qr < s) {
    T* orow = out + base + (size_t)qr * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = quarter + 4 * j;
      if (c < d) orow[c] = from_f32<T>(acc[j] / l);
    }
  }
}

template <typename T, int DT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_pad, void* out,
                   int bh, int s, int d, int heads, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DT>();
  cudaError_t err = cudaFuncSetAttribute(mhsa_fwd_kernel<T, DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  mhsa_fwd_kernel<T, DT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_pad), static_cast<T*>(out), s, d, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dt(const void* q, const void* k, const void* v, const void* key_pad,
                        void* out, int bh, int s, int d, int heads, float scale,
                        cudaStream_t stream) {
  if (d <= 32) return launch<T, 32>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
  if (d <= 96) return launch<T, 96>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
  if (d <= 192) return launch<T, 192>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
  return launch<T, 256>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
}

// ---- bf16: tensor cores ----------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <int DP>
size_t mma_smem_bytes(int s) {
  return amma::tiles_smem<DP>(5) + amma::scan_smem(s);  // Q, 2 x (K, V), mask
}

// Resident blocks an SM is built for: 3 up to head dim 128 (the instances the
// main path runs, unchanged); 1 for the wide ones (padded head dim 192 or 256,
// the cat_vec encoders), whose f32 output accumulator (96 or 128 values a
// thread) needs the 255 registers one block an SM leaves, and whose five
// tiles (128 or 169 KB) fit one block's shared memory only.
template <int DP> __host__ __device__ constexpr int mma_min_blocks() { return DP <= 128 ? 3 : 1; }

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<DP>())
mhsa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ key_pad,
                    bf16* __restrict__ out, int s, int d, int heads, float scale, int vec) {
  using namespace amma;
  constexpr int LD = ld<DP>();
  constexpr int NK = DP / 16;  // k-steps over the head dim
  constexpr int ND = DP / 8;   // 8-column tiles of the output
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // [64][LD]
  bf16* ks = qs + kTile * LD;                    // [2][64][LD]
  bf16* vs = ks + 2 * kTile * LD;                // [2][64][LD]
  uint8_t* pad = reinterpret_cast<uint8_t*>(vs + 2 * kTile * LD);
  uint8_t* live = pad + round16(s);

  const int bh = blockIdx.y, b = bh / heads, q0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * s * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int nt = (s + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;

  const bool has_key = scan_mask<kMmaThreads>(key_pad, b, s, pad, live, tid);
  load_tile<DP, kMmaThreads>(qs, q + base, q0, s, d, vec, tid);
  int cur = next_tile(live, has_key, 0, nt);  // < nt: a live tile, or every tile
  load_tile<DP, kMmaThreads>(ks, k + base, cur * kTile, s, d, vec, tid);
  load_tile<DP, kMmaThreads>(vs, v + base, cur * kTile, s, d, vec, tid);
  cp_commit();

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegBig2, m1 = kNegBig2, l0 = 0.f, l1 = 0.f;  // rows g and g + 8; l per lane
  int stage = 0;
  while (cur < nt) {
    // one barrier a tile: the current tile has landed for every thread, and
    // every warp is done with the other stage, which the next tile refills
    cp_wait<0>();
    __syncthreads();
    const int nxt = next_tile(live, has_key, cur + 1, nt);
    if (nxt < nt) {
      load_tile<DP, kMmaThreads>(ks + (stage ^ 1) * kTile * LD, k + base, nxt * kTile, s, d, vec,
                                 tid);
      load_tile<DP, kMmaThreads>(vs + (stage ^ 1) * kTile * LD, v + base, nxt * kTile, s, d, vec,
                                 tid);
    }
    cp_commit();
    const bf16* kt = ks + stage * kTile * LD;
    const bf16* vt = vs + stage * kTile * LD;

    // S = q . K^T in base 2: 16 rows x 64 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, qs + a_off(lane, warp * 16, kk * 16, LD));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + b_off(lane, np * 16, kk * 16, LD));
        mma(sc[2 * np], qa, kb[0], kb[1]);
        mma(sc[2 * np + 1], qa, kb[2], kb[3]);
      }
    }
    const int k0 = cur * kTile;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kc = k0 + 8 * j + 2 * t4;
      const float b0 = key_bias2(pad, kc, s), b1 = key_bias2(pad, kc + 1, s);
      sc[j][0] = __fmaf_rn(sc[j][0], scale2, b0);
      sc[j][1] = __fmaf_rn(sc[j][1], scale2, b1);
      sc[j][2] = __fmaf_rn(sc[j][2], scale2, b0);
      sc[j][3] = __fmaf_rn(sc[j][3], scale2, b1);
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));  // finite
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][0] = ex2(sc[j][0] - mn0);
      sc[j][1] = ex2(sc[j][1] - mn0);
      sc[j][2] = ex2(sc[j][2] - mn1);
      sc[j][3] = ex2(sc[j][3] - mn1);
      ps0 += sc[j][0] + sc[j][1];
      ps1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys at a time
      uint32_t pa[4];
      acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vt + a_off(lane, kk * 16, dp * 16, LD));
        mma(o[2 * dp], pa, vb[0], vb[1]);
        mma(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    stage ^= 1;
    cur = nxt;
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = 8 * j + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      const float inv = h ? inv1 : inv0;
      if (r >= s || c >= d) continue;
      bf16* dst = out + base + (size_t)r * d + c;
      if (c + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
      } else {
        dst[0] = __float2bfloat16(o[j][2 * h] * inv);
        if (c + 1 < d) dst[1] = __float2bfloat16(o[j][2 * h + 1] * inv);
      }
    }
  }
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* key_pad,
                       void* out, int bh, int s, int d, int heads, float scale,
                       cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes<DP>(s);
  cudaError_t err = amma::allow_smem<mhsa_fwd_mma_kernel<DP>>(bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + amma::kTile - 1) / amma::kTile, bh);
  mhsa_fwd_mma_kernel<DP><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(key_pad), static_cast<bf16*>(out), s, d, heads, scale,
      amma::copy_vec(d, {q, k, v}));
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, const void* key_pad,
                         void* out, int bh, int s, int d, int heads, float scale,
                         cudaStream_t stream) {
  switch (amma::pad16(d)) {
    case 16: return launch_mma<16>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
    case 32: return launch_mma<32>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
    case 48: return launch_mma<48>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
    case 64: return launch_mma<64>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
    case 80: return launch_mma<80>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
    case 96: return launch_mma<96>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
    case 112: return launch_mma<112>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
    case 128: return launch_mma<128>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
  }
  // the wide instances: head dims padded to 192 or to 256
  if (d <= 192) return launch_mma<192>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
  return launch_mma<256>(q, k, v, key_pad, out, bh, s, d, heads, scale, stream);
}

}  // namespace

// q, k, v, out: [bh, s, d] contiguous, heads folded into the batch (bh = B*heads).
// key_pad: [B, s] bytes, nonzero = padded key; may be null (no mask).
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int i2r_mhsa_fwd(const void* q, const void* k, const void* v, const void* key_pad,
                            void* out, int bh, int s, int d, int heads, float scale, int dtype,
                            void* stream) {
  if (bh < 1 || s < 1 || d < 1 || d > kMaxHeadDim || heads < 1 || bh % heads != 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dt<float>(q, k, v, key_pad, out, bh, s, d, heads, scale, st);
  else if (dtype == 1)
    err = dispatch_mma(q, k, v, key_pad, out, bh, s, d, heads, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
