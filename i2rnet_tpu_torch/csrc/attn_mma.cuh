// Tensor-core building blocks of the bf16 attention kernels (mhsa.cu,
// Kernel A; mhsa_train.cu, Kernel C), also used by the bf16 bodies of
// mlp_dwbn.cuh and window_attn.cuh: warp-level mma.sync, ldmatrix,
// cp.async tile copies, and the key-mask scan that decides which 64-key tiles
// a block skips.
//
// Replaces: nothing by itself; the Pallas functions are
// i2rnet_tpu/ops/pallas/mhsa.py::masked_mhsa_pallas and
// i2rnet_tpu/ops/pallas/mhsa_train.py::masked_mhsa_train.
//
// What bounds it on the H100: these kernels' products. At the main path's
// shapes (S = 1344 tokens, head dim 96, one head) the products are about 100
// operations per byte of q, k, v, so the tensor cores bound them, not device
// memory; the fp32 CUDA cores they replace reach 67 TFLOP/s against 989 on
// the tensor cores.
//
// Design: each warp owns 16 rows of a 64-row tile. q . K^T and P . V (and
// the backward's products) run as mma.sync.m16n8k16 bf16 -> f32; operands
// come from shared memory through ldmatrix (.trans for the operand whose
// contraction runs along the stored rows); an f32 accumulator of 16 x 8
// holds the same elements as the bf16 A operand of the next product, so the
// probabilities go from registers to the tensor cores without shared memory.
// Tiles of 64 rows are copied with cp.async into bf16 shared memory, the
// head dim zero-filled to a multiple of 16 and the row stride 8 elements
// longer than that, so the 8 rows an ldmatrix reads fall on distinct bank
// groups. Copies are 16 bytes where the head dim is a multiple of 8, else
// 4 bytes (even head dims: 78) or plain loads (odd ones).
//
// The skip rule: a key tile whose keys are all padded (or past S) is skipped
// where the image has at least one unpadded key. It is exact: a padded key's
// logit is -1e30 + x, and once a row has seen a real key its running max m is
// far above -1e30, so exp(-1e30 + x - m) is exactly 0 in f32; a padded tile
// seen first would be wiped out by alpha = exp(-1e30 - m_new) = 0. A fully
// padded image skips nothing: every logit is exactly -1e30 and the row is the
// uniform average over its S keys.
//
// The float32 inputs of both kernels keep their first design (CUDA-core FMAs
// on f32 tiles) in mhsa.cu and mhsa_train.cu: TF32 would not hold the f32
// parity route's 1e-4 tolerance.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {
namespace amma {

constexpr int kTile = 64;          // rows of a tile: queries or keys
constexpr float kNegBig = -1e30f;  // additive bias of a padded key
constexpr size_t kMaxSmem = 232448;
// The bf16 kernels keep logits in base 2 (x * log2 e), so that each weight is
// one ex2: the scale, the padded keys' bias and the running max alike.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig2 = kNegBig * kLog2e;

__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// shared-memory row stride (bf16 elements) of a tile with padded head dim DP
template <int DP> __host__ __device__ constexpr int ld() { return DP + 8; }
template <int DP> constexpr size_t tile_bytes() { return sizeof(__nv_bfloat16) * kTile * ld<DP>(); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two 8x8 b16 matrices transposed: the B operand of one n-tile (8 columns
// c0.. of rows r0..r0+15) of a product that contracts along the stored rows
// (address a_off(lane & 15, r0, c0, LD)); lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a . b: A 16x16 (row), B 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand (rows = this warp's 16 rows, k = 16 columns from kk*16) of
// a 16 x 64 f32 accumulator set acc[8][4]: n-tiles 2kk and 2kk+1, rounded.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// Fragment addresses inside a tile of row stride LD (elements), for lane l:
// the A operand of rows r0..r0+15, columns c0..c0+15 (also the B operand of
// a product that contracts along the stored rows, read with ldsm_x4_t: its
// registers 0, 1 are the 8 columns c0.., 2, 3 the 8 columns c0 + 8..)
__device__ __forceinline__ int a_off(int lane, int r0, int c0, int LD) {
  return (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
// the B operand of rows (n) r0..r0+15, columns (k) c0..c0+15 for ldsm_x4:
// registers 0, 1 are n-tile r0.., 2, 3 n-tile r0 + 8..
__device__ __forceinline__ int b_off(int lane, int r0, int c0, int LD) {
  return (r0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements per copy for head dim d and the matrices' base pointers: 16
// bytes, 4 bytes, or plain loads, as the rows' alignment allows.
inline int copy_vec(int d, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  if (d % 8 == 0 && bits % 16 == 0) return 8;
  return d % 2 == 0 && bits % 4 == 0 ? 2 : 1;
}

// Rows r0..r0+63 of a [s, d] bf16 matrix into a [64][DP + 8] tile, zero
// outside (rows >= s, columns >= d); cp.async except for vec == 1.
template <int DP, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                          int s, int d, int vec, int tid) {
  constexpr int LD = ld<DP>();
  if (vec == 8) {
    constexpr int kPer = DP / 8;
    for (int i = tid; i < kTile * kPer; i += kThreads) {
      const int r = i / kPer, c = (i % kPer) * 8, gr = r0 + r;
      const bool in = gr < s && c < d;
      cp_async16(dst + r * LD + c, in ? src + (size_t)gr * d + c : src, in);
    }
  } else if (vec == 2) {
    constexpr int kPer = DP / 2;
    for (int i = tid; i < kTile * kPer; i += kThreads) {
      const int r = i / kPer, c = (i % kPer) * 2, gr = r0 + r;
      const bool in = gr < s && c < d;
      cp_async4(dst + r * LD + c, in ? src + (size_t)gr * d + c : src, in);
    }
  } else {
    for (int i = tid; i < kTile * DP; i += kThreads) {
      const int r = i / DP, c = i % DP, gr = r0 + r;
      dst[r * LD + c] = (gr < s && c < d) ? src[(size_t)gr * d + c] : __float2bfloat16(0.f);
    }
  }
}

// Float rows r0..r0+63 of a [s] array into dst, 0 past s.
template <int kThreads>
__device__ __forceinline__ void load_row_stats(float* dst, const float* src, int r0, int s,
                                               int tid) {
  for (int i = tid; i < kTile; i += kThreads) {
    const bool in = r0 + i < s;
    cp_async4(dst + i, in ? src + r0 + i : src, in);
  }
}

// The image's key mask into shared memory: pad[k] = 1 where key k is padded
// (all 0 without a mask), live[t] = 1 where tile t has an unpadded key.
// Returns whether the image has an unpadded key (the skip rule applies).
// Ends with a barrier.
template <int kThreads>
__device__ __forceinline__ bool scan_mask(const uint8_t* key_pad, int b, int s, uint8_t* pad,
                                          uint8_t* live, int tid) {
  const int nt = (s + kTile - 1) / kTile;
  for (int t = tid; t < nt; t += kThreads) live[t] = 0;
  __syncthreads();
  int any = 0;
  for (int k = tid; k < s; k += kThreads) {
    const uint8_t p = key_pad != nullptr && key_pad[(size_t)b * s + k] != 0;
    pad[k] = p;
    if (!p) {
      any = 1;
      live[k / kTile] = 1;  // every writer stores 1
    }
  }
  return __syncthreads_or(any) != 0;
}

// the next tile from t on that the block computes
__device__ __forceinline__ int next_tile(const uint8_t* live, bool has_key, int t, int nt) {
  if (has_key)
    while (t < nt && !live[t]) ++t;
  return t;
}

// 2^x (ex2.approx, ftz): 2^0 = 1, 2^-inf = 0, results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x (rcp.approx, ftz): one instruction, the same value in every kernel
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// additive base-2 bias of key kc: 0, -1e30 log2 e (padded) or -inf (past s)
__device__ __forceinline__ float key_bias2(const uint8_t* pad, int kc, int s) {
  return kc < s ? (pad[kc] ? kNegBig2 : 0.f) : -INFINITY;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The base-2 logits of 16 rows (r0 of the row tile qs) against the 32 keys
// of the key tile kt (kc0 = the first one's index): 4 n-tiles of 8 keys. The
// one place the logits are formed, so every kernel recomputes them bit for bit.
template <int NK>
__device__ __forceinline__ void logits32(float (&sc)[4][4], const __nv_bfloat16* qs, int r0,
                                         const __nv_bfloat16* kt, int LD, const uint8_t* pad, int kc0,
                                         int s, float scale2, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t qa[4];
    ldsm_x4(qa, qs + a_off(lane, r0, kk * 16, LD));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t kb[4];
      ldsm_x4(kb, kt + b_off(lane, np * 16, kk * 16, LD));
      mma(sc[2 * np], qa, kb[0], kb[1]);
      mma(sc[2 * np + 1], qa, kb[2], kb[3]);
    }
  }
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kc = kc0 + 8 * j + 2 * t4;
    const float b0 = key_bias2(pad, kc, s), b1 = key_bias2(pad, kc + 1, s);
    sc[j][0] = __fmaf_rn(sc[j][0], scale2, b0);
    sc[j][1] = __fmaf_rn(sc[j][1], scale2, b1);
    sc[j][2] = __fmaf_rn(sc[j][2], scale2, b0);
    sc[j][3] = __fmaf_rn(sc[j][3], scale2, b1);
  }
}

// The two key halves' [16 x DP] f32 accumulators summed in a fixed order (half
// 0 + half 1) through red [4 row groups][ND * 4][32 lanes]; true in the half
// that holds the sum (kh == 0). Ends with a barrier.
template <int ND>
__device__ __forceinline__ bool sum_halves(float (&acc)[ND][4], float* red, int rg, int kh,
                                           int lane) {
  float* mine = red + rg * ND * 4 * 32;
  if (kh == 1) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32 + lane] = acc[j][e];
  }
  __syncthreads();
  if (kh == 1) return false;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += mine[(j * 4 + e) * 32 + lane];
  return true;
}

// Let `kernel` take `bytes` of dynamic shared memory: the attribute is set
// when a launch needs more than any earlier one (a host call, not a launch,
// so it is kept off the common path).
template <auto kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 0;  // one per kernel
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// Shared memory of a kernel that holds `tiles` tiles and the mask scan of s keys.
template <int DP>
constexpr size_t tiles_smem(int tiles) { return tiles * tile_bytes<DP>(); }
inline size_t scan_smem(int s) { return round16(s) + round16((s + kTile - 1) / kTile); }

}  // namespace amma
}  // namespace
