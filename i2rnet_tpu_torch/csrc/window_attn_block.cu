// HRFormer window-attention half block, forward, for Hopper (sm_90a).
//
// Replaces: i2rnet_tpu/ops/pallas/hrformer_block.py::window_attn_block_fused
// (eval, Kernel E) and the forward of
// i2rnet_tpu/ops/pallas/hrformer_block_train.py::window_attn_block_train
// (training, kernel 9: the template's kTrain flag).
//
// Computes x + WindowMHSA(LN1(x)) on a [P, H, W, C] map, rounding where
// _attn_math (hrformer_block.py:109-155) rounds, with T the activation type:
//     y    = T(LN1(x))                    f32 statistics over C, eps
//     windows of 7x7 tokens after zero center padding of H and W to
//     multiples of 7 (pad tokens are 0 after LN, attended through the biases)
//     q    = T(y . Wq' + bq')             Wq' = T(s Wq), bq' = s bq, s = d^-1/2
//     k, v = T(y . W + b)                 f32 accumulation
//     o    = T(T(softmax(q . k^T)) . v)   per head; f32 logits and softmax
//     out  = x + T(o . Wo + bo)           residual in T, real tokens only
// The relative-position bias is not added (the reference quirk).
// With kTrain (kernel 9, _fwd_kernel :104-156) the block also takes the
// per-sample droppath scale s [P] and writes the window tokens t2 = T(y)
// [P, nwin, 49, C] (0 at pad tokens) for the backward, and the last line is
//     out  = x + T(s (o . Wo + bo))        the product in f32
//
// What bounds it on the H100: per person at branch 0 of a 256x192 input
// (64x48x78, padded to 70x49 = 3430 window tokens, 2 heads of d = 39) the
// products are 2*3430*78*234 (q, k, v) + 70*2*2*2*49*49*39 (attention) +
// 2*3072*78*78 (out) = 0.22 GFLOP against 2*3072*78*2 B = 0.96 MB of bf16
// map I/O: about 0.22 us at the bf16 tensor-core peak and 0.29 us at the
// memory rate, so the map's bytes bound it (chip_smoke.py::hrt_bound counts
// the same at every map). At branch 3 (8x6x624, 16 heads) the windows pad 48
// tokens to 98, and the products (q, k, v of C = 624) are most of the work.
//
// Design, bf16 (window_attn.cuh::attn_item_mma, attn_out_mma, out_tile).
// Pass 1, one block of 256 threads per (window, head group, person): the
// plan (ops/cuda/hrformer_block.py::attn_plan) keeps all heads of a window in
// one block where the map has windows enough for two blocks per SM (G = 2, 4
// at 256x192's branches 0-1, P = 32), and splits them into groups of G where
// it has not (G = 4 at branch 2, 2 at branch 3, whose 8x6 map has 2 windows).
// The block copies the window's 49 tokens of x by cp.async (all copies in
// flight at once) into a bf16 tile of 64 rows x pad16(C) in shared memory
// (rows 49-63, pad tokens and channels past C are 0) and LayerNorms them
// there. Per head: q, k, v [64 x 3 dp] on mma.sync m16n8k16 (bf16 in, f32
// accumulate), dp = d padded to 16 (39 -> 48), A by ldmatrix from the tile,
// B (the head's weights, zero past d) straight from L2 in a fragment-ordered
// layout the wrapper packs once, two k-steps ahead, a warp per 8 output
// columns over all four row tiles; + bias and rounding into q, k, v tiles in
// shared memory. Then each warp takes 16 query rows: q . k^T against the 64
// tile rows into registers, keys 49-63 masked to -inf (rows of the tile, not
// keys; the window's pad tokens are keys, through the biases), the f32
// softmax, P rounded in registers as the A operand of P . v (the two warps
// of a row tile share its n-tiles), and o rounded to bf16. Where the block
// holds all heads, o stays in shared memory and the block runs the
// out-projection of its 64 rows itself (out_tile: Wo's fragments from L2, +
// bo, times s with kTrain, rounding, the residual x, the real tokens
// written): one launch. Otherwise o goes to a scratch map [P, H, W, C] at the
// window's real tokens, and pass 2 runs out_tile over the P H W tokens, a
// block per (64 rows of o staged in shared memory, column block of the
// plan's n-tiles). Every product's operands are already rounded to bf16
// where _attn_math rounds them (y, q, k, v, P, o), so the tensor cores change
// only the order of the f32 sums, and each output element sums its k-steps
// in the same order on either path. With kTrain head group 0 also writes t2.
// Not built: wgmma/TMA; the products are not what bounds it (PERF.md,
// probes/attn_sweep.py), the latency of each block's dependent steps is.
//
// Design, f32 (window_attn.cuh::window_attn_item, the CUDA-core template;
// f32 checks hold to 1e-4, which bf16 or TF32 products cannot): one block of
// 256 threads per (window, person). LN statistics of the 49 tokens first (a
// warp per token). Then per head: q, k, v of the window accumulate over the
// C input channels in chunks of 32 (the LN'd token tile and the head's
// weight tile staged in shared memory, the partial sums kept in shared f32),
// logits, softmax and P.V in shared memory; the head's output lands in a
// [49, C] tile. Last, the out-projection reads that tile and Wo^T through
// L1/L2, adds bias and residual, and writes the real tokens. Every product
// item is (one output column, one window row of 7 tokens), so each weight
// value read serves seven tokens.
// Kernel 7 (full_block.cu) runs the same item functions as its first phases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "window_attn.cuh"

namespace {

template <typename T, bool kTrain>
__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const T* __restrict__ x, const float* __restrict__ s,
                   const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                   const T* __restrict__ wqkv, const float* __restrict__ bqkv,
                   const T* __restrict__ wot, const float* __restrict__ bo, T* __restrict__ out,
                   T* __restrict__ t2, int h, int w, int c, int heads, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  window_attn_item<T, kTrain>(x, s, ln_g, ln_b, wqkv, bqkv, wot, bo, out, t2, h, w, c, heads, eps,
                              blockIdx.x, blockIdx.y, gridDim.x, smem_raw);
}

// pass 1, built for kBlocks resident blocks an SM (at most 128 or 85
// registers a thread)
template <bool kTrain, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
attn_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_g,
                const float* __restrict__ ln_b, const uint2* __restrict__ wf,
                const float* __restrict__ bqkv, const float* __restrict__ s,
                const uint2* __restrict__ wof, const float* __restrict__ bo,
                __nv_bfloat16* __restrict__ o, __nv_bfloat16* __restrict__ out,
                __nv_bfloat16* __restrict__ t2, int h, int w, int c, int heads, int group,
                float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nwin = ((h + kWin - 1) / kWin) * ((w + kWin - 1) / kWin);
  attn_item_mma<kTrain>(x, ln_g, ln_b, wf, bqkv, s, wof, bo, o, out, t2, h, w, c, heads, group,
                        eps, blockIdx.x % nwin, blockIdx.x / nwin, blockIdx.y, nwin, smem_raw);
}

template <bool kTrain>
__global__ void __launch_bounds__(kThreads)
attn_out_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ s, const uint2* __restrict__ wof,
                const float* __restrict__ bo, __nv_bfloat16* __restrict__ out, int rows, int hw,
                int c, int cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attn_out_mma<kTrain>(o, x, s, wof, bo, out, rows, hw, c, cols, blockIdx.x, blockIdx.y,
                       smem_raw);
}

// The launches of one call: the CUDA-core template for f32 (group = cols =
// 0), the two passes of the tensor-core body for bf16.
struct Args {
  const void *x, *s, *ln_g, *ln_b, *wqkv, *bqkv, *wot, *bo, *wf, *wof;
  void *o, *out, *t2;
  int p, h, w, c, heads, group, cols;
  float eps;
};

template <bool kTrain>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  if (a.group != 0 || a.cols != 0) return cudaErrorInvalidValue;
  const size_t bytes = attn_smem_bytes<float>(a.c, a.c / a.heads);
  cudaError_t err = amma::allow_smem<window_attn_kernel<float, kTrain>>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.h + kWin - 1) / kWin) * ((a.w + kWin - 1) / kWin), a.p);
  window_attn_kernel<float, kTrain><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.s),
      static_cast<const float*>(a.ln_g), static_cast<const float*>(a.ln_b),
      static_cast<const float*>(a.wqkv), static_cast<const float*>(a.bqkv),
      static_cast<const float*>(a.wot), static_cast<const float*>(a.bo),
      static_cast<float*>(a.out), static_cast<float*>(a.t2), a.h, a.w, a.c, a.heads, a.eps);
  return cudaGetLastError();
}

template <bool kTrain>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bool fused = a.group == a.heads;  // pass 1 runs the out-projection itself
  if (!attn_mma_fits(a.c, a.heads, a.group, a.cols) || (!fused && a.o == nullptr))
    return cudaErrorInvalidValue;
  const size_t b1 = attn_mma_smem_bytes(a.c, a.c / a.heads, fused), b2 = attn_out_smem_bytes(a.c);
  // three blocks an SM where their shared memory fits, else two
  const bool three = b1 <= kThreePerSm;
  cudaError_t err = three ? amma::allow_smem<attn_mma_kernel<kTrain, 3>>(b1)
                          : amma::allow_smem<attn_mma_kernel<kTrain, 2>>(b1);
  if (err != cudaSuccess) return err;
  if (!fused && (err = amma::allow_smem<attn_out_kernel<kTrain>>(b2)) != cudaSuccess) return err;
  const int nwin = ((a.h + kWin - 1) / kWin) * ((a.w + kWin - 1) / kWin);
  const long grid1 = (long)nwin * (a.heads / a.group);
  const long rows = (long)a.p * a.h * a.w, nt = amma::pad16(a.c) / 8;
  const long grid2 = (rows + kRows - 1) / kRows;
  if (grid1 > 0x7fffffffL || grid2 > 0x7fffffffL || rows > 0x7fffffffL)
    return cudaErrorInvalidValue;
  auto pass1 = three ? attn_mma_kernel<kTrain, 3> : attn_mma_kernel<kTrain, 2>;
  pass1<<<dim3((unsigned)grid1, a.p), kThreads, b1, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const float*>(a.ln_g),
      static_cast<const float*>(a.ln_b), static_cast<const uint2*>(a.wf),
      static_cast<const float*>(a.bqkv), static_cast<const float*>(a.s),
      static_cast<const uint2*>(a.wof), static_cast<const float*>(a.bo), static_cast<bf16*>(a.o),
      static_cast<bf16*>(a.out), static_cast<bf16*>(a.t2), a.h, a.w, a.c, a.heads, a.group, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess || fused) return err;
  attn_out_kernel<kTrain>
      <<<dim3((unsigned)grid2, (unsigned)((nt + a.cols - 1) / a.cols)), kThreads, b2, stream>>>(
          static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.x),
          static_cast<const float*>(a.s), static_cast<const uint2*>(a.wof),
          static_cast<const float*>(a.bo), static_cast<bf16*>(a.out), (int)rows, a.h * a.w, a.c,
          a.cols);
  return cudaGetLastError();
}

template <bool kTrain>
int dispatch(const Args& a, int dtype, void* stream) {
  if (a.p < 1 || a.h < 1 || a.w < 1 || a.heads < 1 || a.c < a.heads || a.c % a.heads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32<kTrain>(a, st);
  if (dtype == 1) return (int)launch_bf16<kTrain>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: [p, h, w, c] contiguous, type T (dtype 0 = float32, 1 = bfloat16).
// ln_g, ln_b: [c] f32. bqkv: [heads][3][d] f32 (q pre-scaled), bo: [c] f32.
// f32 (the CUDA-core template): wqkv [c][heads][3][d] in T (input channel
// first; q, k, v of a head side by side; q pre-scaled) and wot = Wo^T [c][c]
// in T; group = cols = 0; wf, wof and o unused. bf16 (the tensor-core body):
// wf and wof the q/k/v and Wo fragments (window_attn.cuh, attn_item_mma and
// attn_out_mma; ops/cuda/hrformer_block.py::pack_attn), o a bf16 scratch
// [p, h, w, c] (unused, and may be null, where group = heads: no pass 2),
// group the heads per block of pass 1 and cols the n-tiles per block of
// pass 2 (ops/cuda/hrformer_block.py::attn_plan); wqkv and wot unused.
// Window 7. Returns the cudaError_t of the launches (cudaErrorInvalidValue
// for shapes or plans it does not take).
extern "C" int i2r_window_attn_fwd(const void* x, const void* ln_g, const void* ln_b,
                                   const void* wqkv, const void* bqkv, const void* wot,
                                   const void* bo, const void* wf, const void* wof, void* o,
                                   void* out, int p, int h, int w, int c, int heads, int group,
                                   int cols, float eps, int dtype, void* stream) {
  const Args a{x,   nullptr, ln_g, ln_b,    wqkv, bqkv, wot,   bo, wf,   wof, o,
               out, nullptr, p,    h,       w,    c,    heads, group, cols, eps};
  return dispatch<false>(a, dtype, stream);
}

// Kernel 9's forward: as above, plus s [p] f32 (the per-sample droppath
// scale) and t2 [p, nwin, 49, c] of type T, the window tokens after LN1 (0
// at pad tokens), nwin = ceil(h / 7) * ceil(w / 7) in row-major window order.
extern "C" int i2r_window_attn_train_fwd(const void* x, const void* s, const void* ln_g,
                                         const void* ln_b, const void* wqkv, const void* bqkv,
                                         const void* wot, const void* bo, const void* wf,
                                         const void* wof, void* o, void* out, void* t2, int p,
                                         int h, int w, int c, int heads, int group, int cols,
                                         float eps, int dtype, void* stream) {
  if (s == nullptr || t2 == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{x,   s,  ln_g, ln_b, wqkv, bqkv,  wot,   bo,   wf,  wof, o,
               out, t2, p,    h,    w,    c,     heads, group, cols, eps};
  return dispatch<true>(a, dtype, stream);
}
