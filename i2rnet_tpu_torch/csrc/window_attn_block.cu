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
// memory rate, so the map's bytes bound it. This kernel runs its products on
// CUDA cores in f32, so what bounds it in practice is the FMA rate and the
// shared-memory reads that feed it.
//
// Design: one block of 256 threads per (window, person). LN statistics of the
// 49 tokens first (a warp per token). Then per head: q, k, v of the window
// accumulate over the C input channels in chunks of 32 (the LN'd token tile
// and the head's weight tile staged in shared memory, the partial sums kept
// in shared f32), logits, softmax and P.V in shared memory; the head's output
// lands in a [49, C] tile in T. Last, the out-projection reads that tile and
// Wo^T through L1/L2, adds bias and residual, and writes the real tokens.
// Every product item is (one output column, one window row of 7 tokens), so
// each weight value read serves seven tokens. The head dim is a runtime value
// (39 on HRFormer-B, no padding), C any width whose tiles fit shared memory
// (176 KB at C = 624 in f32). A later tensor-core version pads d to 48.
// The block's work is window_attn_item (window_attn.cuh), which phase 1 of
// kernel 7 (full_block.cu) runs too.

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

template <typename T, bool kTrain>
cudaError_t launch(const void* x, const void* s, const void* ln_g, const void* ln_b,
                   const void* wqkv, const void* bqkv, const void* wot, const void* bo, void* out,
                   void* t2, int p, int h, int w, int c, int heads, float eps,
                   cudaStream_t stream) {
  const size_t bytes = attn_smem_bytes<T>(c, c / heads);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attn_kernel<T, kTrain>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + kWin - 1) / kWin) * ((w + kWin - 1) / kWin), p);
  window_attn_kernel<T, kTrain><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const T*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const T*>(wot), static_cast<const float*>(bo),
      static_cast<T*>(out), static_cast<T*>(t2), h, w, c, heads, eps);
  return cudaGetLastError();
}

template <bool kTrain>
int dispatch(const void* x, const void* s, const void* ln_g, const void* ln_b, const void* wqkv,
             const void* bqkv, const void* wot, const void* bo, void* out, void* t2, int p,
             int h, int w, int c, int heads, float eps, int dtype, void* stream) {
  if (p < 1 || h < 1 || w < 1 || heads < 1 || c < heads || c % heads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, kTrain>(x, s, ln_g, ln_b, wqkv, bqkv, wot, bo, out, t2, p, h, w, c,
                                      heads, eps, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, kTrain>(x, s, ln_g, ln_b, wqkv, bqkv, wot, bo, out, t2, p,
                                              h, w, c, heads, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: [p, h, w, c] contiguous, type T (dtype 0 = float32, 1 = bfloat16).
// ln_g, ln_b: [c] f32. wqkv: [c][heads][3][d] in T (input channel first; q, k,
// v of a head side by side; q pre-scaled), bqkv: [heads][3][d] f32. wot: Wo^T
// [c][c] in T (input channel first), bo: [c] f32. Window 7. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for shapes it does not take).
extern "C" int i2r_window_attn_fwd(const void* x, const void* ln_g, const void* ln_b,
                                   const void* wqkv, const void* bqkv, const void* wot,
                                   const void* bo, void* out, int p, int h, int w, int c,
                                   int heads, float eps, int dtype, void* stream) {
  return dispatch<false>(x, nullptr, ln_g, ln_b, wqkv, bqkv, wot, bo, out, nullptr, p, h, w, c,
                         heads, eps, dtype, stream);
}

// Kernel 9's forward: as above, plus s [p] f32 (the per-sample droppath
// scale) and t2 [p, nwin, 49, c] of type T, the window tokens after LN1 (0
// at pad tokens), nwin = ceil(h / 7) * ceil(w / 7) in row-major window order.
extern "C" int i2r_window_attn_train_fwd(const void* x, const void* s, const void* ln_g,
                                         const void* ln_b, const void* wqkv, const void* bqkv,
                                         const void* wot, const void* bo, void* out, void* t2,
                                         int p, int h, int w, int c, int heads, float eps,
                                         int dtype, void* stream) {
  if (s == nullptr || t2 == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(x, s, ln_g, ln_b, wqkv, bqkv, wot, bo, out, t2, p, h, w, c, heads, eps,
                        dtype, stream);
}
