// Kernel D's backward pass 1 at the wide widths (C above 128: the instances
// 176, 192 and 256 of ffn_tile.cuh's bwd_rows_kernel), for Hopper (sm_90a).
//
// Replaces: nothing by itself; part of Kernel D (encoder_ffn_train.cu,
// replacing i2rnet_tpu/ops/pallas/encoder_ffn_train.py::encoder_ffn_train),
// whose launch_bwd calls this entry for C above 128.
//
// Why a file of its own: these three instances hold 192-256 f32 values a
// thread and spill, and the compiler takes about as long on them as on the
// rest of encoder_ffn_train.cu; in their own file they compile beside it
// (build.py starts one nvcc per source), which keeps the build's longest
// compile near its length before the wide instances. The body, its bound and
// its design are ffn_tile.cuh's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_tile.cuh"

// Arguments as ffn::launch_bwd_rows's, Params and Dropout as their fields.
extern "C" int i2r_ffn_bwd_rows_wide(const void* x, const void* dout, const float* ln1_w,
                                     const float* ln1_b, const float* w1, const float* b1,
                                     const float* w2, const float* b2, const float* ln2_w,
                                     const float* ln2_b, void* dx, void* nb, void* ab, void* dyb,
                                     void* dab, float* vec_part, int rows, int c, int f,
                                     float eps, int grid, int vec, const uint32_t* bits1,
                                     const uint32_t* bits2, uint32_t seed, uint32_t offset,
                                     uint32_t threshold, float inv, int mode, cudaStream_t st) {
  const Params p{ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b};
  const Dropout dp{bits1, bits2, seed, offset, threshold, inv, mode};
  return (int)ffn::with_wide_cp(ffn::inst_cp(c), [&](auto k) {
    return ffn::launch_bwd_rows<decltype(k)::value>(x, dout, p, dx, nb, ab, dyb, dab, vec_part,
                                                    rows, c, f, eps, grid, vec, dp, st);
  });
}
