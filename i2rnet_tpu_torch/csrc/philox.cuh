// Counter-based dropout bits shared by the training kernels (mhsa_train.cu,
// encoder_ffn_train.cu).
//
// Philox4x32-10 (Salmon et al., SC'11; the generator behind torch's CUDA
// dropout), keyed by (seed, offset) and counted by (c0, c1, c2, 0); the
// dropout bit of an element is output word 0. The attention kernel counts
// (key column, query row, batch*head); the FFN kernel (column, row, 0), with
// one offset per dropout site. ops/cuda/dropout.py::philox_bits computes the
// same words with torch integer ops, so a kernel and its plain version drop
// the same elements. An element is kept where bits >= threshold(rate) =
// min(round(rate * 2^32), 2^32 - 1), as ops/pallas/prng.py::keep_mask.

#pragma once

#include <stdint.h>

namespace i2r {

__device__ __forceinline__ uint32_t philox_word0(uint32_t seed, uint32_t offset, uint32_t c0,
                                                 uint32_t c1, uint32_t c2) {
  uint32_t k0 = seed, k1 = offset;
  uint32_t x0 = c0, x1 = c1, x2 = c2, x3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, x0), lo0 = 0xD2511F53u * x0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, x2), lo1 = 0xCD9E8D57u * x2;
    x0 = hi1 ^ x1 ^ k0;
    x1 = lo1;
    x2 = hi0 ^ x3 ^ k1;
    x3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return x0;
}

}  // namespace i2r
