// HRFormer transformer block in one pass (eval), for Hopper (sm_90a): kernel 7.
//
// Replaces: i2rnet_tpu/ops/pallas/hrformer_block.py::full_block_fused
// (_block_kernel, :218-234).
//
// Computes, on a [P, H, W, C] map with T the activation type,
//     xa  = x + WindowMHSA(LN1(x))      Kernel E's arithmetic (window_attn.cuh)
//     out = xa + MlpDWBN(LN2(xa))       Kernel F's arithmetic (mlp_dwbn.cuh)
// with xa rounded to T between the halves, as _block_kernel hands
// _attn_math's result to _mlp_math. Both halves run the bodies that Kernels
// E and F run, item for item, so out is bit-equal to F(E(x)).
//
// What bounds it on the H100: per person at branch 0 of a 256x192 input
// (64x48x78) E's products (0.22 GFLOP) plus F's (0.32 GFLOP) against one
// read and one write of the map in bf16 (0.96 MB): about 0.54 us at the bf16
// tensor-core peak and 0.29 us at the memory rate, so the operations bound
// it. Its products run on CUDA cores in f32, as E's and F's do, so the FMA
// rate and the shared-memory reads that feed it bound it in practice. What it
// saves against E then F is one launch and F's read of E's output from
// device memory (the map stays in L2 between the phases where it fits).
//
// Design: the Pallas kernel keeps a person's whole [H, W, C] map in VMEM and
// runs both halves on it. The depthwise 3x3 of the MLP half reads one pixel
// across every window border, so the pixels next to a window need the
// attention output of the neighbouring windows, and a person's map at branch
// 0 (479 KB in bf16) outgrows an SM's 227 KB of shared memory. So this is one
// cooperative, persistent launch in two phases:
//   phase 1: E's work per (7x7 window, person), written to the scratch map xa
//            [P, H, W, C] in T, which the wrapper allocates;
//   a grid-wide barrier (cooperative_groups::this_grid().sync());
//   phase 2: F's work per (8x8 or 4x4 tile, person), reading xa with its
//            1-pixel halo and writing out.
// Each block walks each phase's items in steps of the grid. The grid is as
// many blocks as the card holds at once (SMs x blocks per SM for this shared
// memory and these registers), at most the larger phase's item count; shared
// memory is the larger of the two phases' needs. xa is read in phase 2
// through plain loads (no __restrict__, no __ldg): the read-only path is not
// coherent with writes made earlier in the same launch.
// Not built: recomputing the neighbouring windows' attention for each tile's
// halo inside one block (about 5x E's projection work per window, and K/V of
// nine windows do not fit shared memory at C = 624).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mlp_dwbn.cuh"
#include "window_attn.cuh"

namespace {

// Registers: each phase is a function of its own, not inlined, so ptxas
// allocates registers for each body apart, and the kernel asks for 3 blocks
// per SM, which caps them at 80 a thread. So the bodies do not spill, and
// kernel 7 runs 3 blocks per SM where shared memory allows it. Left alone,
// ptxas gives the kernel 128 registers (2 blocks per SM); capped at 64 (4
// blocks per SM), the inlined bodies spill. PERF.md has the measured sweep.
template <typename T>
__device__ __noinline__ void attn_phase(const T* __restrict__ x, const float* __restrict__ ln1_g,
                                        const float* __restrict__ ln1_b,
                                        const T* __restrict__ wqkv,
                                        const float* __restrict__ bqkv,
                                        const T* __restrict__ wot, const float* __restrict__ bo,
                                        T* __restrict__ xa, int p, int h, int w, int c, int heads,
                                        float eps, unsigned char* smem_raw) {
  const int nwin = ((h + kWin - 1) / kWin) * ((w + kWin - 1) / kWin);
  for (int i = blockIdx.x; i < nwin * p; i += gridDim.x) {
    __syncthreads();  // the previous item's last reads of shared memory
    window_attn_item<T, false>(x, nullptr, ln1_g, ln1_b, wqkv, bqkv, wot, bo, xa, nullptr, h, w,
                               c, heads, eps, i % nwin, i / nwin, nwin, smem_raw);
  }
}

template <typename T>
__device__ __noinline__ void mlp_phase(const T* xa, const float* __restrict__ ln2_g,
                                       const float* __restrict__ ln2_b,
                                       const T* __restrict__ w1t, const float* __restrict__ b1,
                                       const float* __restrict__ dwt,
                                       const float* __restrict__ bdw,
                                       const T* __restrict__ w2t, const float* __restrict__ b2,
                                       T* __restrict__ out, int p, int h, int w, int c, int dh,
                                       float eps, int th, int tw, unsigned char* smem_raw) {
  const int ntile = ((h + th - 1) / th) * ((w + tw - 1) / tw);
  for (int i = blockIdx.x; i < ntile * p; i += gridDim.x) {
    __syncthreads();
    mlp_item<T, T, true>(xa, ln2_g, ln2_b, w1t, b1, dwt, bdw, w2t, b2, out, h, w, c, dh, eps, th,
                         tw, i % ntile, i / ntile, smem_raw);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
full_block_kernel(const T* __restrict__ x, const float* __restrict__ ln1_g,
                  const float* __restrict__ ln1_b, const T* __restrict__ wqkv,
                  const float* __restrict__ bqkv, const T* __restrict__ wot,
                  const float* __restrict__ bo, const float* __restrict__ ln2_g,
                  const float* __restrict__ ln2_b, const T* __restrict__ w1t,
                  const float* __restrict__ b1, const float* __restrict__ dwt,
                  const float* __restrict__ bdw, const T* __restrict__ w2t,
                  const float* __restrict__ b2, T* xa, T* __restrict__ out, int p, int h, int w,
                  int c, int heads, int dh, float eps, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attn_phase<T>(x, ln1_g, ln1_b, wqkv, bqkv, wot, bo, xa, p, h, w, c, heads, eps, smem_raw);
  cooperative_groups::this_grid().sync();  // every pixel of xa written and visible
  mlp_phase<T>(xa, ln2_g, ln2_b, w1t, b1, dwt, bdw, w2t, b2, out, p, h, w, c, dh, eps, th, tw,
               smem_raw);
}

template <typename T>
using FullBlockKernel = void (*)(const T*, const float*, const float*, const T*, const float*,
                                 const T*, const float*, const float*, const float*, const T*,
                                 const float*, const float*, const float*, const T*, const float*,
                                 T*, T*, int, int, int, int, int, int, float, int, int);

// The launch's shape: tile edge, shared memory, blocks per SM and grid.
struct Plan {
  int tile, per_sm, grid;
  size_t bytes;
};

template <typename T>
cudaError_t plan(int p, int h, int w, int c, int heads, Plan* out) {
  const int t = mlp_tile<T>(c);
  const size_t attn = attn_smem_bytes<T>(c, c / heads), mlp = mlp_smem_bytes<T>(c, t, t);
  const size_t bytes = attn > mlp ? attn : mlp;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  FullBlockKernel<T> kernel = full_block_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;  // no block fits an SM
  const long items1 = (long)((h + kWin - 1) / kWin) * ((w + kWin - 1) / kWin) * p;
  const long items2 = (long)((h + t - 1) / t) * ((w + t - 1) / t) * p;
  const long items = items1 > items2 ? items1 : items2;
  const long resident = (long)sms * per_sm;
  *out = Plan{t, per_sm, (int)(items < resident ? items : resident), bytes};
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* ln1_g, const void* ln1_b, const void* wqkv,
                   const void* bqkv, const void* wot, const void* bo, const void* ln2_g,
                   const void* ln2_b, const void* w1t, const void* b1, const void* dwt,
                   const void* bdw, const void* w2t, const void* b2, void* xa, void* out, int p,
                   int h, int w, int c, int heads, int dh, float eps, cudaStream_t stream) {
  Plan pl;
  cudaError_t err = plan<T>(p, h, w, c, heads, &pl);
  if (err != cudaSuccess) return err;
  int th = pl.tile, tw = pl.tile;
  const T* a_x = static_cast<const T*>(x);
  const float* a_ln1_g = static_cast<const float*>(ln1_g);
  const float* a_ln1_b = static_cast<const float*>(ln1_b);
  const T* a_wqkv = static_cast<const T*>(wqkv);
  const float* a_bqkv = static_cast<const float*>(bqkv);
  const T* a_wot = static_cast<const T*>(wot);
  const float* a_bo = static_cast<const float*>(bo);
  const float* a_ln2_g = static_cast<const float*>(ln2_g);
  const float* a_ln2_b = static_cast<const float*>(ln2_b);
  const T* a_w1t = static_cast<const T*>(w1t);
  const float* a_b1 = static_cast<const float*>(b1);
  const float* a_dwt = static_cast<const float*>(dwt);
  const float* a_bdw = static_cast<const float*>(bdw);
  const T* a_w2t = static_cast<const T*>(w2t);
  const float* a_b2 = static_cast<const float*>(b2);
  T* a_xa = static_cast<T*>(xa);
  T* a_out = static_cast<T*>(out);
  void* args[] = {&a_x,   &a_ln1_g, &a_ln1_b, &a_wqkv, &a_bqkv, &a_wot, &a_bo, &a_ln2_g, &a_ln2_b,
                  &a_w1t, &a_b1,    &a_dwt,   &a_bdw,  &a_w2t,  &a_b2,  &a_xa, &a_out,   &p,
                  &h,     &w,       &c,       &heads,  &dh,     &eps,   &th,   &tw};
  FullBlockKernel<T> kernel = full_block_kernel<T>;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(pl.grid),
                                    dim3(kThreads), args, pl.bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int p, int h, int w, int c, int heads) {
  return p < 1 || h < 1 || w < 1 || heads < 1 || c < heads || c % heads;
}

}  // namespace

// x, out, xa (scratch, written then read by the launch): [p, h, w, c]
// contiguous, type T (dtype 0 = float32, 1 = bfloat16). The attention half's
// weights as Kernel E takes them (i2r_window_attn_fwd: ln1 [c] f32, wqkv
// [c][heads][3][d] in T with q pre-scaled, bqkv [heads][3][d] f32, Wo^T [c][c]
// in T, bo [c] f32); the MLP half's as Kernel F takes them (i2r_mlp_block_fwd:
// ln2 [c] f32, W1^T [c][dh] and W2^T [dh][c] in T, dwt [3][3][dh], b1, bdw,
// b2 f32). One LayerNorm eps for both halves. Window 7. Returns the
// cudaError_t of the launch: cudaErrorInvalidValue for shapes it does not
// take, cudaErrorCooperativeLaunchTooLarge when no block fits an SM, and the
// cooperative launch's own error when the card refuses it.
extern "C" int i2r_full_block_fwd(const void* x, const void* ln1_g, const void* ln1_b,
                                  const void* wqkv, const void* bqkv, const void* wot,
                                  const void* bo, const void* ln2_g, const void* ln2_b,
                                  const void* w1t, const void* b1, const void* dwt,
                                  const void* bdw, const void* w2t, const void* b2, void* xa,
                                  void* out, int p, int h, int w, int c, int heads, int dh,
                                  float eps, int dtype, void* stream) {
  if (bad_shape(p, h, w, c, heads) || dh < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, ln1_g, ln1_b, wqkv, bqkv, wot, bo, ln2_g, ln2_b, w1t, b1, dwt,
                              bdw, w2t, b2, xa, out, p, h, w, c, heads, dh, eps, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, ln1_g, ln1_b, wqkv, bqkv, wot, bo, ln2_g, ln2_b, w1t, b1,
                                      dwt, bdw, w2t, b2, xa, out, p, h, w, c, heads, dh, eps, st);
  return (int)cudaErrorInvalidValue;
}

// The shape kernel 7 launches with for a [p, h, w, c] map of type dtype on the
// current device: blocks per SM (the occupancy at its shared memory and
// registers), grid, dynamic shared memory in bytes and the MLP phase's tile
// edge, written to out[0..3]. Returns the cudaError_t, as i2r_full_block_fwd.
extern "C" int i2r_full_block_plan(int p, int h, int w, int c, int heads, int dtype, int* out) {
  if (bad_shape(p, h, w, c, heads) || out == nullptr) return (int)cudaErrorInvalidValue;
  Plan pl;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = plan<float>(p, h, w, c, heads, &pl);
  if (dtype == 1) err = plan<__nv_bfloat16>(p, h, w, c, heads, &pl);
  if (err != cudaSuccess) return (int)err;
  out[0] = pl.per_sm;
  out[1] = pl.grid;
  out[2] = (int)pl.bytes;
  out[3] = pl.tile;
  return 0;
}
