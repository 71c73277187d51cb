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
// it. In bf16 both halves run on the tensor cores, E's in its two passes
// (window_attn_block.cu), F's in its slices (mlp_dwbn.cu); in f32 both run
// their CUDA-core templates. What it saves against E then F is the launches
// and F's read of E's output from device memory (the map stays in L2 between
// the phases where it fits); what it costs is a grid-wide barrier after each
// phase, with the grid capped at the blocks the card holds at once.
//
// Design: the Pallas kernel keeps a person's whole [H, W, C] map in VMEM and
// runs both halves on it. The depthwise 3x3 of the MLP half reads one pixel
// across every window border, so the pixels next to a window need the
// attention output of the neighbouring windows, and a person's map at branch
// 0 (479 KB in bf16) outgrows an SM's 227 KB of shared memory. So this is one
// cooperative, persistent launch in phases:
//   phase 1: E's work, written to the scratch map xa [P, H, W, C] in T, which
//            the wrapper allocates: in f32 per (7x7 window, person); in bf16
//            E's pass 1 per (window, head group, person) of E's plan
//            (ops/cuda/hrformer_block.py::attn_plan) into the scratch o
//            [P, H, W, C], a grid-wide barrier, then E's pass 2 per (64 rows,
//            column block) into xa; where a block holds all heads, pass 1
//            alone, with its out-projection, into xa;
//   a grid-wide barrier (cooperative_groups::this_grid().sync());
//   phase 2: F's work per (output tile, hidden slice, person) of F's plan
//            (ops/cuda/mlp_dwbn.py::mlp_plan), reading xa with its 1-pixel
//            halo and writing out, or with several slices the slices' f32
//            sums to the scratch part [S, P, H, W, C];
//   with several slices, a second grid-wide barrier and
//   phase 3: F's fixed-order sum of the slices and its epilogue per element.
// Each block walks each phase's items in steps of the grid. The grid is as
// many blocks as the card holds at once (SMs x blocks per SM for this shared
// memory and these registers), at most the largest phase's item count;
// shared memory is the largest of the phases' needs. o, xa and part are read
// through plain loads (no __restrict__, no __ldg): the read-only path is not
// coherent with writes made earlier in the same launch.
// Not built: recomputing the neighbouring windows' attention for each tile's
// halo inside one block (about 5x E's projection work per window, and K/V of
// nine windows do not fit shared memory at C = 624).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mlp_dwbn.cuh"
#include "window_attn.cuh"

namespace {

// Registers: each phase is a function of its own, not inlined, so ptxas
// allocates registers for each body apart, and the kernel asks for 2 blocks
// per SM, which caps them at 128 a thread; shared memory holds kernel 7 at 2
// blocks per SM on most maps in bf16 anyway (F's slice buffer, E's tiles).
// PERF.md has the measured sweep (probes/kernel7_sweep.py).
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

// E's bf16 pass 1 per (window, head group, person) item, as attn_mma_kernel
// numbers them, into o (or, with all heads in a block, through the
// out-projection into xa)
__device__ __noinline__ void attn_mma_phase(const __nv_bfloat16* __restrict__ x,
                                            const float* __restrict__ ln1_g,
                                            const float* __restrict__ ln1_b,
                                            const uint2* __restrict__ wf,
                                            const float* __restrict__ bqkv,
                                            const uint2* __restrict__ wof,
                                            const float* __restrict__ bo, __nv_bfloat16* o,
                                            __nv_bfloat16* xa, int p, int h, int w, int c,
                                            int heads, int group, float eps,
                                            unsigned char* smem_raw) {
  const int nwin = ((h + kWin - 1) / kWin) * ((w + kWin - 1) / kWin);
  const int per = nwin * (heads / group);
  for (int i = blockIdx.x; i < per * p; i += gridDim.x) {
    __syncthreads();
    const int j = i % per;
    attn_item_mma<false>(x, ln1_g, ln1_b, wf, bqkv, nullptr, wof, bo, o, xa, nullptr, h, w, c,
                         heads, group, eps, j % nwin, j / nwin, i / per, nwin, smem_raw);
  }
}

// E's bf16 pass 2 per (row block, column block) item, from o into xa
__device__ __noinline__ void attn_out_phase(const __nv_bfloat16* o,
                                            const __nv_bfloat16* __restrict__ x,
                                            const uint2* __restrict__ wof,
                                            const float* __restrict__ bo, __nv_bfloat16* xa,
                                            int p, int h, int w, int c, int cols,
                                            unsigned char* smem_raw) {
  const int rows = p * h * w, nrb = (rows + kRows - 1) / kRows;
  const int ncb = (amma::pad16(c) / 8 + cols - 1) / cols;
  for (int i = blockIdx.x; i < nrb * ncb; i += gridDim.x) {
    __syncthreads();
    attn_out_mma<false>(o, x, nullptr, wof, bo, xa, rows, h * w, c, cols, i % nrb, i / nrb,
                        smem_raw);
  }
}

// F's body per (tile, slice, person) item: the bf16 tensor-core body for T =
// bf16 (w1, w2 its fragments), the CUDA-core template for f32 (one slice)
template <typename T>
__device__ __noinline__ void mlp_phase(const T* xa, const float* __restrict__ ln2_g,
                                       const float* __restrict__ ln2_b,
                                       const T* __restrict__ w1, const float* __restrict__ b1,
                                       const float* __restrict__ dwt,
                                       const float* __restrict__ bdw,
                                       const T* __restrict__ w2, const float* __restrict__ b2,
                                       T* __restrict__ out, float* part, int p, int h, int w,
                                       int c, int dh, float eps, int th, int tw, int slices,
                                       unsigned char* smem_raw) {
  const int ntile = ((h + th - 1) / th) * ((w + tw - 1) / tw);
  for (int i = blockIdx.x; i < ntile * slices * p; i += gridDim.x) {
    __syncthreads();
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      mlp_item_mma(xa, ln2_g, ln2_b, reinterpret_cast<const uint2*>(w1), b1, dwt, bdw,
                   reinterpret_cast<const uint2*>(w2), b2, out, part, p, h, w, c, dh, eps, th, tw,
                   slices, i % ntile, (i / ntile) % slices, i / (ntile * slices), smem_raw);
    else
      mlp_item<T>(xa, ln2_g, ln2_b, w1, b1, dwt, bdw, w2, b2, out, h, w, c, dh, eps, th, tw,
                  i % ntile, i / ntile, smem_raw);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
full_block_kernel(const T* __restrict__ x, const float* __restrict__ ln1_g,
                  const float* __restrict__ ln1_b, const T* __restrict__ wqkv,
                  const float* __restrict__ bqkv, const T* __restrict__ wot,
                  const float* __restrict__ bo, const float* __restrict__ ln2_g,
                  const float* __restrict__ ln2_b, const T* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ dwt,
                  const float* __restrict__ bdw, const T* __restrict__ w2,
                  const float* __restrict__ b2, const uint2* __restrict__ wf,
                  const uint2* __restrict__ wof, T* o, T* xa, float* part, T* __restrict__ out,
                  int p, int h, int w, int c, int heads, int dh, float eps, int group, int cols,
                  int th, int tw, int slices) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    attn_mma_phase(x, ln1_g, ln1_b, wf, bqkv, wof, bo, o, xa, p, h, w, c, heads, group, eps,
                   smem_raw);
    if (group < heads) {  // the same for every block
      cooperative_groups::this_grid().sync();  // every head's columns of o written and visible
      attn_out_phase(o, x, wof, bo, xa, p, h, w, c, cols, smem_raw);
    }
  } else {
    attn_phase<T>(x, ln1_g, ln1_b, wqkv, bqkv, wot, bo, xa, p, h, w, c, heads, eps, smem_raw);
  }
  cooperative_groups::this_grid().sync();  // every pixel of xa written and visible
  mlp_phase<T>(xa, ln2_g, ln2_b, w1, b1, dwt, bdw, w2, b2, out, part, p, h, w, c, dh, eps, th, tw,
               slices, smem_raw);
  if (slices == 1) return;  // the same for every block
  cooperative_groups::this_grid().sync();  // every slice's sums written and visible
  const size_t n = (size_t)p * h * w * c;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads)
    mlp_finish(xa, part, b2, out, n, c, slices, i);
}

template <typename T>
using FullBlockKernel = void (*)(const T*, const float*, const float*, const T*, const float*,
                                 const T*, const float*, const float*, const float*, const T*,
                                 const float*, const float*, const float*, const T*, const float*,
                                 const uint2*, const uint2*, T*, T*, float*, T*, int, int, int, int,
                                 int, int, float, int, int, int, int, int);

// The launch's shape: blocks per SM, grid, the MLP phase's tile, shared memory.
struct Plan {
  int per_sm, grid, th, tw;
  size_t bytes;
};

// bf16: E's plan (head groups of `group`, `cols` n-tiles a block of pass 2)
// and F's (th x tw tiles, `slices` hidden slices) come from the wrapper
// (ops/cuda/hrformer_block.py::attn_plan, ops/cuda/mlp_dwbn.py::mlp_plan);
// f32 takes group = cols = th = tw = 0 and one slice, and the CUDA-core
// templates their own items (mlp_tile).
template <typename T>
cudaError_t plan(int p, int h, int w, int c, int heads, int dh, int group, int cols, int th,
                 int tw, int slices, Plan* out) {
  constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;
  const long nwin = (long)((h + kWin - 1) / kWin) * ((w + kWin - 1) / kWin);
  long items1 = nwin * p;
  size_t attn;
  if (!kMma) {
    if (group != 0 || cols != 0 || th != 0 || tw != 0 || slices != 1) return cudaErrorInvalidValue;
    th = tw = mlp_tile<T>(c);
    attn = attn_smem_bytes<T>(c, c / heads);
  } else {
    if (!mlp_mma_fits(c, h, w, th, tw, dh, slices) || !attn_mma_fits(c, heads, group, cols))
      return cudaErrorInvalidValue;
    const bool fused = group == heads;  // no pass 2
    const size_t b1 = attn_mma_smem_bytes(c, c / heads, fused), b2 = attn_out_smem_bytes(c);
    attn = b1 > b2 || fused ? b1 : b2;
    const long rows = (long)p * h * w;
    const long items1b = (rows + kRows - 1) / kRows * ((amma::pad16(c) / 8 + cols - 1) / cols);
    items1 *= heads / group;
    if (!fused && items1b > items1) items1 = items1b;
  }
  const size_t mlp =
      kMma ? mlp_mma_smem_bytes(c, h, w, th, tw, dh, slices) : mlp_smem_bytes<T>(c, th, tw);
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
  const long items2 = (long)((h + th - 1) / th) * ((w + tw - 1) / tw) * slices * p;
  const long items = items1 > items2 ? items1 : items2;
  const long resident = (long)sms * per_sm;
  *out = Plan{per_sm, (int)(items < resident ? items : resident), th, tw, bytes};
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* ln1_g, const void* ln1_b, const void* wqkv,
                   const void* bqkv, const void* wot, const void* bo, const void* ln2_g,
                   const void* ln2_b, const void* w1, const void* b1, const void* dwt,
                   const void* bdw, const void* w2, const void* b2, const void* wf,
                   const void* wof, void* o, void* xa, void* part, void* out, int p, int h, int w,
                   int c, int heads, int dh, float eps, int group, int cols, int th, int tw,
                   int slices, cudaStream_t stream) {
  if (slices > 1 && part == nullptr) return cudaErrorInvalidValue;
  if (std::is_same_v<T, __nv_bfloat16> && group < heads && o == nullptr)
    return cudaErrorInvalidValue;
  Plan pl;
  cudaError_t err = plan<T>(p, h, w, c, heads, dh, group, cols, th, tw, slices, &pl);
  if (err != cudaSuccess) return err;
  th = pl.th;
  tw = pl.tw;
  const T* a_x = static_cast<const T*>(x);
  const float* a_ln1_g = static_cast<const float*>(ln1_g);
  const float* a_ln1_b = static_cast<const float*>(ln1_b);
  const T* a_wqkv = static_cast<const T*>(wqkv);
  const float* a_bqkv = static_cast<const float*>(bqkv);
  const T* a_wot = static_cast<const T*>(wot);
  const float* a_bo = static_cast<const float*>(bo);
  const float* a_ln2_g = static_cast<const float*>(ln2_g);
  const float* a_ln2_b = static_cast<const float*>(ln2_b);
  const T* a_w1 = static_cast<const T*>(w1);
  const float* a_b1 = static_cast<const float*>(b1);
  const float* a_dwt = static_cast<const float*>(dwt);
  const float* a_bdw = static_cast<const float*>(bdw);
  const T* a_w2 = static_cast<const T*>(w2);
  const float* a_b2 = static_cast<const float*>(b2);
  const uint2* a_wf = static_cast<const uint2*>(wf);
  const uint2* a_wof = static_cast<const uint2*>(wof);
  T* a_o = static_cast<T*>(o);
  T* a_xa = static_cast<T*>(xa);
  float* a_part = static_cast<float*>(part);
  T* a_out = static_cast<T*>(out);
  void* args[] = {&a_x,   &a_ln1_g, &a_ln1_b, &a_wqkv, &a_bqkv, &a_wot,  &a_bo,  &a_ln2_g,
                  &a_ln2_b, &a_w1,   &a_b1,    &a_dwt,  &a_bdw,  &a_w2,   &a_b2,  &a_wf,
                  &a_wof,  &a_o,    &a_xa,    &a_part, &a_out,  &p,      &h,     &w,
                  &c,      &heads,  &dh,      &eps,    &group,  &cols,   &th,    &tw,
                  &slices};
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
// weights, group, cols and o (bf16 scratch [p, h, w, c], written then read;
// unused in f32) as Kernel E takes them (i2r_window_attn_fwd); the MLP
// half's, th, tw, slices and part (f32 scratch of slices * p * h * w * c
// where slices > 1) as Kernel F takes them (i2r_mlp_block_fwd). One
// LayerNorm eps for both halves.
// Window 7. Returns the cudaError_t of the launch: cudaErrorInvalidValue for
// shapes or plans it does not take, cudaErrorCooperativeLaunchTooLarge when no
// block fits an SM, and the cooperative launch's own error when the card
// refuses it.
extern "C" int i2r_full_block_fwd(const void* x, const void* ln1_g, const void* ln1_b,
                                  const void* wqkv, const void* bqkv, const void* wot,
                                  const void* bo, const void* ln2_g, const void* ln2_b,
                                  const void* w1, const void* b1, const void* dwt,
                                  const void* bdw, const void* w2, const void* b2,
                                  const void* wf, const void* wof, void* o, void* xa, void* part,
                                  void* out, int p, int h, int w, int c, int heads, int dh,
                                  int group, int cols, int th, int tw, int slices, float eps,
                                  int dtype, void* stream) {
  if (bad_shape(p, h, w, c, heads) || dh < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, ln1_g, ln1_b, wqkv, bqkv, wot, bo, ln2_g, ln2_b, w1, b1, dwt,
                              bdw, w2, b2, wf, wof, o, xa, part, out, p, h, w, c, heads, dh, eps,
                              group, cols, th, tw, slices, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, ln1_g, ln1_b, wqkv, bqkv, wot, bo, ln2_g, ln2_b, w1, b1,
                                      dwt, bdw, w2, b2, wf, wof, o, xa, part, out, p, h, w, c,
                                      heads, dh, eps, group, cols, th, tw, slices, st);
  return (int)cudaErrorInvalidValue;
}

// The shape kernel 7 launches with for a [p, h, w, c] map of type dtype and
// group, cols, th, tw, slices as i2r_full_block_fwd takes them, on the
// current device:
// blocks per SM (the occupancy at its shared memory and registers), grid,
// dynamic shared memory in bytes and the MLP phase's tile rows and columns,
// written to out[0..4]. Returns the cudaError_t, as i2r_full_block_fwd.
extern "C" int i2r_full_block_plan(int p, int h, int w, int c, int heads, int dh, int group,
                                   int cols, int th, int tw, int slices, int dtype, int* out) {
  if (bad_shape(p, h, w, c, heads) || dh < 1 || out == nullptr) return (int)cudaErrorInvalidValue;
  Plan pl;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = plan<float>(p, h, w, c, heads, dh, group, cols, th, tw, slices, &pl);
  if (dtype == 1)
    err = plan<__nv_bfloat16>(p, h, w, c, heads, dh, group, cols, th, tw, slices, &pl);
  if (err != cudaSuccess) return (int)err;
  out[0] = pl.per_sm;
  out[1] = pl.grid;
  out[2] = (int)pl.bytes;
  out[3] = pl.th;
  out[4] = pl.tw;
  return 0;
}
