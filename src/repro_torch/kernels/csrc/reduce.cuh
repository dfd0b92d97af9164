// Deterministic two-pass sum of a per-element term to one scalar, shared by
// the STE backward kernels (quant_det_bwd.cu, quant_rand.cu), and the block
// max of the amax encodes (quant_pack_amax.cu).
//
// The TPU kernels accumulated the scalar clip cotangent in a (1, 1) block
// across their sequential grid. Blocks here run in no order, so pass 1
// writes one partial sum per block (fixed-order tree in shared memory) and
// pass 2 reduces the partials in one block. The grid size depends only on
// n, so the result is the same on every run, without atomics.
#pragma once

#include "fp8_common.cuh"

namespace fp8 {

// Blocks of pass 1 for n elements; the wrapper sizes the partials with it
// (through repro_quant_det_bwd_blocks) so both sides agree on the grid.
inline int bwd_blocks(long long n) {
  return grid_for(n) < 1024 ? grid_for(n) : 1024;
}

__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  return sh[0];
}

// The same fixed tree with fmaxf: exact in any order (the per-row amax of
// quant_pack_amax.cu).
__device__ __forceinline__ float block_max(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) sh[threadIdx.x] = fmaxf(sh[threadIdx.x], sh[threadIdx.x + w]);
    __syncthreads();
  }
  return sh[0];
}

// Pass 2 in one block of kThreads: the per-block partials of pass 1 folded
// into out[0], each thread's strided share then the fixed tree.
__device__ __forceinline__ void fold_partials(const float* __restrict__ partial,
                                              int n_parts, float* __restrict__ out,
                                              float* sh) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_parts; i += kThreads) acc += partial[i];
  const float total = block_sum(acc, sh);
  if (threadIdx.x == 0) out[0] = total;
}

}  // namespace fp8

// Pass 2 as a kernel. Static, so each translation unit that includes this
// header has its own.
static __global__ void sum_partials_kernel(const float* __restrict__ partial,
                                           int n_parts,
                                           float* __restrict__ out) {
  __shared__ float sh[fp8::kThreads];
  fp8::fold_partials(partial, n_parts, out, sh);
}
