// Deterministic sum of a per-element term to one scalar, shared by the STE
// backward kernels (quant_det_bwd.cu and quant_rand.cu, each in one launch;
// the QAT products' clip cotangents in a second, qat_matmul.cu), and the
// block max of the amax encodes (fake_quant.cu, quant_pack_amax.cu).
//
// The TPU kernels accumulated the scalar clip cotangent in a (1, 1) block
// across their sequential grid. Blocks here run in no order, so pass 1
// writes one partial sum per block (a fixed-order tree) and pass 2 reduces
// the partials in one block: the last block of the same launch (B2 and B6,
// fold_by_last_block), or a second launch (fold_partials). The grid size
// depends only on n and the card, so the result is the same on every run;
// no sum takes an atomic.
#pragma once

#include "fp8_common.cuh"

namespace fp8 {

// The workspace of fold_by_last_block that B2 and B6 share (allocated and
// zeroed once a device by the wrapper): the ticket word, alone on a
// 128-byte line, then room for the partials of any grid of kFoldPartials
// blocks or fewer.
constexpr int kFoldTicketFloats = 32;
constexpr int kFoldPartials = 8192;   // >= any grid of those kernels (fp8::kMaxBlocks)
constexpr int kFoldWorkspaceFloats = kFoldTicketFloats + kFoldPartials;

// Blocks of pass 1 for n elements on the first port's pattern (one element a
// thread, at most 1024 blocks): the dx finish and B2's copy probe.
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

// The block's sum of v in a fixed order with fewer barriers than block_sum:
// a shuffle tree in each warp (lane i takes lane i + 16, 8, 4, 2, 1), then
// warp 0 the same over the eight warp sums. Valid in thread 0. ``sh`` holds
// kThreads / 32 floats.
__device__ __forceinline__ float block_sum_shfl(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? sh[lane] : 0.0f;
#pragma unroll
    for (int o = kThreads / 64; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  }
  return v;
}

// The block's max of v: a shuffle max in each warp, then thread 0 over the
// eight warp maxima; exact in any order, one barrier (the per-row amax of
// quant_pack_amax.cu and fake_quant.cu). Valid in thread 0. ``sh`` holds
// kThreads / 32 floats.
__device__ __forceinline__ float block_max_shfl(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) v = fmaxf(v, sh[w]);
  }
  return v;
}

// Pass 2 in the same launch (B2): thread 0 of each block stores
// the block's total (block_sum_shfl) into partial[blockIdx.x] and takes a
// ticket (an acq_rel atomic: the partial is visible before the ticket
// moves); the block that takes the last ticket folds every partial into
// out[0] (each thread's strided share, then block_sum_shfl; the acquire and
// the barrier make every partial visible to its threads) and sets the
// ticket back to 0 for the next launch. Which block is last does not change
// the sum. The launch's tail (a ticket round trip, then one block reading
// every partial) grows with the blocks, so callers keep grids small where n
// is. ``ticket`` is a zeroed word that launches on one stream share; two
// launches that overlap in time (two streams, or calls captured into a
// graph and replayed concurrently) must not share it. Every thread of the
// block calls it; ``sh`` holds kThreads / 32 floats.
__device__ __forceinline__ void fold_by_last_block(float v, float* __restrict__ partial,
                                                   unsigned int* __restrict__ ticket,
                                                   float* __restrict__ out, float* sh) {
  __shared__ int last;
  const float total = block_sum_shfl(v, sh);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = total;
    unsigned int t;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(t) : "l"(ticket) : "memory");
    last = t == gridDim.x - 1u;
  }
  __syncthreads();
  if (!last) return;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) acc += __ldcg(partial + i);
  const float sum = block_sum_shfl(acc, sh);
  if (threadIdx.x == 0) {
    out[0] = sum;
    *ticket = 0u;
  }
}

}  // namespace fp8
