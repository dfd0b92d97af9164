// The wire encodes with a fused per-row amax: the FP8 encode plus max|x|
// (quant_pack_amax_tiles) and the FP4 encode plus max|x|
// (quant_pack_sub_amax_tiles), for delayed scaling.
//
// Replace the TPU kernels src/repro/kernels/fp8_quant.py::quant_pack_amax_tiles
// (_quant_pack_det_amax_kernel, _quant_pack_rand_ctr_amax_kernel) and
// quant_pack_sub_amax_tiles (_quant_pack_sub_det_amax_kernel,
// _quant_pack_sub_rand_ctr_amax_kernel). core/codec.py encode_scaled(
// with_amax=True) launches them on a delayed-scaling leg (core/scaling.py
// DelayedScaling): next round's amax history row comes out of this round's
// quantize launch, with no reduction of its own over the model.
//
// Outputs: the codes, bitwise those of quant_pack.cu (K = 1) or
// quant_pack_sub.cu (K = 2), both from fp8_common.cuh::pack_code over the
// same element-index counter RNG; and rowmax[r] = max_c |x[r, c]| of the RAW
// (unclipped) row.
//
// Bound: memory. Per element it reads 4 bytes of x and writes 1 / K bytes,
// plus 4 bytes of alpha and 4 bytes of rowmax per row (the (R, 1) column).
// Design: one 256-thread block per 1024-lane row; each thread encodes its
// bytes of the row (1024 / K / 256 of them) while keeping max|x|, then the
// block reduces the 256 maxima in shared memory. Float max is exact in any
// order, so the result is deterministic without atomics. K, the codes per
// byte, is a template parameter: the two wrappers launch quant_pack_amax_kernel
// <1> and <2>, which a profile tells apart, and the inner loop unrolls.
#include "reduce.cuh"

template <int K>
__global__ void quant_pack_amax_kernel(const float* __restrict__ x,
                                       const float* __restrict__ a2, int a_cols,
                                       const uint32_t* __restrict__ key,
                                       uint8_t* __restrict__ out,
                                       float* __restrict__ rowmax,
                                       long long rows, fp8::Fmt f) {
  __shared__ float sh[fp8::kThreads];
  const long long r = blockIdx.x;
  if (r >= rows) return;
  const bool stochastic = key != nullptr;
  const uint32_t k0 = stochastic ? key[0] : 0u;
  const uint32_t k1 = stochastic ? key[1] : 0u;
  const int bits = 1 + f.exp + f.mant;
  constexpr int row_bytes = fp8::kLane / K;
  float mx = 0.0f;
  for (int j = threadIdx.x; j < row_bytes; j += blockDim.x) {
    int byte = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const long long e = r * fp8::kLane + (long long)j * K + t;
      const float xe = x[e];
      mx = fmaxf(mx, fabsf(xe));
      const float a = a2[a_cols == 1 ? r : e];
      byte |= fp8::pack_code(xe, a, f, stochastic, (uint32_t)e, k0, k1)
              << (bits * t);
    }
    out[r * row_bytes + j] = (uint8_t)byte;
  }
  const float m = fp8::block_max(mx, sh);
  if (threadIdx.x == 0) rowmax[r] = m;
}

extern "C" int repro_quant_pack_amax_tiles(const float* x, const float* a2,
                                           int a_cols, const uint32_t* key,
                                           uint8_t* out, float* rowmax,
                                           long long rows, int k, int exp,
                                           int mant, float mant_const,
                                           cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  const int grid = rows > 0 ? (int)rows : 1;
  if (k == 1) {
    quant_pack_amax_kernel<1><<<grid, fp8::kThreads, 0, stream>>>(
        x, a2, a_cols, key, out, rowmax, rows, f);
  } else if (k == 2) {
    quant_pack_amax_kernel<2><<<grid, fp8::kThreads, 0, stream>>>(
        x, a2, a_cols, key, out, rowmax, rows, f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
