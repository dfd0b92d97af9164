// The wire encodes with a fused per-row amax: the FP8 encode plus max|x|
// (quant_pack_amax_tiles) and the FP4 encode plus max|x|
// (quant_pack_sub_amax_tiles), for delayed scaling, of one plane or of a
// cohort's P planes in one launch.
//
// Replace the TPU kernels src/repro/kernels/fp8_quant.py::quant_pack_amax_tiles
// (_quant_pack_det_amax_kernel, _quant_pack_rand_ctr_amax_kernel) and
// quant_pack_sub_amax_tiles (_quant_pack_sub_det_amax_kernel,
// _quant_pack_sub_rand_ctr_amax_kernel), which the reference's scaled uplink
// vmaps over the cohort (src/repro/core/engine.py, jax.vmap of the scaled
// encode). core/codec.py encode_scaled_many launches them on a
// delayed-scaling downlink (core/scaling.py DelayedScaling; P = 1) and on
// the uplink: the cohort's planes stacked (P, R, 1024)
// with one key row a slice (P, 2), every client at the same effective
// scales, so the alphas come as one (R, 1 | 1024) slice with a zero stride
// over P (a_slice = 0) or one slice each. Next round's amax history rows
// come out of this round's quantize launch, with no reduction of their own
// over the model.
//
// Outputs: the codes, bitwise those of quant_pack.cu (K = 1) or
// quant_pack_sub.cu (K = 2), all from fp8_common.cuh::pack_code_b over the
// same counter RNG: slice p draws with its own key words over the element
// index WITHIN the slice, row * 1024 + col, so its codes are those of a
// launch on that plane alone; and rowmax[p, r] = max_c |x[p, r, c]| of the
// RAW (unclipped) row. Float max is exact in any order, so the row max is
// deterministic without atomics.
//
// Bound: memory. Per element it reads 4 bytes of x and writes 1 / K bytes,
// plus 4 bytes of alpha and 4 bytes of rowmax a row (the (R, 1) column) and
// 8 bytes of key a slice. On the paths that run it every launch is below one
// wave (LeNet's cohort is 3 x 135 rows), so what counts is a block's chain.
// Design: one 256-thread block a 1024-lane row, one float4 of x a thread
// (and one of alpha on the (R, 1024) layout), its four codes packed into one
// store (a u32 at K = 1, a u16 at K = 2); the clip's bias, log2f(alpha),
// once a thread on the column (the first port took it at every element), on
// the (R, 1024) layout once for each run of bitwise-equal alphas; the row
// max by warp shuffles, then the eight warp maxima (reduce.cuh,
// block_max_shfl) in place of the first port's eight-barrier shared tree.
// K, the codes a byte, is a template parameter, so a profile tells
// quant_pack_amax_kernel<1, ...> (E4M3) from <2, ...> (FP4).
#include "reduce.cuh"

template <int K, bool COL, bool RAND>
__global__ void __launch_bounds__(fp8::kThreads) quant_pack_amax_kernel(
    const float* __restrict__ x, const float* __restrict__ a, long long a_slice,
    const uint32_t* __restrict__ keys, uint8_t* __restrict__ out, float* __restrict__ rowmax,
    long long rows, fp8::Fmt f) {
  static_assert(fp8::kLane == 4 * fp8::kThreads, "one float4 a thread covers a row");
  constexpr int kBits = 8 / K;
  __shared__ float sh[fp8::kThreads / 32];
  const long long gr = blockIdx.x;                    // row of the stack: slice p, row r
  const long long p = gr / rows;
  const long long r = gr - p * rows;
  const int c0 = 4 * (int)threadIdx.x;                // the thread's first lane
  const float4 t = *reinterpret_cast<const float4*>(x + gr * fp8::kLane + c0);
  const float xs[4] = {t.x, t.y, t.z, t.w};
  const uint32_t k0 = RAND ? keys[2 * p] : 0u;
  const uint32_t k1 = RAND ? keys[2 * p + 1] : 0u;
  const uint32_t idx = (uint32_t)(r * fp8::kLane + c0);   // element index within slice p
  int code[4];
  if constexpr (COL) {
    const float av = a[p * a_slice + r];
    const float b = fp8::bias(av, f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      code[j] = fp8::pack_code_b(xs[j], av, b, f, RAND, idx + j, k0, k1);
  } else {
    const float4 at = *reinterpret_cast<const float4*>(a + p * a_slice + r * fp8::kLane + c0);
    const float as[4] = {at.x, at.y, at.z, at.w};
    float av = as[0];
    float b = fp8::bias(av, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j > 0 && __float_as_uint(as[j]) != __float_as_uint(av)) {
        av = as[j];
        b = fp8::bias(av, f);
      }
      code[j] = fp8::pack_code_b(xs[j], av, b, f, RAND, idx + j, k0, k1);
    }
  }
  if constexpr (K == 1) {
    *reinterpret_cast<uint32_t*>(out + gr * fp8::kLane + c0) =
        (uint32_t)code[0] | ((uint32_t)code[1] << 8) | ((uint32_t)code[2] << 16) |
        ((uint32_t)code[3] << 24);
  } else {
    *reinterpret_cast<uint16_t*>(out + gr * (fp8::kLane / 2) + c0 / 2) =
        (uint16_t)(code[0] | (code[1] << kBits) | (code[2] << 8) | (code[3] << (8 + kBits)));
  }
  const float mx = fmaxf(fmaxf(fabsf(xs[0]), fabsf(xs[1])), fmaxf(fabsf(xs[2]), fabsf(xs[3])));
  const float m = fp8::block_max_shfl(mx, sh);
  if (threadIdx.x == 0) rowmax[gr] = m;
}

template <int K, bool COL>
static void launch_amax(const float* x, const float* a, long long a_slice, const uint32_t* keys,
                        uint8_t* out, float* rowmax, long long grid, long long rows,
                        const fp8::Fmt& f, cudaStream_t stream) {
  if (keys != nullptr) {
    quant_pack_amax_kernel<K, COL, true><<<(unsigned)grid, fp8::kThreads, 0, stream>>>(
        x, a, a_slice, keys, out, rowmax, rows, f);
  } else {
    quant_pack_amax_kernel<K, COL, false><<<(unsigned)grid, fp8::kThreads, 0, stream>>>(
        x, a, a_slice, keys, out, rowmax, rows, f);
  }
}

// ``slices`` planes of ``rows`` (rows, 1024) rows each, x stacked slice after
// slice (16-byte aligned); the alphas (rows, a_cols) a slice, slice p at
// a + p * a_slice (a_slice 0: one slice for all); ``keys`` (slices, 2) u32
// or null (det); codes (slices, rows, 1024 / k) and rowmax (slices, rows).
// k is 1 (FP8) or 2 (FP4); any other k is an error.
extern "C" int repro_quant_pack_amax_many(const float* x, const float* a, int a_cols,
                                          long long a_slice, const uint32_t* keys,
                                          uint8_t* out, float* rowmax, long long slices,
                                          long long rows, int k, int exp, int mant,
                                          float mant_const, cudaStream_t stream) {
  const long long grid = slices * rows;
  if (k != 1 && k != 2) return (int)cudaErrorInvalidValue;
  if (grid <= 0) return 0;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const fp8::Fmt f{exp, mant, mant_const};
  const bool col = a_cols == 1;
  if (k == 1) {
    if (col) launch_amax<1, true>(x, a, a_slice, keys, out, rowmax, grid, rows, f, stream);
    else launch_amax<1, false>(x, a, a_slice, keys, out, rowmax, grid, rows, f, stream);
  } else {
    if (col) launch_amax<2, true>(x, a, a_slice, keys, out, rowmax, grid, rows, f, stream);
    else launch_amax<2, false>(x, a, a_slice, keys, out, rowmax, grid, rows, f, stream);
  }
  return (int)cudaGetLastError();
}
