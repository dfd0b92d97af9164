// Fused quantize + bit-pack of the wire tile layout at K = 8 / bits codes
// per byte: the FP4 (E2M1, E3M0) wire encode, 2 codes per byte, of one plane
// or of a cohort's P planes in one launch.
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant.py::quant_pack_sub_tiles
// (_quant_pack_sub_det_kernel, _quant_pack_sub_rand_ctr_kernel, with
// _pack_code and fold_codes), which the reference's uplink vmaps over the
// cohort (src/repro/core/engine.py, jax.vmap of cc.encode). It is the encode
// of an FP4 leg (core/codec.py PackedFpCodec, and DeltaCodec over it): the
// downlink's one plane, and the cohort's P uplink planes stacked (P, R,
// 1024) with their alphas (P, R, 1 | 1024) and keys (P, 2). Codes come from
// fp8_common.cuh::pack_code_b, the FP8 encode's own function; code 2j of a
// row goes to the low nibble of byte j (little-endian), so a leaf of n
// elements slices to exactly ceil(n / 2) payload bytes. The tile's zero fill
// packs to code 0 under both roundings (y = 0 rounds to 0 for any u), which
// makes the pad nibble of an odd-length leaf deterministic. Slice p draws its
// counter bits with its own key words over the element index WITHIN the
// slice, row * 1024 + col, so its codes are bitwise those of a launch on
// that plane alone (the FP8 encode's bits: packing never changes a rounding
// decision).
//
// Bound: memory. Per element it reads 4 bytes of x and writes half a byte
// (plus alpha: one float per row for the (R, 1) column, or 4 bytes for the
// (R, 1024) layout, and 8 bytes of key a slice). On the paths that run it
// the launch is below one wave (LeNet's cohort is 3 x 135 rows), so what it
// saves is launches: one for the cohort instead of one a client. Design: one
// thread per output byte, grid-stride over the slices' bytes; K is a
// template parameter, so a thread's K codes are unrolled and their chains
// interleave; the clip's bias, log2f(alpha), is computed once a byte on the
// column, and on the (R, 1024) layout once for each run of bitwise-equal
// alphas. Four bytes a thread (two float4 loads, one u32 store) was slower at
// every path shape but (3, 135, 1024) column, where it was within 2%, and
// faster only from a few waves up ((8191, 1024): 28.7 against 38.9 us det),
// a shape no path runs (PERF.md section 6).
#include "fp8_common.cuh"

template <int K, bool COL, bool RAND>
__global__ void quant_pack_sub_kernel(const float* __restrict__ x,
                                      const float* __restrict__ a,
                                      const uint32_t* __restrict__ keys,
                                      uint8_t* __restrict__ out, long long slice_bytes,
                                      long long n_bytes, fp8::Fmt f) {
  constexpr int kBits = 8 / K;
  const long long slice_n = slice_bytes * K;   // elements a slice
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_bytes;
       i += stride) {
    const long long p = i / slice_bytes;
    const long long e0 = (i - p * slice_bytes) * K;   // element index within slice p
    const float* xs = x + p * slice_n + e0;
    const uint32_t k0 = RAND ? keys[2 * p] : 0u;
    const uint32_t k1 = RAND ? keys[2 * p + 1] : 0u;
    int byte = 0;
    if constexpr (COL) {
      const float av = a[p * (slice_n / fp8::kLane) + e0 / fp8::kLane];
      const float b = fp8::bias(av, f);
#pragma unroll
      for (int j = 0; j < K; ++j)
        byte |= fp8::pack_code_b(xs[j], av, b, f, RAND, (uint32_t)(e0 + j), k0, k1)
                << (kBits * j);
    } else {
      const float* as = a + p * slice_n + e0;
      float av = as[0];
      float b = fp8::bias(av, f);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j > 0 && __float_as_uint(as[j]) != __float_as_uint(av)) {
          av = as[j];
          b = fp8::bias(av, f);
        }
        byte |= fp8::pack_code_b(xs[j], av, b, f, RAND, (uint32_t)(e0 + j), k0, k1)
                << (kBits * j);
      }
    }
    out[i] = (uint8_t)byte;
  }
}

template <int K>
static int launch_sub(const float* x, const float* a, bool col, const uint32_t* keys,
                      uint8_t* out, long long slice_bytes, long long n_bytes,
                      const fp8::Fmt& f, cudaStream_t stream) {
  const int grid = fp8::grid_for(n_bytes);
  if (col) {
    if (keys != nullptr) {
      quant_pack_sub_kernel<K, true, true><<<grid, fp8::kThreads, 0, stream>>>(
          x, a, keys, out, slice_bytes, n_bytes, f);
    } else {
      quant_pack_sub_kernel<K, true, false><<<grid, fp8::kThreads, 0, stream>>>(
          x, a, keys, out, slice_bytes, n_bytes, f);
    }
  } else if (keys != nullptr) {
    quant_pack_sub_kernel<K, false, true><<<grid, fp8::kThreads, 0, stream>>>(
        x, a, keys, out, slice_bytes, n_bytes, f);
  } else {
    quant_pack_sub_kernel<K, false, false><<<grid, fp8::kThreads, 0, stream>>>(
        x, a, keys, out, slice_bytes, n_bytes, f);
  }
  return (int)cudaGetLastError();
}

// ``slices`` planes of ``slice_bytes`` output bytes each (R * 1024 / k), x
// and the alphas stacked slice after slice, ``keys`` (slices, 2) u32 or null
// (det). k is 2 (FP4) or 4 (2-bit codes); any other k is an error.
extern "C" int repro_quant_pack_sub_many(const float* x, const float* a, int a_cols,
                                         const uint32_t* keys, uint8_t* out, long long slices,
                                         long long slice_bytes, int k, int exp, int mant,
                                         float mant_const, cudaStream_t stream) {
  const long long n_bytes = slices * slice_bytes;
  if (n_bytes <= 0) return 0;
  const fp8::Fmt f{exp, mant, mant_const};
  const bool col = a_cols == 1;
  if (k == 2) return launch_sub<2>(x, a, col, keys, out, slice_bytes, n_bytes, f, stream);
  if (k == 4) return launch_sub<4>(x, a, col, keys, out, slice_bytes, n_bytes, f, stream);
  return (int)cudaErrorInvalidValue;
}
