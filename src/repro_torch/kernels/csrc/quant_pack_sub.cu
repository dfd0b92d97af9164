// Fused quantize + bit-pack of the wire tile layout at k = 8 / bits codes
// per byte: the FP4 (E2M1, E3M0) wire encode, 2 codes per byte.
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant.py::quant_pack_sub_tiles
// (_quant_pack_sub_det_kernel, _quant_pack_sub_rand_ctr_kernel, with
// _pack_code and fold_codes). It is the encode of an FP4 leg
// (core/codec.py PackedFpCodec, and DeltaCodec over it). Codes come from
// fp8_common.cuh::pack_code, the FP8 encode's own function; code 2j of a row
// goes to the low nibble of byte j (little-endian), so a leaf of n elements
// slices to exactly ceil(n / 2) payload bytes. The tile's zero fill packs to
// code 0 under both roundings (y = 0 rounds to 0 for any u), which makes the
// pad nibble of an odd-length leaf deterministic.
//
// Bound: memory. Per element it reads 4 bytes of x and writes half a byte
// (plus alpha: one float per row for the (R, 1) column, or 4 bytes for the
// (R, 1024) layout). Design: one thread per output byte, grid-stride; it
// computes its k codes, each with the counter RNG over its ELEMENT index
// row * 1024 + col (the FP8 encode's bits, so packing never changes a
// rounding decision), and writes one byte.
#include "fp8_common.cuh"

__global__ void quant_pack_sub_kernel(const float* __restrict__ x,
                                      const float* __restrict__ a2, int a_cols,
                                      const uint32_t* __restrict__ key,
                                      uint8_t* __restrict__ out,
                                      long long n_bytes, int k, fp8::Fmt f) {
  const bool stochastic = key != nullptr;
  const uint32_t k0 = stochastic ? key[0] : 0u;
  const uint32_t k1 = stochastic ? key[1] : 0u;
  const int bits = 1 + f.exp + f.mant;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_bytes; i += stride) {
    int byte = 0;
    for (int j = 0; j < k; ++j) {
      const long long e = i * k + j;   // row * 1024 + col
      const float a = a2[a_cols == 1 ? e / fp8::kLane : e];
      byte |= fp8::pack_code(x[e], a, f, stochastic, (uint32_t)e, k0, k1)
              << (bits * j);
    }
    out[i] = (uint8_t)byte;
  }
}

extern "C" int repro_quant_pack_sub_tiles(const float* x, const float* a2,
                                          int a_cols, const uint32_t* key,
                                          uint8_t* out, long long n_bytes, int k,
                                          int exp, int mant, float mant_const,
                                          cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  quant_pack_sub_kernel<<<fp8::grid_for(n_bytes), fp8::kThreads, 0, stream>>>(
      x, a2, a_cols, key, out, n_bytes, k, f);
  return (int)cudaGetLastError();
}
