// Fused quantize + bit-pack of the wire tile layout to uint8 FP8 codes.
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant.py::quant_pack_tiles
// (_quant_pack_det_kernel, _quant_pack_rand_ctr_kernel and _pack_code). It
// is the wire encode of both legs of every round: stochastic rounding from
// the counter RNG keyed by a (2,) u32 key, or round-to-nearest-even when
// the key pointer is null.
//
// Bound: memory. Per element it reads 4 bytes of x (plus alpha: one float
// per row for the (R, 1) column, or 4 bytes for the (R, 1024) layout) and
// writes 1 byte; the murmur3 mix is ~10 integer operations. Design: one
// thread per element, grid-stride; the uniform is derived in registers from
// (row * 1024 + col, key) so no random operand is read. The code itself is
// fp8_common.cuh::pack_code, shared with the FP4 and amax encodes.
#include "fp8_common.cuh"

__global__ void quant_pack_kernel(const float* __restrict__ x,
                                  const float* __restrict__ a2, int a_cols,
                                  const uint32_t* __restrict__ key,
                                  uint8_t* __restrict__ out, long long n,
                                  fp8::Fmt f) {
  const bool stochastic = key != nullptr;
  const uint32_t k0 = stochastic ? key[0] : 0u;
  const uint32_t k1 = stochastic ? key[1] : 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = a2[a_cols == 1 ? i / fp8::kLane : i];
    out[i] = (uint8_t)fp8::pack_code(x[i], a, f, stochastic, (uint32_t)i, k0, k1);
  }
}

extern "C" int repro_quant_pack_tiles(const float* x, const float* a2,
                                      int a_cols, const uint32_t* key,
                                      uint8_t* out, long long n, int exp,
                                      int mant, float mant_const,
                                      cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  quant_pack_kernel<<<fp8::grid_for(n), fp8::kThreads, 0, stream>>>(
      x, a2, a_cols, key, out, n, f);
  return (int)cudaGetLastError();
}
