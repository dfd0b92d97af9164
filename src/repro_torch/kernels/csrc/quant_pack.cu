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
// (row * 1024 + col, key) so no random operand is read. Bin-edge mantissa
// overflow renormalises into the next exponent, or saturates the mantissa
// when the exponent is already at its maximum, exactly as _pack_code does.
#include "fp8_common.cuh"

__global__ void quant_pack_kernel(const float* __restrict__ x,
                                  const float* __restrict__ a2, int a_cols,
                                  const uint32_t* __restrict__ key,
                                  uint8_t* __restrict__ out, long long n,
                                  fp8::Fmt f) {
  const bool stochastic = key != nullptr;
  const uint32_t k0 = stochastic ? key[0] : 0u;
  const uint32_t k1 = stochastic ? key[1] : 0u;
  const int top = 1 << (f.mant + 1);
  const float p_max = (float)((1 << f.exp) - 1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = a2[a_cols == 1 ? i / fp8::kLane : i];
    const float b = fp8::bias(a, f);
    const float xc = fp8::clip(x[i], a);
    float p = fminf(fp8::exponent(xc, b), p_max);
    const float s = fp8::scale(p, b, f);
    const float y = xc / s;
    const float v_signed =
        stochastic ? fp8::round_rand(y, fp8::counter_bits((uint32_t)i, k0, k1))
                   : rintf(y);
    const int sign = v_signed < 0.0f ? 1 : 0;
    int v = (int)fabsf(v_signed);
    if (v >= top) {
      if (p >= p_max) {
        v = top - 1;
      } else {
        v = v / 2;
        p += 1.0f;
      }
    }
    const bool normal = v >= (1 << f.mant);
    const int field = normal ? (int)p : 0;
    const int m_field = normal ? v - (1 << f.mant) : v;
    out[i] = (uint8_t)((sign << (f.exp + f.mant)) | (field << f.mant) | m_field);
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
