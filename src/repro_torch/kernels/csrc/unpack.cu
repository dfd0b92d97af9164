// Decode uint8 FP8 codes of the wire tile layout to f32 grid values.
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant.py::unpack_tiles
// (_unpack_kernel and _decode_codes). It is the wire decode of both legs of
// every round.
//
// Bound: memory. Per element it reads 1 byte of code (plus alpha: one float
// per row for the (R, 1) column, or 4 bytes for the (R, 1024) layout) and
// writes 4 bytes; one exp2f per element. Design: one thread per element,
// grid-stride, coalesced.
#include "fp8_common.cuh"

__global__ void unpack_kernel(const uint8_t* __restrict__ c,
                              const float* __restrict__ a2, int a_cols,
                              float* __restrict__ out, long long n,
                              fp8::Fmt f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = a2[a_cols == 1 ? i / fp8::kLane : i];
    const float b = fp8::bias(a, f);
    const int code = c[i];
    const int sign = (code >> (f.exp + f.mant)) & 0x1;
    const int field = (code >> f.mant) & ((1 << f.exp) - 1);
    const int m_field = code & ((1 << f.mant) - 1);
    const bool normal = field >= 1;
    const int v = normal ? m_field + (1 << f.mant) : m_field;
    const int p_eff = normal ? field : 1;
    const float s = exp2f(((float)p_eff - b) - (float)f.mant);
    const float mag = (float)v * s;
    out[i] = sign == 1 ? -mag : mag;
  }
}

extern "C" int repro_unpack_tiles(const uint8_t* c, const float* a2, int a_cols,
                                  float* out, long long n, int exp, int mant,
                                  float mant_const, cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  unpack_kernel<<<fp8::grid_for(n), fp8::kThreads, 0, stream>>>(
      c, a2, a_cols, out, n, f);
  return (int)cudaGetLastError();
}
