// Shared device arithmetic of the FP8 kernels (paper Eq. 2-3).
//
// Every helper repeats the reference kernel bodies of
// src/repro/kernels/fp8_quant.py op for op, in f32, so that each kernel is
// bitwise equal to its PyTorch twin in src/repro_torch/kernels/ref.py on the
// same card: accurate log2f/exp2f (never the fast intrinsics), rintf for
// jnp.round (half to even), floorf, and IEEE division. The library is built
// with --fmad=false so no multiply-add is contracted into an FMA that the
// twin would round twice.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fp8 {

constexpr float kAlphaFloor = 1e-12f;   // core/fp8.py _ALPHA_FLOOR
constexpr int kLane = 1024;             // wire tile width (core/wire.py)
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;  // grid-stride beyond this

struct Fmt {
  int exp;
  int mant;
  float mant_const;  // log2(2 - 2^-mant), rounded to f32 by the wrapper
};

// b = 2^e - log2(a) + log2(2 - 2^-m) - 1, left to right as fp8_quant.py:44
__device__ __forceinline__ float bias(float a, const Fmt& f) {
  return (((float)(1 << f.exp) - log2f(a)) + f.mant_const) - 1.0f;
}

// jnp.clip(x, -a, a)
__device__ __forceinline__ float clip(float x, float a) {
  return fminf(fmaxf(x, -a), a);
}

// p = max(floor(log2|xc| + b), 1); |xc| == 0 gives -inf and takes the
// subnormal branch
__device__ __forceinline__ float exponent(float xc, float b) {
  const float p = floorf(log2f(fabsf(xc)) + b);
  return p > 1.0f ? p : 1.0f;
}

// s = 2^(p - b - m)
__device__ __forceinline__ float scale(float p, float b, const Fmt& f) {
  return exp2f((p - b) - (float)f.mant);
}

// The grid point of Q_det at x (clip a, bias b) as its parts: the integer
// code n = round(clip(x) / s), the exponent p and the step s = 2^(p - b - m),
// so that Q_det(x) = s * n.
struct DetCode {
  float n;
  float p;
  float s;
};

__device__ __forceinline__ DetCode det_code(float x, float a, float b,
                                            const Fmt& f) {
  const float xc = clip(x, a);
  const float p = exponent(xc, b);
  const float s = scale(p, b, f);
  return {rintf(xc / s), p, s};
}

// Q_det of one element at clip a (bias b): s * round(clip(x) / s). B1
// (quant_det.cu) and B7 (quant_det_tiles.cu) both call it, so a plane
// element equals a per-tensor element at the same (x, a); the QAT products
// (qat_matmul.cu) stage the same det_code.
__device__ __forceinline__ float quant_det_elem(float x, float a, float b,
                                                const Fmt& f) {
  const DetCode c = det_code(x, a, b, f);
  return c.s * c.n;
}

// I/O in f32 or bf16, arithmetic in f32: a bf16 activation is widened
// exactly on load and its result rounded to nearest even on store, as the
// reference kernels' astype(f32) / astype(o_ref.dtype) and torch's .to()
// do.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The straight-through backward of Q_det at one element x with clip a (bias
// b): the mask 1{|x| <= a} (*inside) and the factor of the clip cotangent,
// sign(x) * 1{|x| > a} + (q - y) * s / a (*route), as fp8_quant.py's
// _quant_bwd_kernel computes them. The QAT backward (quant_det_bwd.cu) and
// the fused products' backward (qat_matmul.cu) both call it.
__device__ __forceinline__ void ste_terms(float x, float a, float b,
                                          const Fmt& f, float* inside,
                                          float* route) {
  const float in = fabsf(x) <= a ? 1.0f : 0.0f;
  const float xc = clip(x, a);
  const float s = scale(exponent(xc, b), b, f);
  const float y = xc / s;
  const float q = rintf(y);
  const float sg = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  *inside = in;
  *route = sg * (1.0f - in) + (q - y) * s / a;
}

// murmur3 finalizer: fp8_quant.py::_fmix32 in native uint32 arithmetic
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// fp8_quant.py::counter_bits over the global element index row*1024 + col
__device__ __forceinline__ uint32_t counter_bits(uint32_t idx, uint32_t k0,
                                                 uint32_t k1) {
  return fmix32(fmix32(idx ^ k0) ^ k1);
}

// Stochastic rounding from 32 random bits: u = bits * 2^-32 and
// q = floor(y) + 1{u < y - floor(y)}, as _quant_rand_kernel does
__device__ __forceinline__ float round_rand(float y, uint32_t bits) {
  const float u = (float)bits * (1.0f / 4294967296.0f);
  const float fl = floorf(y);
  return fl + (u < (y - fl) ? 1.0f : 0.0f);
}

// One element's wire code (fp8_quant.py::_pack_code): quantize x onto the
// grid of clip value a and assemble [sign|exp|mant], MSB first. Stochastic
// when `stochastic`, from the counter RNG over the global element index
// idx = row * 1024 + col. Bin-edge mantissa overflow renormalises into the
// next exponent, or saturates the mantissa when the exponent is already at
// its largest code (E2M1: 3; E3M0: 7, where 1 << mant == 1 makes every
// nonzero v normal). The FP8 encode (quant_pack.cu), the FP4 encode
// (quant_pack_sub.cu) and their amax variants (quant_pack_amax.cu) all call
// this one function, so their codes cannot drift apart.
__device__ __forceinline__ int pack_code(float x, float a, const Fmt& f,
                                         bool stochastic, uint32_t idx,
                                         uint32_t k0, uint32_t k1) {
  const int top = 1 << (f.mant + 1);
  const float p_max = (float)((1 << f.exp) - 1);
  const float b = bias(a, f);
  const float xc = clip(x, a);
  float p = fminf(exponent(xc, b), p_max);
  const float s = scale(p, b, f);
  const float y = xc / s;
  const float v_signed =
      stochastic ? round_rand(y, counter_bits(idx, k0, k1)) : rintf(y);
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
  return (sign << (f.exp + f.mant)) | (field << f.mant) | m_field;
}

// One code back to its f32 grid value (fp8_quant.py::_decode_codes), shared
// by the FP8 and the FP4 decode (unpack.cu).
__device__ __forceinline__ float decode_code(int code, float a, const Fmt& f) {
  const float b = bias(a, f);
  const int sign = (code >> (f.exp + f.mant)) & 0x1;
  const int field = (code >> f.mant) & ((1 << f.exp) - 1);
  const int m_field = code & ((1 << f.mant) - 1);
  const bool normal = field >= 1;
  const int v = normal ? m_field + (1 << f.mant) : m_field;
  const int p_eff = normal ? field : 1;
  const float s = exp2f(((float)p_eff - b) - (float)f.mant);
  const float mag = (float)v * s;
  return sign == 1 ? -mag : mag;
}

inline int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)blocks;
}

}  // namespace fp8
