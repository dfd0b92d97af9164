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

inline int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)blocks;
}

}  // namespace fp8
