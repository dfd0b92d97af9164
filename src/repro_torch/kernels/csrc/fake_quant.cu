// Fused quantize -> dequantize of the (R, 1024) tile layout, f32 out, no
// codes: the FP8 transit of the UQ+ server optimizer (B5), and the same
// with a fused per-row raw max (B9).
//
// fake_quant_kernel replaces the TPU kernel
// src/repro/kernels/fp8_quant.py::fake_quant_tiles (_fake_quant_tiles_kernel
// and _fake_quant_tiles_rand_kernel); fake_quant_amax_kernel replaces
// fake_quant_amax_tiles (_fake_quant_amax_tiles_kernel and its _rand
// variant), whose one caller, dispatch.fake_quant_amax_plane, the port
// mirrors. Both compute each element with fake_quant_elem below, so B9's
// values are B5's bit for bit. The UQ+
// server step (core/server_opt.py) launches B5 once per gradient-descent
// step (stochastic, through dispatch.fake_quant_plane) and once per grid
// point of the clip search: 5 + 20 launches per round in the paper's
// method grid. With a (2,) u32 key the rounding is stochastic from the
// counter RNG over the global element index row * 1024 + col (the wire
// encode's generator); with a null key it rounds to nearest even.
//
// It equals unpack_tiles(quant_pack_tiles(...)) within 1 f32 ULP: both land
// on the same grid point, the decoder writes it as v' * s' after bin-edge
// renormalisation and this kernel as q * s. The exponent is clamped at its
// largest code and, there, |q| at 2^(m+1) - 1: with no next exponent bin, a
// round-up past the top mantissa (reachable only through float fuzz at the
// clip boundary) saturates, exactly as the wire's _pack_code does.
//
// Bound: memory. Per element it reads 4 bytes of x (plus alpha: one float
// per row for the (R, 1) column, or 4 bytes for the (R, 1024) layout) and
// writes 4 bytes (B9: plus 4 bytes of row max a row); two transcendentals
// and, when stochastic, the ~10 integer operations of the murmur3 mix.
// Design: B5 one thread per element, grid-stride, coalesced; B9 one
// 256-thread block per 1024-lane row, the row max reduced by reduce.cuh's
// fixed fmaxf tree (exact in any order), as quant_pack_amax.cu does. The
// uniform is made in registers, so no random operand is read.
#include "reduce.cuh"

// One element: clip, exponent clamped at its largest code, round (to
// nearest even, or stochastically from the counter bits of global element
// index i), |q| saturated there, dequantize.
__device__ __forceinline__ float fake_quant_elem(float x, float a,
                                                 const fp8::Fmt& f,
                                                 bool stochastic, uint32_t i,
                                                 uint32_t k0, uint32_t k1) {
  const float p_max = (float)((1 << f.exp) - 1);
  const float v_max = (float)((1 << (f.mant + 1)) - 1);
  const float b = fp8::bias(a, f);
  const float xc = fp8::clip(x, a);
  const float p = fminf(fp8::exponent(xc, b), p_max);
  const float s = fp8::scale(p, b, f);
  const float y = xc / s;
  float q = stochastic ? fp8::round_rand(y, fp8::counter_bits(i, k0, k1))
                       : rintf(y);
  if (p >= p_max) q = fminf(fmaxf(q, -v_max), v_max);
  return s * q;
}

__global__ void fake_quant_kernel(const float* __restrict__ x,
                                  const float* __restrict__ a2, int a_cols,
                                  const uint32_t* __restrict__ key,
                                  float* __restrict__ out, long long n,
                                  fp8::Fmt f) {
  const bool stochastic = key != nullptr;
  const uint32_t k0 = stochastic ? key[0] : 0u;
  const uint32_t k1 = stochastic ? key[1] : 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = a2[a_cols == 1 ? i / fp8::kLane : i];
    out[i] = fake_quant_elem(x[i], a, f, stochastic, (uint32_t)i, k0, k1);
  }
}

__global__ void fake_quant_amax_kernel(const float* __restrict__ x,
                                       const float* __restrict__ a2,
                                       int a_cols,
                                       const uint32_t* __restrict__ key,
                                       float* __restrict__ out,
                                       float* __restrict__ rowmax,
                                       fp8::Fmt f) {
  __shared__ float sh[fp8::kThreads];
  const long long r = blockIdx.x;
  const bool stochastic = key != nullptr;
  const uint32_t k0 = stochastic ? key[0] : 0u;
  const uint32_t k1 = stochastic ? key[1] : 0u;
  float mx = 0.0f;
  for (int c = threadIdx.x; c < fp8::kLane; c += blockDim.x) {
    const long long e = r * fp8::kLane + c;
    const float xe = x[e];
    mx = fmaxf(mx, fabsf(xe));
    const float a = a2[a_cols == 1 ? r : e];
    out[e] = fake_quant_elem(xe, a, f, stochastic, (uint32_t)e, k0, k1);
  }
  const float m = fp8::block_max(mx, sh);
  if (threadIdx.x == 0) rowmax[r] = m;
}

extern "C" int repro_fake_quant_tiles(const float* x, const float* a2,
                                      int a_cols, const uint32_t* key,
                                      float* out, long long n, int exp,
                                      int mant, float mant_const,
                                      cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  fake_quant_kernel<<<fp8::grid_for(n), fp8::kThreads, 0, stream>>>(
      x, a2, a_cols, key, out, n, f);
  return (int)cudaGetLastError();
}

extern "C" int repro_fake_quant_amax_tiles(const float* x, const float* a2,
                                           int a_cols, const uint32_t* key,
                                           float* out, float* rowmax,
                                           long long rows, int exp, int mant,
                                           float mant_const,
                                           cudaStream_t stream) {
  if (rows <= 0) return 0;
  const fp8::Fmt f{exp, mant, mant_const};
  fake_quant_amax_kernel<<<(unsigned)rows, fp8::kThreads, 0, stream>>>(
      x, a2, a_cols, key, out, rowmax, f);
  return (int)cudaGetLastError();
}
