// Fused quantize -> dequantize of the (R, 1024) tile layout, f32 out, no
// codes: the FP8 transit of the UQ+ server optimizer (B5), of one plane at G
// clip columns in one launch, and the same with a fused per-row raw max (B9).
//
// fake_quant_many_kernel replaces the TPU kernel
// src/repro/kernels/fp8_quant.py::fake_quant_tiles (_fake_quant_tiles_kernel
// and _fake_quant_tiles_rand_kernel); fake_quant_amax_kernel replaces
// fake_quant_amax_tiles (_fake_quant_amax_tiles_kernel and its _rand
// variant), whose one caller, dispatch.fake_quant_amax_plane, the port
// mirrors. Both compute each element with fake_quant_elem_b below, so B9's
// values are B5's bit for bit. The UQ+ server step (core/server_opt.py)
// launches B5 once per gradient-descent step (stochastic, G = 1, through
// dispatch.fake_quant_plane) and once for all the grid points of the clip
// search (G = n_grid: the same plane at G clip columns, each with its own
// key): 5 + 1 launches per round in the paper's method grid. With a (G, 2)
// u32 key array the rounding of slice g is stochastic from the counter RNG
// keyed by row g over the element index row * 1024 + col of the plane (the
// wire encode's generator), so slice g is bitwise a launch at clip g alone;
// with a null key it rounds to nearest even.
//
// It equals unpack_tiles(quant_pack_tiles(...)) within 1 f32 ULP: both land
// on the same grid point, the decoder writes it as v' * s' after bin-edge
// renormalisation and this kernel as q * s. The exponent is clamped at its
// largest code and, there, |q| at 2^(m+1) - 1: with no next exponent bin, a
// round-up past the top mantissa (reachable only through float fuzz at the
// clip boundary) saturates, exactly as the wire's _pack_code does.
//
// Bound: memory. B5 reads 4 bytes of x an element once for all G slices and
// writes 4 bytes an element a slice (plus alpha: one float per row a slice
// for the (R, 1) column, or 4 bytes an element a slice for (R, 1024)); two
// transcendentals an element a slice and, when stochastic, the ~10 integer
// operations of the murmur3 mix. B9 writes 4 bytes of row max a row besides.
// Design: B5 one thread per element of the plane, grid-stride over blocks of
// 256 elements (a block's elements lie in one row, 1024 / 256 blocks a row),
// x loaded once and G outputs written, each slice's coalesced; on the column
// the block's G clips, their biases log2f(alpha) and keys are staged once
// in shared memory (256 slices at a time), not once an element a slice. B9
// on the design of quant_pack_amax.cu: one 256-thread block a 1024-lane row,
// one float4 of x a thread (and one of alpha on the (R, 1024) layout, both
// 16-byte aligned), its four values stored as one float4; the clip's bias,
// log2f(alpha), once a thread on the column and once for each run of
// bitwise-equal alphas on the (R, 1024) layout (the first port took it, and
// loaded alpha, at every element); the row max by warp shuffles, then the
// eight warp maxima (reduce.cuh, block_max_shfl: exact in any order, one
// barrier), in place of the first port's eight-barrier shared tree. The
// template parameters name the layout and the rounding in a profile
// (fake_quant_amax_kernel<COL, RAND>). The uniform is made in registers, so
// no random operand is read.
#include "reduce.cuh"

// One element: clip, exponent clamped at its largest code, round (to
// nearest even, or stochastically from the counter bits of element index i),
// |q| saturated there, dequantize; b = bias(a, f), from a caller that shares
// it among the elements of one clip (the same value, so the same result).
__device__ __forceinline__ float fake_quant_elem_b(float x, float a, float b,
                                                   const fp8::Fmt& f,
                                                   bool stochastic, uint32_t i,
                                                   uint32_t k0, uint32_t k1) {
  const float p_max = (float)((1 << f.exp) - 1);
  const float v_max = (float)((1 << (f.mant + 1)) - 1);
  const float xc = fp8::clip(x, a);
  const float p = fminf(fp8::exponent(xc, b), p_max);
  const float s = fp8::scale(p, b, f);
  const float y = xc / s;
  float q = stochastic ? fp8::round_rand(y, fp8::counter_bits(i, k0, k1))
                       : rintf(y);
  if (p >= p_max) q = fminf(fmaxf(q, -v_max), v_max);
  return s * q;
}

// x: the (R, 1024) plane, n = R * 1024 elements; a3: G alpha slices, each
// (R, 1) (COL) or (R, 1024); keys: (G, 2) u32 (RAND); out: (G, R, 1024)
template <bool COL, bool RAND>
__global__ void fake_quant_many_kernel(const float* __restrict__ x,
                                       const float* __restrict__ a3,
                                       const uint32_t* __restrict__ keys,
                                       float* __restrict__ out, long long n, int G,
                                       fp8::Fmt f) {
  __shared__ float sa[fp8::kThreads], sb[fp8::kThreads];
  __shared__ uint32_t sk0[fp8::kThreads], sk1[fp8::kThreads];
  const long long rows = n / fp8::kLane;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // block-uniform: every thread of a block makes the same trips
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += stride) {
    const long long i = base + threadIdx.x;   // n is a multiple of 1024: i < n
    const long long r = base / fp8::kLane;    // the block's row
    const float xi = x[i];
    for (int g0 = 0; g0 < G; g0 += fp8::kThreads) {
      const int gn = min(G - g0, fp8::kThreads);
      if (COL || RAND) {
        __syncthreads();
        if ((int)threadIdx.x < gn) {
          const long long g = g0 + threadIdx.x;
          if (COL) {
            const float a = a3[g * rows + r];
            sa[threadIdx.x] = a;
            sb[threadIdx.x] = fp8::bias(a, f);
          }
          if (RAND) {
            sk0[threadIdx.x] = keys[2 * g];
            sk1[threadIdx.x] = keys[2 * g + 1];
          }
        }
        __syncthreads();
      }
      for (int j = 0; j < gn; ++j) {
        const long long g = g0 + j;
        float a, b;
        if constexpr (COL) {
          a = sa[j];
          b = sb[j];
        } else {
          a = a3[g * n + i];
          b = fp8::bias(a, f);
        }
        out[g * n + i] = fake_quant_elem_b(xi, a, b, f, RAND, (uint32_t)i,
                                           RAND ? sk0[j] : 0u, RAND ? sk1[j] : 0u);
      }
    }
  }
}

// x: the (R, 1024) plane (16-byte aligned); a: its alphas, (R, 1) (COL) or
// (R, 1024) (16-byte aligned); key: 2 u32 (RAND); out: (R, 1024) f32;
// rowmax: (R,) f32. One block a row, one float4 of x a thread.
template <bool COL, bool RAND>
__global__ void __launch_bounds__(fp8::kThreads) fake_quant_amax_kernel(
    const float* __restrict__ x, const float* __restrict__ a,
    const uint32_t* __restrict__ key, float* __restrict__ out,
    float* __restrict__ rowmax, fp8::Fmt f) {
  static_assert(fp8::kLane == 4 * fp8::kThreads, "one float4 a thread covers a row");
  __shared__ float sh[fp8::kThreads / 32];
  const long long r = blockIdx.x;
  const long long e0 = r * fp8::kLane + 4 * (long long)threadIdx.x;   // the thread's first element
  const float4 t = *reinterpret_cast<const float4*>(x + e0);
  const float xs[4] = {t.x, t.y, t.z, t.w};
  const uint32_t k0 = RAND ? key[0] : 0u;
  const uint32_t k1 = RAND ? key[1] : 0u;
  float q[4];
  if constexpr (COL) {
    const float av = a[r];
    const float b = fp8::bias(av, f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = fake_quant_elem_b(xs[j], av, b, f, RAND, (uint32_t)(e0 + j), k0, k1);
  } else {
    const float4 at = *reinterpret_cast<const float4*>(a + e0);
    const float as[4] = {at.x, at.y, at.z, at.w};
    float av = as[0];
    float b = fp8::bias(av, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j > 0 && __float_as_uint(as[j]) != __float_as_uint(av)) {
        av = as[j];
        b = fp8::bias(av, f);
      }
      q[j] = fake_quant_elem_b(xs[j], av, b, f, RAND, (uint32_t)(e0 + j), k0, k1);
    }
  }
  *reinterpret_cast<float4*>(out + e0) = make_float4(q[0], q[1], q[2], q[3]);
  const float mx = fmaxf(fmaxf(fabsf(xs[0]), fabsf(xs[1])), fmaxf(fabsf(xs[2]), fabsf(xs[3])));
  const float m = fp8::block_max_shfl(mx, sh);
  if (threadIdx.x == 0) rowmax[r] = m;
}

template <bool COL>
static void launch_fake_quant_amax(const float* x, const float* a, const uint32_t* key,
                                   float* out, float* rowmax, long long rows,
                                   const fp8::Fmt& f, cudaStream_t stream) {
  if (key != nullptr) {
    fake_quant_amax_kernel<COL, true><<<(unsigned)rows, fp8::kThreads, 0, stream>>>(
        x, a, key, out, rowmax, f);
  } else {
    fake_quant_amax_kernel<COL, false><<<(unsigned)rows, fp8::kThreads, 0, stream>>>(
        x, a, key, out, rowmax, f);
  }
}

// ``g`` clip slices of the n-element plane x (n a multiple of 1024), keys
// (g, 2) u32 or null (det)
extern "C" int repro_fake_quant_many(const float* x, const float* a3, int a_cols,
                                     const uint32_t* keys, float* out, long long n, int g,
                                     int exp, int mant, float mant_const,
                                     cudaStream_t stream) {
  if (n <= 0 || g <= 0) return 0;
  const fp8::Fmt f{exp, mant, mant_const};
  const int grid = fp8::grid_for(n);
  if (a_cols == 1) {
    if (keys != nullptr) {
      fake_quant_many_kernel<true, true><<<grid, fp8::kThreads, 0, stream>>>(x, a3, keys, out,
                                                                             n, g, f);
    } else {
      fake_quant_many_kernel<true, false><<<grid, fp8::kThreads, 0, stream>>>(x, a3, keys, out,
                                                                              n, g, f);
    }
  } else if (keys != nullptr) {
    fake_quant_many_kernel<false, true><<<grid, fp8::kThreads, 0, stream>>>(x, a3, keys, out, n,
                                                                            g, f);
  } else {
    fake_quant_many_kernel<false, false><<<grid, fp8::kThreads, 0, stream>>>(x, a3, keys, out,
                                                                             n, g, f);
  }
  return (int)cudaGetLastError();
}

// ``rows`` rows of x (16-byte aligned), alphas (rows, a_cols) with a_cols 1
// or 1024 (then 16-byte aligned too), key 2 u32 or null (det); out (rows,
// 1024), rowmax (rows,).
extern "C" int repro_fake_quant_amax_tiles(const float* x, const float* a2,
                                           int a_cols, const uint32_t* key,
                                           float* out, float* rowmax,
                                           long long rows, int exp, int mant,
                                           float mant_const,
                                           cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const fp8::Fmt f{exp, mant, mant_const};
  if (a_cols == 1) launch_fake_quant_amax<true>(x, a2, key, out, rowmax, rows, f, stream);
  else launch_fake_quant_amax<false>(x, a2, key, out, rowmax, rows, f, stream);
  return (int)cudaGetLastError();
}
