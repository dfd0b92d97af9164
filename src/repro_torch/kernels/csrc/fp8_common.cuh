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
#include <initializer_list>
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

// b = 2^e - log2(a) + log2(2 - 2^-m) - 1, left to right as fp8_quant.py:44,
// from la = log2f(a)
__device__ __forceinline__ float bias_of_log(float la, const Fmt& f) {
  return (((float)(1 << f.exp) - la) + f.mant_const) - 1.0f;
}

__device__ __forceinline__ float bias(float a, const Fmt& f) {
  return bias_of_log(log2f(a), f);
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

// --- B1/B2's per-call scale table --------------------------------------------
//
// det_code's p = max(floor(log2f(|xc|) + b), 1) is a non-decreasing function
// of |xc| wherever log2f is non-decreasing over the positive finite f32
// (chip_smoke.py checks that on the card, every one of the 2^31 patterns), and
// its s = 2^((p - b) - m) takes one value a p. So for one clip a (bias b) both
// follow from |xc| by compares: T_k, the least positive f32 v with
// floor(log2f(v) + b) >= k, for k = 2 .. P (P = p at |xc| = a, at most 2^e),
// found with the same log2f (find_thresholds); p(v) = 1 + #{k : v >= T_k}.
// Within one binade [2^E, 2^(E+1)) of |xc| p takes at most two values, so the
// table keeps, a binade from T_2's binade less one up to a's, {the one
// threshold in it (or +inf), s below it, s at or above it}. A lookup is an
// exponent-field index, one shared-memory float4 and a compare. (A row for
// every exponent field, which needs no clamp, took longer to build than it
// saved; two 4-byte loads, s after the compare, were slower too.) Every s in
// the table is scale(p, b, f) itself, so s, and everything computed from it,
// is det_code's to the bit. Where the table cannot hold the clip (two
// thresholds in a binade, a subnormal T_2, more than kTabMax binades or
// kThrMax thresholds) ``ok`` is 0 and the caller takes det_code.

constexpr int kTabMax = 40;   // binades of a table: 2^e + 3 for e <= 5 fits
constexpr int kThrMax = 32;   // thresholds T_2 .. T_P: P <= 2^e <= 33

struct ScaleTable {
  float4 e[kTabMax];   // binade i (exponent field base + i): {thr, s_lo, s_hi, p_lo}
  float t[kThrMax];    // T_2 .. T_P
  int base;            // exponent field of binade 0
  int n;               // binades held
  int ok;              // 0: the caller takes det_code
};

// floor(log2f(v) + b): exponent() without its max, the function the
// thresholds cut
__device__ __forceinline__ float p_raw(float v, float b) {
  return floorf(log2f(v) + b);
}

// The least positive finite f32 v with p_raw(v, b) >= k (p_raw(FLT_MAX) >= k
// given): a bracket of +-256 ULP around 2^(k - b), widened to every positive
// pattern if it does not hold, then bisection on the bit patterns. Exact
// where p_raw is non-decreasing; the bracket only saves steps. One thread;
// find_thresholds' slow path.
__device__ __forceinline__ float threshold(float k, float b) {
  const uint32_t top = 0x7F7FFFFFu;  // FLT_MAX
  const uint32_t c = __float_as_uint(fminf(exp2f(k - b), __uint_as_float(top)));
  uint32_t lo = c > 256u ? c - 256u : 0u;
  uint32_t hi = c < top - 256u ? c + 256u : top;
  if (!(p_raw(__uint_as_float(lo), b) < k && p_raw(__uint_as_float(hi), b) >= k)) {
    lo = 0u;   // +0: log2f is -inf, below every k
    hi = top;
  }
  while (hi - lo > 1u) {   // p_raw(lo) < k <= p_raw(hi)
    const uint32_t mid = lo + (hi - lo) / 2u;
    if (p_raw(__uint_as_float(mid), b) >= k) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  return __uint_as_float(hi);
}

// The first probe at or above k among a half-warp's 32: lane l probes
// p0 + l and p0 + 16 + l (two independent log2f). Returns -1 where none
// reaches k or the first does (the step is not inside), else its offset.
__device__ __forceinline__ int step_in_window(uint32_t p0, bool active, float k, float b) {
  const int l = threadIdx.x & 15;
  const int shift = threadIdx.x & 16;   // this half-warp's bits of a ballot
  const bool lo = active && p_raw(__uint_as_float(p0 + l), b) >= k;
  const bool hi = active && p_raw(__uint_as_float(p0 + 16u + l), b) >= k;
  const uint32_t m = ((__ballot_sync(0xFFFFFFFFu, lo) >> shift) & 0xFFFFu) |
                     (((__ballot_sync(0xFFFFFFFFu, hi) >> shift) & 0xFFFFu) << 16);
  return (m == 0u || (m & 1u)) ? -1 : __ffs(m) - 1;
}

// T_k for k = 2 .. n_thr + 1 into thr[], a half-warp a threshold (sixteen
// at a time): 32 probes, one ULP apart around 2^(k - b), find T_k where the
// step of p_raw lies within 27 ULP below to 4 above it (one log2f deep; the
// sum log2f(v) + b reaches k a few ULP of v before 2^(k - b) does); else
// threshold()'s bisection. Where p_raw is non-decreasing the first probe
// that reaches k, after one that does not, is T_k. Every thread of the
// block calls it; the loop's trip count is the block's.
__device__ __forceinline__ void find_thresholds(float* thr, int n_thr, float b) {
  const uint32_t top = 0x7F7FFFFFu;
  for (int t0 = 0; t0 < n_thr; t0 += kThreads / 16) {
    const int ti = t0 + (int)(threadIdx.x >> 4);
    const bool active = ti < n_thr;
    const float k = (float)(ti + 2);
    const uint32_t c = active ? __float_as_uint(fminf(exp2f(k - b), __uint_as_float(top)))
                              : 1u << 20;
    const bool room = c >= 32u && c <= top - 32u;
    const uint32_t p0 = c - 27u;
    const int j = step_in_window(p0, active && room, k, b);
    if (active && (threadIdx.x & 15) == 0) {
      thr[ti] = room && j >= 0 ? __uint_as_float(p0 + (uint32_t)j) : threshold(k, b);
    }
  }
}

// P - 1, the thresholds T_2 .. T_P of a clip with la = log2f(a), bias b
__device__ __forceinline__ int table_n_thr(float la, float b) {
  const float pa = floorf(la + b);                       // exponent(a, b) before its max
  return (pa > 1.0f ? (int)pa : 1) - 1;
}

// The binades a table for clip a spans, given its first n_thr thresholds
// thr[]: from T_2's binade less one (*base) up to a's, *n of them
__device__ __forceinline__ void table_span(float a, const float* thr, int n_thr, int* base,
                                           int* n) {
  const int ea = (int)(__float_as_uint(a) >> 23);          // a's binade
  const int e2 = n_thr > 0 ? (int)(__float_as_uint(thr[0]) >> 23) : ea;
  *base = e2 - 1;
  *n = ea - *base + 1;
}

// Binade i of the table (exponent field base + i) from the sorted thresholds
// t.t[0 .. n_thr): p below it is one more than the thresholds at or under its
// bottom (a bisection), and the next threshold, if under its top, is the one
// inside. Writes {that threshold (or +inf), s below it, s at or above it, p
// below it} to t.e[i]; returns whether a second threshold lies inside too
// (the table cannot hold the clip).
__device__ __forceinline__ bool fill_binade(ScaleTable& t, int i, int base, int n_thr, float b,
                                            const Fmt& f) {
  const int e = base + i;
  const float lo = e == 0 ? 0.0f : __uint_as_float((uint32_t)e << 23);
  const float hi = __uint_as_float((uint32_t)(e + 1) << 23);
  int j = 0, top = n_thr;                                    // first T_k above lo
  while (j < top) {
    const int mid = (j + top) >> 1;
    if (t.t[mid] > lo) {
      top = mid;
    } else {
      j = mid + 1;
    }
  }
  const bool in1 = j < n_thr && t.t[j] < hi;
  const float thr = in1 ? t.t[j] : __uint_as_float(0x7F800000u);   // +inf: none inside
  t.e[i] = make_float4(thr, scale((float)(j + 1), b, f), scale((float)(j + 2), b, f),
                       (float)(j + 1));
  return in1 && j + 1 < n_thr && t.t[j + 1] < hi;
}

// Fill ``t`` for clip a, la = log2f(a), bias b; every thread of the block
// calls it (it holds two __syncthreads and ends with one). The half-warps
// find the thresholds, then thread i fills binade i.
__device__ __forceinline__ void scale_table_build(ScaleTable& t, float a, float la, float b,
                                                  const Fmt& f) {
  const int n_thr = table_n_thr(la, b);
  const int tid = threadIdx.x;
  if (tid == 0) t.ok = n_thr <= kThrMax ? 1 : 0;
  find_thresholds(t.t, n_thr < kThrMax ? n_thr : kThrMax, b);
  __syncthreads();
  int base, n;
  table_span(a, t.t, n_thr, &base, &n);
  const bool fits = base >= 0 && n <= kTabMax && n_thr <= kThrMax;
  if (tid == 0) {
    t.base = base;
    t.n = n;
    if (!fits) t.ok = 0;
  }
  if (fits && tid < n && fill_binade(t, tid, base, n_thr, b, f)) t.ok = 0;
  __syncthreads();
}

// The table's row for |xc|'s bits m (binades e from exponent field base, n
// of them)
__device__ __forceinline__ float4 table_row(const float4* e, int base, int n, uint32_t m) {
  return e[min(max((int)(m >> 23) - base, 0), n - 1)];
}

// s of det_code at the clipped xc, from the table
__device__ __forceinline__ float table_scale(const ScaleTable& t, float xc) {
  const uint32_t m = __float_as_uint(xc) & 0x7FFFFFFFu;    // |xc|'s bits
  const float4 r = table_row(t.e, t.base, t.n, m);
  return __uint_as_float(m) >= r.x ? r.z : r.y;
}

// quant_det_elem through the table: the same s, so the same bits
__device__ __forceinline__ float quant_det_tab(float x, float a, const ScaleTable& t) {
  const float xc = clip(x, a);
  const float s = table_scale(t, xc);
  return s * rintf(xc / s);
}

// ste_terms through the table: the same s, so the same inside, y and q, and
// the same bits of gx = g * inside. The route's last division by a is a
// product by inv_a = 1 / a (once a block): each g_alpha term within a ULP
// of ste_terms', well inside GA_RTOL of the sum.
__device__ __forceinline__ void ste_terms_tab(float x, float a, float inv_a,
                                              const ScaleTable& t, float* inside,
                                              float* route) {
  const float in = fabsf(x) <= a ? 1.0f : 0.0f;
  const float xc = clip(x, a);
  const float s = table_scale(t, xc);
  const float y = xc / s;
  const float q = rintf(y);
  const float sg = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  *inside = in;
  *route = sg * (1.0f - in) + ((q - y) * s) * inv_a;
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
// this one function, so their codes cannot drift apart. pack_code_b takes
// the clip's bias b = bias(a, f) from a caller that shares it among the
// elements of one clip (the same value, so the same code).
__device__ __forceinline__ int pack_code_b(float x, float a, float b, const Fmt& f,
                                           bool stochastic, uint32_t idx,
                                           uint32_t k0, uint32_t k1) {
  const int top = 1 << (f.mant + 1);
  const float p_max = (float)((1 << f.exp) - 1);
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

__device__ __forceinline__ int pack_code(float x, float a, const Fmt& f,
                                         bool stochastic, uint32_t idx,
                                         uint32_t k0, uint32_t k1) {
  return pack_code_b(x, a, bias(a, f), f, stochastic, idx, k0, k1);
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

// --- the FP8 wire pair's per-row scale table (B3 quant_pack.cu, B4 unpack.cu) --
//
// Where every element of a row shares one clip a (the (R, 1) column; also
// each layer's whole rows of a stacked LM leaf in the (R, 1024) layout),
// the bias b = bias(a, f) and the step of each exponent field are the
// row's, yet pack_code and decode_code recompute log2f(a) and an exp2f at
// every element. B4's row scale table holds s[k] = 2^((max(k, 1) - b) - m)
// for every exponent field k = 0 .. 2^e - 1 (16 for E4M3, 32 for E5M2):
// decode_code's exp2f at field k (field 0 read as p = 1), the same
// expression of the same operands, so the same bits. A warp writes it, one
// entry a lane, and rebuilds it only where a row's alpha differs bitwise
// from the one it was built for. B3 takes p and s from a threshold table
// (wire_table_build, below), whose steps are the same expression.

constexpr int kWireFields = 256;   // exponent fields of a code of at most 8 bits

// The table's entry at exponent field k, the row's bias b (B8's FP4 decode,
// unpack.cu, builds its table from it too)
__device__ __forceinline__ float wire_scale(int k, float b, const Fmt& f) {
  return exp2f(((float)max(k, 1) - b) - (float)f.mant);
}

__device__ __forceinline__ void wire_row_scales(float* s, float b, const Fmt& f) {
  for (int k = (int)(threadIdx.x & 31u); k < (1 << f.exp); k += 32) s[k] = wire_scale(k, b, f);
}

// [sign|exp|mant] of v_signed = round(xc / s) at exponent p: pack_code's
// assembly, bin-edge overflow and saturation included
__device__ __forceinline__ int wire_code(float v_signed, float p, const Fmt& f) {
  const int top = 1 << (f.mant + 1);
  const float p_max = (float)((1 << f.exp) - 1);
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

// decode_code with the row's scale table s: the same value
__device__ __forceinline__ float decode_code_row(int code, const float* s, const Fmt& f) {
  const int sign = (code >> (f.exp + f.mant)) & 0x1;
  const int field = (code >> f.mant) & ((1 << f.exp) - 1);
  const int m_field = code & ((1 << f.mant) - 1);
  const int v = field >= 1 ? m_field + (1 << f.mant) : m_field;
  const float mag = (float)v * s[field];
  return sign == 1 ? -mag : mag;
}

constexpr unsigned kWarpAll = 0xFFFFFFFFu;

// B3's per-warp threshold table: the encode's p and s by compares, where
// B1/B2's table gives det_code's s (the same thresholds, so the same
// premise: log2f non-decreasing). The warp's lanes find T_2 .. T_P, one
// each, by threshold()'s bisection, then fill the binades as
// scale_table_build does (fill_binade), whose .w, p below the binade's
// threshold (p at or above it is one more), gives the code's exponent from
// the same compare. Every s is scale(p, b, f) itself, and the table is used
// only where P, p at |xc| = a, is at most p_max = 2^e - 1, so pack_code's
// saturation never binds: p, s and the code are pack_code's to the bit.
// Returns whether the table holds the clip (else the caller takes
// pack_code); every lane of the warp calls it, and it ends with __syncwarp.
__device__ __forceinline__ bool wire_table_build(ScaleTable& t, float a, float b,
                                                 const Fmt& f) {
  const int lane = (int)(threadIdx.x & 31u);
  const int n_thr = table_n_thr(log2f(a), b);
  bool ok = n_thr <= kThrMax && n_thr + 1 <= (1 << f.exp) - 1;
  if (ok && lane < n_thr) t.t[lane] = threshold((float)(lane + 2), b);
  __syncwarp();
  int base, n;
  table_span(a, t.t, ok ? n_thr : 0, &base, &n);
  ok = ok && base >= 0 && n <= kTabMax;
  bool two = false;                                          // two thresholds in a binade
  for (int i = lane; ok && i < n; i += 32) two |= fill_binade(t, i, base, n_thr, b, f);
  if (lane == 0) {
    t.base = base;
    t.n = n;
  }
  ok = __all_sync(kWarpAll, ok && !two);
  __syncwarp();
  return ok;
}

// pack_code through the warp's threshold table (binades e, first binade
// base, n of them): the same p, s, y and code
__device__ __forceinline__ int pack_code_tab(float x, float a, const float4* e, int base, int n,
                                             const Fmt& f, bool stochastic, uint32_t idx,
                                             uint32_t k0, uint32_t k1) {
  const float xc = clip(x, a);
  const uint32_t m = __float_as_uint(xc) & 0x7FFFFFFFu;    // |xc|'s bits
  const float4 r = table_row(e, base, n, m);
  const bool up = __uint_as_float(m) >= r.x;
  const float y = xc / (up ? r.z : r.y);
  return wire_code(stochastic ? round_rand(y, counter_bits(idx, k0, k1)) : rintf(y),
                   up ? r.w + 1.0f : r.w, f);
}

// The wire pair's unit of work: kWireG = 16 elements a lane of one warp,
// half a row. Element j of a lane's share of unit u: vector k = j / 4 of
// the lane is the lane's 16 bytes of the unit's k-th warp-wide run of 128
// elements, so that every load and store instruction of the warp covers
// one contiguous span (a lane's 16 consecutive elements put each store 64
// bytes from the next lane's and ran B4 slower than the first port;
// PERF.md section 6, the wire pair). Every operand is 16-byte aligned.
constexpr int kWireG = 16;
constexpr int kWireUnit = 32 * kWireG;

__device__ __forceinline__ long long wire_elem(long long u, int lane, int j) {
  return u * kWireUnit + 4 * (32 * (j / 4) + lane) + j % 4;
}

// A lane's 16 f32 of unit u, as four float4
__device__ __forceinline__ void wire_load(const float* __restrict__ p, long long u, int lane,
                                          float (&v)[kWireG]) {
#pragma unroll
  for (int i = 0; i < kWireG / 4; ++i) {
    const float4 t = *reinterpret_cast<const float4*>(p + wire_elem(u, lane, 4 * i));
    v[4 * i] = t.x;
    v[4 * i + 1] = t.y;
    v[4 * i + 2] = t.z;
    v[4 * i + 3] = t.w;
  }
}

// Unit u's alpha: its row's one float of the (R, 1) column (COL), or the
// lane's 16 of the (R, 1024) layout
template <bool COL>
__device__ __forceinline__ void wire_load_alpha(const float* __restrict__ a2, long long u,
                                                int lane, float (&a)[COL ? 1 : kWireG]) {
  if constexpr (COL) {
    a[0] = a2[u * kWireUnit / kLane];
  } else {
    wire_load(a2, u, lane, a);
  }
}

// Whether the whole unit shares one alpha, returned in *a0: always on the
// column; on the (R, 1024) layout when all 512 equal lane 0's first,
// bitwise. Every lane of the warp calls it.
template <bool COL>
__device__ __forceinline__ bool wire_unit_alpha(const float (&a)[COL ? 1 : kWireG], float* a0) {
  if constexpr (COL) {
    *a0 = a[0];
    return true;
  } else {
    *a0 = __shfl_sync(kWarpAll, a[0], 0);
    bool same = true;
#pragma unroll
    for (int j = 0; j < kWireG; ++j) same &= __float_as_uint(a[j]) == __float_as_uint(*a0);
    return __all_sync(kWarpAll, same);
  }
}

// Whether a wire launch of n elements takes the 16-element kernel: every
// operand on a 16-byte boundary (``aligned``) and at least a unit for each
// of the ``resident`` warps the card holds of it at once. Any other launch
// (the small models' planes, a view off a 16-byte boundary) takes the first
// port's kernel, one element a thread: there a warp's table build and its
// run's bounds would only lengthen each thread's chain (PERF.md section 6).
inline bool wire_vector(long long n, bool aligned, long long resident) {
  return aligned && n / kWireUnit >= resident;
}

// A warp's run of units [*u0, *u1) of ``units``, the warps ``nw`` of them
// (warp-uniform): a unit a warp where there are as many warps, else runs
// that differ by at most one unit
__device__ __forceinline__ void wire_run(long long w, long long nw, long long units,
                                         long long* u0, long long* u1) {
  if (nw >= units) {
    *u0 = w;
    *u1 = w < units ? w + 1 : w;
  } else {
    *u0 = w * units / nw;
    *u1 = (w + 1) * units / nw;
  }
}

// 16-byte vectors of f32 (4) or bf16 (8) elements, widened to f32 and
// rounded back as to_f32 / from_f32 do (bf16: the high half of an f32;
// round to nearest even).
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& r, float (&v)[kN]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&v)[kN]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& r, float (&v)[kN]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  __device__ static uint32_t pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint4 pack(const float (&v)[kN]) {
    return make_uint4(pair(v[0], v[1]), pair(v[2], v[3]), pair(v[4], v[5]), pair(v[6], v[7]));
  }
};

// Where a streaming kernel's 16-byte vectors start: ``head`` elements before
// the first 16-byte boundary of p0, then ``nvec`` whole vectors; the rest
// are the tail. Every pointer in ``ps`` must sit at p0's offset mod 16, or
// the whole range is head (the one-element path).
struct Split {
  long long head;
  long long nvec;
};
inline Split split_for(long long n, int esize, std::initializer_list<const void*> ps) {
  const uintptr_t mis = (uintptr_t)*ps.begin() % 16u;
  for (const void* p : ps) {
    if ((uintptr_t)p % 16u != mis) return {n, 0};
  }
  long long head = (long long)((16u - mis) % 16u) / esize;
  if (head > n) head = n;
  return {head, (n - head) / (16 / esize)};
}

// The current card's SMs and the blocks of kThreads it holds at once for
// ``kernel``, queried once a device into the caller's ``cache``
// (kMaxDevices zeroed entries, one array a kernel).
constexpr int kMaxDevices = 64;
struct Residency {
  int sms;
  int blocks;
};
template <typename K>
inline Residency residency(K kernel, Residency* cache) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (cache[dev].blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    cache[dev] = {sms > 0 ? sms : 1, sms * per_sm > 0 ? sms * per_sm : 1};
  }
  return cache[dev];
}

// Blocks for a streaming kernel over ``batches`` units of work: about
// ``per_thread`` units a thread, so that each thread's loads of the next
// unit overlap its arithmetic on this one; but one unit a thread where that
// would leave SMs without a block; at most the blocks the card holds.
inline int stream_blocks(long long batches, long long per_thread, const Residency& r) {
  long long threads = (batches + per_thread - 1) / per_thread;
  const long long one_each = batches < (long long)r.sms * kThreads ? batches
                                                                    : (long long)r.sms * kThreads;
  if (threads < one_each) threads = one_each;
  const long long want = (threads + kThreads - 1) / kThreads;
  return (int)(want < 1 ? 1 : (want < r.blocks ? want : r.blocks));
}

inline int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)blocks;
}

}  // namespace fp8
