// Q_det on the parameter plane with a per-row clip column, and its
// straight-through backward with a per-row clip cotangent (B7).
//
// Replace the TPU kernels src/repro/kernels/fp8_quant.py::quant_det_tiles
// (_quant_det_tiles_kernel) and quant_det_tiles_bwd
// (_quant_det_tiles_bwd_kernel). The one-device trainer
// (launch/steps.py, opt_level >= 1) packs every quantized weight of the
// model into one (R, 1024) f32 plane (core/plane.py) and launches the
// forward once a step; the backward runs once a step too, when the step
// replays the plane's VJP after its last microbatch:
//
//   out[r, c]   = Q_det(x[r, c]; a[r])
//   gx[r, c]    = g[r, c] * 1{|x[r, c]| <= a[r]}
//   ga_row[r]   = sum_c g[r, c] * (sign(x) * 1{|x| > a[r]} + (q - y) * s / a[r])
//
// a[r] is the clip of the segment (a leaf, or one layer of a stacked leaf)
// that owns row r, already floored by the caller. Every element uses the
// shared per-element arithmetic of fp8_common.cuh (quant_det_elem,
// ste_terms), so a B7 element equals a B1/B2 element at the same (x, a).
//
// Bound: memory. Forward: 4 bytes read and 4 written an element, plus 4 a
// row for the column; backward: x and g read, gx written (12 bytes an
// element), plus the two columns. At full-width TinyLlama-1.1B the plane is
// 1,074,176 rows x 1024 (1.1e9 elements, 4.4 GB), so offsets are 64-bit.
// Design: one 256-thread block a row, each thread one float4 (16-byte
// loads and stores, the 1024-lane row read once), the row's clip read once.
// The backward reduces the row's 256 partial sums with reduce.cuh's fixed
// shared-memory tree: no atomics, no carry between blocks, the same bits on
// every run.
#include "reduce.cuh"

static_assert(fp8::kLane == 4 * fp8::kThreads, "one float4 a thread a row");

__global__ void quant_det_tiles_kernel(const float4* __restrict__ x,
                                       const float* __restrict__ a_col,
                                       float4* __restrict__ out, fp8::Fmt f) {
  const long long r = blockIdx.x;
  const float a = a_col[r];
  const float b = fp8::bias(a, f);
  const long long i = r * fp8::kThreads + threadIdx.x;
  float4 v = x[i];
  v.x = fp8::quant_det_elem(v.x, a, b, f);
  v.y = fp8::quant_det_elem(v.y, a, b, f);
  v.z = fp8::quant_det_elem(v.z, a, b, f);
  v.w = fp8::quant_det_elem(v.w, a, b, f);
  out[i] = v;
}

__device__ __forceinline__ float ste_elem(float x, float g, float a, float b,
                                          const fp8::Fmt& f, float* acc) {
  float inside, route;
  fp8::ste_terms(x, a, b, f, &inside, &route);
  *acc += g * route;
  return g * inside;
}

__global__ void quant_det_tiles_bwd_kernel(const float4* __restrict__ x,
                                           const float* __restrict__ a_col,
                                           const float4* __restrict__ g,
                                           float4* __restrict__ gx,
                                           float* __restrict__ ga_row,
                                           fp8::Fmt f) {
  __shared__ float sh[fp8::kThreads];
  const long long r = blockIdx.x;
  const float a = a_col[r];
  const float b = fp8::bias(a, f);
  const long long i = r * fp8::kThreads + threadIdx.x;
  const float4 xv = x[i];
  const float4 gv = g[i];
  float acc = 0.0f;
  float4 o;
  o.x = ste_elem(xv.x, gv.x, a, b, f, &acc);
  o.y = ste_elem(xv.y, gv.y, a, b, f, &acc);
  o.z = ste_elem(xv.z, gv.z, a, b, f, &acc);
  o.w = ste_elem(xv.w, gv.w, a, b, f, &acc);
  gx[i] = o;
  const float total = fp8::block_sum(acc, sh);
  if (threadIdx.x == 0) ga_row[r] = total;
}

extern "C" int repro_quant_det_tiles(const float* x, const float* a_col,
                                     float* out, long long rows, int exp,
                                     int mant, float mant_const,
                                     cudaStream_t stream) {
  if (rows <= 0) return 0;
  const fp8::Fmt f{exp, mant, mant_const};
  quant_det_tiles_kernel<<<(unsigned)rows, fp8::kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), a_col, reinterpret_cast<float4*>(out),
      f);
  return (int)cudaGetLastError();
}

extern "C" int repro_quant_det_tiles_bwd(const float* x, const float* a_col,
                                         const float* g, float* gx,
                                         float* ga_row, long long rows,
                                         int exp, int mant, float mant_const,
                                         cudaStream_t stream) {
  if (rows <= 0) return 0;
  const fp8::Fmt f{exp, mant, mant_const};
  quant_det_tiles_bwd_kernel<<<(unsigned)rows, fp8::kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), a_col,
      reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(gx), ga_row,
      f);
  return (int)cudaGetLastError();
}
