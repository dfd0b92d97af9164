// Q_det fake-quant with a per-tensor clipping scalar (paper Eq. 2).
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant.py::quant_det
// (_quant_det_kernel). It runs at every QAT weight and activation site of
// every local step, forward.
//
// Bound: memory. Per element it reads 4 bytes and writes 4 bytes and does a
// dozen f32 operations (two of them log2f/exp2f), far below the card's
// compute-to-bandwidth ratio. Design: one thread per element in a
// grid-stride loop, consecutive threads on consecutive addresses so loads
// and stores coalesce; alpha is read once per thread from device memory
// (no host sync) and floored at 1e-12 as fp8_quant.py:110 does.
#include "fp8_common.cuh"

__global__ void quant_det_kernel(const float* __restrict__ x,
                                 const float* __restrict__ alpha,
                                 float* __restrict__ out, long long n,
                                 fp8::Fmt f) {
  const float a = fmaxf(alpha[0], fp8::kAlphaFloor);
  const float b = fp8::bias(a, f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float xc = fp8::clip(x[i], a);
    const float s = fp8::scale(fp8::exponent(xc, b), b, f);
    out[i] = s * rintf(xc / s);
  }
}

extern "C" int repro_quant_det(const float* x, const float* alpha, float* out,
                               long long n, int exp, int mant,
                               float mant_const, cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  quant_det_kernel<<<fp8::grid_for(n), fp8::kThreads, 0, stream>>>(
      x, alpha, out, n, f);
  return (int)cudaGetLastError();
}
