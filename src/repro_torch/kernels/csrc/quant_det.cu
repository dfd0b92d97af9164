// Q_det fake-quant with a per-tensor clipping scalar (paper Eq. 2).
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant.py::quant_det
// (_quant_det_kernel). It runs at every QAT weight and activation site of
// every local step, forward. Two instances: f32 in and out, and bf16 in and
// out (the LM's activations once the trainer has pre-quantized its weights,
// launch/steps.py opt_level >= 1); both compute in f32, as the reference
// kernel does for either dtype.
//
// Bound: memory. Per element it reads and writes 4 bytes (f32) or 2 (bf16)
// and does a dozen f32 operations (two of them log2f/exp2f), far below the
// card's compute-to-bandwidth ratio. Design: one thread per element in a
// grid-stride loop, consecutive threads on consecutive addresses so loads
// and stores coalesce; alpha is read once per thread from device memory
// (no host sync) and floored at 1e-12 as fp8_quant.py:110 does.
#include "fp8_common.cuh"

template <typename T>
__global__ void quant_det_kernel(const T* __restrict__ x,
                                 const float* __restrict__ alpha,
                                 T* __restrict__ out, long long n,
                                 fp8::Fmt f) {
  const float a = fmaxf(alpha[0], fp8::kAlphaFloor);
  const float b = fp8::bias(a, f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = fp8::from_f32<T>(fp8::quant_det_elem(fp8::to_f32(x[i]), a, b, f));
  }
}

// bf16 != 0: x and out are __nv_bfloat16, else float.
extern "C" int repro_quant_det(const void* x, const float* alpha, void* out,
                               long long n, int bf16, int exp, int mant,
                               float mant_const, cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  if (bf16) {
    quant_det_kernel<__nv_bfloat16><<<fp8::grid_for(n), fp8::kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), alpha,
        static_cast<__nv_bfloat16*>(out), n, f);
  } else {
    quant_det_kernel<float><<<fp8::grid_for(n), fp8::kThreads, 0, stream>>>(
        static_cast<const float*>(x), alpha, static_cast<float*>(out), n, f);
  }
  return (int)cudaGetLastError();
}
