// Straight-through backward of Q_det: gx and the scalar clip cotangent.
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant.py::quant_det_bwd
// (_quant_bwd_kernel). It runs at every QAT site of every local step,
// backward:
//
//   gx      = g * 1{|x| <= a}
//   g_alpha = sum g * (sign(x) * 1{|x| > a} + (q - y) * s / a)
//
// Two instances, as the forward: x, g and gx all f32, or all bf16 (read as
// f32, gx rounded back to bf16; g_alpha is f32 either way).
//
// Bound: memory. Per element it reads x and g (8 bytes, 4 in bf16) and
// writes gx (4 bytes, 2 in bf16). g_alpha takes the deterministic two-pass
// reduction of reduce.cuh: pass 1 writes one partial sum per block, pass 2
// folds them in one block.
#include "reduce.cuh"

template <typename T>
__global__ void quant_det_bwd_kernel(const T* __restrict__ x,
                                     const float* __restrict__ alpha,
                                     const T* __restrict__ g,
                                     T* __restrict__ gx,
                                     float* __restrict__ partial, long long n,
                                     fp8::Fmt f) {
  __shared__ float sh[fp8::kThreads];
  const float a = fmaxf(alpha[0], fp8::kAlphaFloor);
  const float b = fp8::bias(a, f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = fp8::to_f32(g[i]);
    float inside, route;
    fp8::ste_terms(fp8::to_f32(x[i]), a, b, f, &inside, &route);
    gx[i] = fp8::from_f32<T>(gi * inside);
    acc += gi * route;
  }
  const float total = fp8::block_sum(acc, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// ``partial`` holds n_blocks floats; the wrapper sizes it with
// repro_quant_det_bwd_blocks(n) so both sides agree on the grid.
extern "C" int repro_quant_det_bwd_blocks(long long n) {
  return fp8::bwd_blocks(n);
}

// bf16 != 0: x, g and gx are __nv_bfloat16, else float.
extern "C" int repro_quant_det_bwd(const void* x, const float* alpha,
                                   const void* g, void* gx, float* partial,
                                   float* galpha, long long n, int bf16,
                                   int exp, int mant, float mant_const,
                                   cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  const int blocks = repro_quant_det_bwd_blocks(n);
  if (bf16) {
    quant_det_bwd_kernel<__nv_bfloat16><<<blocks, fp8::kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), alpha,
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gx),
        partial, n, f);
  } else {
    quant_det_bwd_kernel<float><<<blocks, fp8::kThreads, 0, stream>>>(
        static_cast<const float*>(x), alpha, static_cast<const float*>(g),
        static_cast<float*>(gx), partial, n, f);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, fp8::kThreads, 0, stream>>>(partial, blocks, galpha);
  return (int)cudaGetLastError();
}
