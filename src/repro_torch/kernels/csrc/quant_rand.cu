// Q_rand with external random bits (paper Eq. 3) and its straight-through
// backward: the weight quantizer of stochastic QAT (QATConfig(mode="rand"),
// the Table 2 ablation).
//
// Replaces the TPU kernels src/repro/kernels/fp8_quant.py::quant_rand
// (_quant_rand_kernel) and quant_rand_bwd (_quant_rand_bwd_kernel). The
// u32 bits are drawn outside the kernel, one per element of x, so the
// kernel is deterministic given its inputs:
//
//   forward   out     = s * (floor(y) + 1{u < y - floor(y)}),  u = bits * 2^-32
//   backward  gx      = g * 1{|x| <= a}
//             g_alpha = sum g * (sign(x) * 1{|x| > a} + (q - y) * s / a)
//
// with q the forward's stochastic value (same bits). g_alpha takes the
// deterministic two-pass reduction of reduce.cuh, as quant_det_bwd does.
//
// Bound: memory. Forward: reads x and bits (8 bytes), writes 4. Backward:
// reads x, bits and g (12 bytes), writes gx (4). A dozen f32 operations per
// element, two of them log2f/exp2f. Design: one thread per element,
// grid-stride, coalesced; alpha read once per thread from device memory
// (no host sync) and floored at 1e-12 as the TPU wrappers do.
#include "reduce.cuh"

__global__ void quant_rand_kernel(const float* __restrict__ x,
                                  const float* __restrict__ alpha,
                                  const uint32_t* __restrict__ bits,
                                  float* __restrict__ out, long long n,
                                  fp8::Fmt f) {
  const float a = fmaxf(alpha[0], fp8::kAlphaFloor);
  const float b = fp8::bias(a, f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float xc = fp8::clip(x[i], a);
    const float s = fp8::scale(fp8::exponent(xc, b), b, f);
    out[i] = s * fp8::round_rand(xc / s, bits[i]);
  }
}

__global__ void quant_rand_bwd_kernel(const float* __restrict__ x,
                                      const float* __restrict__ alpha,
                                      const uint32_t* __restrict__ bits,
                                      const float* __restrict__ g,
                                      float* __restrict__ gx,
                                      float* __restrict__ partial, long long n,
                                      fp8::Fmt f) {
  __shared__ float sh[fp8::kThreads];
  const float a = fmaxf(alpha[0], fp8::kAlphaFloor);
  const float b = fp8::bias(a, f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float xi = x[i];
    const float gi = g[i];
    const float inside = fabsf(xi) <= a ? 1.0f : 0.0f;
    const float xc = fp8::clip(xi, a);
    const float s = fp8::scale(fp8::exponent(xc, b), b, f);
    const float y = xc / s;
    const float q = fp8::round_rand(y, bits[i]);
    gx[i] = gi * inside;
    const float sg = xi > 0.0f ? 1.0f : (xi < 0.0f ? -1.0f : 0.0f);
    acc += gi * (sg * (1.0f - inside) + (q - y) * s / a);
  }
  const float total = fp8::block_sum(acc, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

extern "C" int repro_quant_rand(const float* x, const float* alpha,
                                const uint32_t* bits, float* out, long long n,
                                int exp, int mant, float mant_const,
                                cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  quant_rand_kernel<<<fp8::grid_for(n), fp8::kThreads, 0, stream>>>(
      x, alpha, bits, out, n, f);
  return (int)cudaGetLastError();
}

// ``partial`` holds repro_quant_det_bwd_blocks(n) floats (the same grid).
extern "C" int repro_quant_rand_bwd(const float* x, const float* alpha,
                                    const uint32_t* bits, const float* g,
                                    float* gx, float* partial, float* galpha,
                                    long long n, int exp, int mant,
                                    float mant_const, cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  const int blocks = fp8::bwd_blocks(n);
  quant_rand_bwd_kernel<<<blocks, fp8::kThreads, 0, stream>>>(
      x, alpha, bits, g, gx, partial, n, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, fp8::kThreads, 0, stream>>>(partial, blocks, galpha);
  return (int)cudaGetLastError();
}
