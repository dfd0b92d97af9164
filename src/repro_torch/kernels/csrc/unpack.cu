// Decode wire codes of the tile layout to f32 grid values: the FP8 decode
// (1 code per byte) and the sub-byte decode (FP4: 2 codes per byte).
//
// Replaces the TPU kernels src/repro/kernels/fp8_quant.py::unpack_tiles
// (_unpack_kernel) and unpack_sub_tiles (_unpack_sub_kernel), both over
// _decode_codes, which is fp8_common.cuh::decode_code here. They are the
// wire decode of both legs of every round, the second on an FP4 leg
// (core/codec.py PackedFpCodec).
//
// Bound: memory. Per element the FP8 decode reads 1 byte of code and the
// FP4 decode half a byte (plus alpha: one float per row for the (R, 1)
// column, or 4 bytes for the (R, 1024) layout); both write 4 bytes, with
// one exp2f per element. Design: one thread per payload byte, grid-stride,
// coalesced; a sub-byte thread unfolds its byte (little-endian: code 2j in
// the low nibble) and writes its k consecutive floats.
#include "fp8_common.cuh"

__global__ void unpack_kernel(const uint8_t* __restrict__ c,
                              const float* __restrict__ a2, int a_cols,
                              float* __restrict__ out, long long n,
                              fp8::Fmt f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = a2[a_cols == 1 ? i / fp8::kLane : i];
    out[i] = fp8::decode_code(c[i], a, f);
  }
}

// n_bytes payload bytes of k codes each; element e = byte * k + j
__global__ void unpack_sub_kernel(const uint8_t* __restrict__ c,
                                  const float* __restrict__ a2, int a_cols,
                                  float* __restrict__ out, long long n_bytes,
                                  int k, fp8::Fmt f) {
  const int bits = 1 + f.exp + f.mant;
  const int mask = (1 << bits) - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_bytes; i += stride) {
    const int byte = c[i];
    for (int j = 0; j < k; ++j) {
      const long long e = i * k + j;
      const float a = a2[a_cols == 1 ? e / fp8::kLane : e];
      out[e] = fp8::decode_code((byte >> (bits * j)) & mask, a, f);
    }
  }
}

extern "C" int repro_unpack_tiles(const uint8_t* c, const float* a2, int a_cols,
                                  float* out, long long n, int exp, int mant,
                                  float mant_const, cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  unpack_kernel<<<fp8::grid_for(n), fp8::kThreads, 0, stream>>>(
      c, a2, a_cols, out, n, f);
  return (int)cudaGetLastError();
}

extern "C" int repro_unpack_sub_tiles(const uint8_t* c, const float* a2,
                                      int a_cols, float* out, long long n_bytes,
                                      int k, int exp, int mant, float mant_const,
                                      cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  unpack_sub_kernel<<<fp8::grid_for(n_bytes), fp8::kThreads, 0, stream>>>(
      c, a2, a_cols, out, n_bytes, k, f);
  return (int)cudaGetLastError();
}
