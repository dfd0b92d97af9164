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
// column, or 4 bytes for the (R, 1024) layout); both write 4 bytes.
//
// unpack_kernel (the FP8 decode). The first port ran decode_code at every
// element, one a thread with scalar loads: log2f(alpha) and an exp2f for a
// step that takes at most 2^e values a row. Now work comes in units of 16
// codes a lane of one warp (half a row) over a one-wave grid, each warp a
// contiguous run of units, each lane loading its codes as four words and
// storing four float4, one from each of the unit's warp-wide runs of 128
// (fp8_common.cuh, wire_elem: each store instruction of the warp one
// contiguous 512 bytes), the next unit's codes loaded before this one's are
// decoded. Where the unit shares one alpha (always on the column; on the
// (R, 1024) layout when the warp's alphas equal its first, as every row of
// the LM's stacked leaves does), the warp holds the row's scale table
// (fp8_common.cuh, wire_row_scales: 16 floats for E4M3, 32 for E5M2, each
// in its own shared-memory bank), rebuilt only when the alpha changes; an
// element is then its field and mantissa, one shared-memory load, a product
// and the sign (decode_code_row), decode_code's arithmetic on the same
// operands, so every value keeps its bits. Any other unit takes decode_code
// itself. A launch smaller than one wave or with an operand off a 16-byte
// boundary takes the first port's kernel, one code a thread, grid-stride
// (unpack_elem_kernel; quant_pack.cu's notes).
//
// unpack_sub_kernel (the FP4 decode): one thread per payload byte,
// grid-stride, coalesced; it unfolds its byte (little-endian: code 2j in the
// low nibble) and writes its k consecutive floats.
#include "fp8_common.cuh"

static constexpr int kWarps = fp8::kThreads / 32;
static constexpr int G = fp8::kWireG;

// A lane's 16 codes of unit u, little-endian in four words: a word from
// each of the unit's warp-wide runs (fp8_common.cuh, wire_elem)
static __device__ __forceinline__ void load_codes(const uint8_t* __restrict__ c, long long u,
                                                  int lane, uint32_t (&w)[G / 4]) {
#pragma unroll
  for (int i = 0; i < G / 4; ++i)
    w[i] = *reinterpret_cast<const uint32_t*>(c + fp8::wire_elem(u, lane, 4 * i));
}

template <bool COL>
__global__ void __launch_bounds__(fp8::kThreads) unpack_kernel(
    const uint8_t* __restrict__ c, const float* __restrict__ a2, float* __restrict__ out,
    long long units, fp8::Fmt f) {
  __shared__ float tab[kWarps][fp8::kWireFields];   // each warp's row scale table
  float* s = tab[threadIdx.x >> 5];
  const int lane = (int)(threadIdx.x & 31u);
  long long u0, u1;
  fp8::wire_run((long long)blockIdx.x * kWarps + (threadIdx.x >> 5),
                (long long)gridDim.x * kWarps, units, &u0, &u1);
  if (u0 >= u1) return;   // warp-uniform
  bool built = false;      // the table holds alpha bits ``held``
  uint32_t held = 0u;
  uint32_t cw[G / 4];      // the lane's 16 codes
  float av[COL ? 1 : G];
  load_codes(c, u0, lane, cw);
  fp8::wire_load_alpha<COL>(a2, u0, lane, av);
  for (long long u = u0; u < u1; ++u) {
    uint32_t ncw[G / 4];
    float na[COL ? 1 : G];
    if (u + 1 < u1) {   // the next unit's loads before this one's arithmetic
      load_codes(c, u + 1, lane, ncw);
      fp8::wire_load_alpha<COL>(a2, u + 1, lane, na);
    }
    float a;
    float v[G];
    if (fp8::wire_unit_alpha<COL>(av, &a)) {
      if (!built || __float_as_uint(a) != held) {   // warp-uniform
        __syncwarp();
        fp8::wire_row_scales(s, fp8::bias(a, f), f);
        __syncwarp();
        built = true;
        held = __float_as_uint(a);
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
        v[j] = fp8::decode_code_row((int)((cw[j / 4] >> (8 * (j % 4))) & 0xFFu), s, f);
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j)
        v[j] = fp8::decode_code((int)((cw[j / 4] >> (8 * (j % 4))) & 0xFFu), av[COL ? 0 : j], f);
    }
#pragma unroll
    for (int i = 0; i < G / 4; ++i)
      *reinterpret_cast<float4*>(out + fp8::wire_elem(u, lane, 4 * i)) =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
#pragma unroll
    for (int i = 0; i < G / 4; ++i) cw[i] = ncw[i];
#pragma unroll
    for (int j = 0; j < (COL ? 1 : G); ++j) av[j] = na[j];
  }
}

// The first port's kernel: one code a thread, grid-stride, decode_code at
// each
__global__ void unpack_elem_kernel(const uint8_t* __restrict__ c,
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

// The 16-code kernel on one wave where fp8::wire_vector takes it (true when
// launched), on its own residency
template <bool COL>
static bool launch_vector(const uint8_t* c, const float* a2, float* out, long long n,
                          bool aligned, const fp8::Fmt& f, cudaStream_t stream) {
  static fp8::Residency resident[fp8::kMaxDevices] = {};
  const fp8::Residency r = fp8::residency(unpack_kernel<COL>, resident);
  if (!fp8::wire_vector(n, aligned, (long long)r.blocks * kWarps)) return false;
  unpack_kernel<COL><<<r.blocks, fp8::kThreads, 0, stream>>>(c, a2, out, n / fp8::kWireUnit, f);
  return true;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0u; }

// n codes of (n / 1024, 1024) tiles; alpha a (R, 1) column (a_cols 1) or
// (R, 1024). A format of more than 8 exponent bits has no one-byte code.
extern "C" int repro_unpack_tiles(const uint8_t* c, const float* a2, int a_cols,
                                  float* out, long long n, int exp, int mant,
                                  float mant_const, cudaStream_t stream) {
  if (exp > 8 || n % fp8::kLane != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const fp8::Fmt f{exp, mant, mant_const};
  const bool col = a_cols == 1;
  const bool aligned = aligned16(c) && aligned16(out) && (col || aligned16(a2));
  const bool vec = col ? launch_vector<true>(c, a2, out, n, aligned, f, stream)
                       : launch_vector<false>(c, a2, out, n, aligned, f, stream);
  if (!vec) {
    unpack_elem_kernel<<<fp8::grid_for(n), fp8::kThreads, 0, stream>>>(c, a2, a_cols, out, n,
                                                                        f);
  }
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
