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
// unpack_sub_kernel (the FP4 decode, K = 2 codes a byte; code 2j in the low
// nibble of byte j): one plane, or a cohort's P uplink payloads stacked (P,
// R, 1024 / K) with their alphas (P, R, 1 | 1024) in one launch, which the
// reference's uplink vmaps over the cohort (src/repro/core/engine.py). The
// slices are whole rows, so the stack decodes as P * R rows. The first port
// ran one thread a byte, loaded alpha and called decode_code at every code:
// a log2f and an exp2f a code, where a row's codes take only 2^e steps (4
// for E2M1, 8 for E3M0). Now a 256-thread block takes a run of 256 payload
// bytes (one a thread, its K codes consecutive; at most one row): first,
// 2^e of its threads build the row's scale table in shared memory at the
// alpha of the run's first element (wire_scale, wire_row_scales' entry:
// decode_code's exp2f at each field, the same expression of the same
// operands, so the same bits), while every thread's load of its byte is in
// flight; one barrier; then each thread decodes every code whose alpha
// equals the table's bitwise by one shared-memory load and a product
// (decode_code_row; always on the column) and any other by decode_code, and
// stores its K floats as one float2 / float4 (the (R, 1024) alphas 16-byte
// aligned; the wrapper checks). One byte a thread was timed against two and
// four (PERF.md section 6, PR 26): it was the fastest on every launch the
// paths make, so it is the only width.
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

constexpr int kSubFields = 8;   // exponent fields of a sub-byte code: 2^e, e <= 3

// N consecutive floats at p (N = 2: one float2; else float4s)
template <int N>
static __device__ __forceinline__ void load_floats(const float* __restrict__ p, float (&v)[N]) {
  if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  }
}

template <int N>
static __device__ __forceinline__ void store_floats(float* __restrict__ p, const float (&v)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
  }
}

// n_bytes payload bytes of K codes each over (n_bytes * K / 1024, 1024)
// rows; code e of the stack is nibble e % K of byte e / K, its alpha
// a[e / 1024] (COL) or a[e]
template <int K, bool COL>
__global__ void __launch_bounds__(fp8::kThreads) unpack_sub_kernel(
    const uint8_t* __restrict__ c, const float* __restrict__ a, float* __restrict__ out,
    long long n_bytes, fp8::Fmt f) {
  constexpr int kBits = 8 / K;
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  static_assert(fp8::kThreads * K <= fp8::kLane, "a block's codes lie in one row");
  __shared__ float tab[kSubFields];   // the row's steps, by exponent field
  __shared__ uint32_t held;           // the alpha bits the table was built at
  const long long e0 = (long long)blockIdx.x * fp8::kThreads * K;
  const long long e = e0 + (long long)threadIdx.x * K;   // the thread's first code
  const bool mine = e < n_bytes * K;
  // the thread's loads go out before the table is built
  const uint32_t w = mine ? c[e / K] : 0u;
  float av[COL ? 1 : K];
  if constexpr (!COL) {
    if (mine) load_floats<K>(a + e, av);
  }
  if ((int)threadIdx.x < (1 << f.exp)) {
    const float ar = COL ? a[e0 / fp8::kLane] : a[e0];
    if (threadIdx.x == 0) held = __float_as_uint(ar);
    tab[threadIdx.x] = fp8::wire_scale((int)threadIdx.x, fp8::bias(ar, f), f);
  }
  __syncthreads();
  if (!mine) return;
  float v[K];
  if constexpr (COL) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      v[j] = fp8::decode_code_row((int)((w >> (kBits * j)) & kMask), tab, f);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int code = (int)((w >> (kBits * j)) & kMask);
      v[j] = __float_as_uint(av[j]) == held ? fp8::decode_code_row(code, tab, f)
                                            : fp8::decode_code(code, av[j], f);
    }
  }
  store_floats<K>(out + e, v);
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

template <int K>
static int launch_sub(const uint8_t* c, const float* a, bool col, float* out,
                      long long n_bytes, const fp8::Fmt& f, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n_bytes + fp8::kThreads - 1) / fp8::kThreads);
  if (col) {
    unpack_sub_kernel<K, true><<<grid, fp8::kThreads, 0, stream>>>(c, a, out, n_bytes, f);
  } else {
    unpack_sub_kernel<K, false><<<grid, fp8::kThreads, 0, stream>>>(c, a, out, n_bytes, f);
  }
  return (int)cudaGetLastError();
}

// n_bytes payload bytes of k codes each (a stack of whole (R, 1024 / k)
// planes), alphas (R, 1) a plane (a_cols 1) or (R, 1024), stacked as the
// codes are. k is 2 (FP4) or 4 (2-bit codes), and a code has at most 8
// exponent fields; anything else is an error.
extern "C" int repro_unpack_sub_many(const uint8_t* c, const float* a, int a_cols,
                                     float* out, long long n_bytes, int k, int exp,
                                     int mant, float mant_const, cudaStream_t stream) {
  if ((1 << exp) > kSubFields || (n_bytes * k) % fp8::kLane != 0 ||
      n_bytes / fp8::kThreads >= 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (n_bytes <= 0) return 0;
  const fp8::Fmt f{exp, mant, mant_const};
  const bool col = a_cols == 1;
  if (k == 2) return launch_sub<2>(c, a, col, out, n_bytes, f, stream);
  if (k == 4) return launch_sub<4>(c, a, col, out, n_bytes, f, stream);
  return (int)cudaErrorInvalidValue;
}
