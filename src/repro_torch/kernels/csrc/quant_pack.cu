// Fused quantize + bit-pack of the wire tile layout to uint8 FP8 codes.
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant.py::quant_pack_tiles
// (_quant_pack_det_kernel, _quant_pack_rand_ctr_kernel and _pack_code). It
// is the wire encode of both legs of every round: stochastic rounding from
// the counter RNG keyed by a (2,) u32 key, or round-to-nearest-even when
// the key pointer is null. The LM cell's plane is about 1.1e9 elements.
//
// Bound: memory. Per element it reads 4 bytes of x and writes 1 byte of
// code, plus alpha: 4 bytes a row for the (R, 1) column (the small models'
// scalar clips), 4 bytes an element for the (R, 1024) layout (the LM's clips,
// stacked a layer). The first port, one element a thread with scalar loads,
// called pack_code at every element: log2f(alpha) for the bias, log2f(|xc|),
// exp2f for the step, an IEEE division and the murmur mix. B1's probe put
// that element function near 500 G elements/s on the whole card
// (qat_probe.py), under the 670 G/s of the column's 5-byte bound.
//
// Design. Work comes in units of 16 elements a lane of one warp (half a
// row); the grid is one wave (fp8::residency), each warp a contiguous run of
// units. Each lane loads its 16 elements as four float4, one from each of the
// unit's four warp-wide runs of 128 elements (fp8_common.cuh, wire_elem:
// every instruction of the warp covers one contiguous span), the next
// unit's before it computes this one's, and stores its codes as four words.
// Where every element of the unit shares one alpha (always on the column;
// on the (R, 1024) layout when the warp's alphas all equal its first,
// bitwise, as every row of the LM's stacked leaves does), the warp builds
// the clip's bias and threshold table once, rebuilding only when the alpha
// changes (fp8_common.cuh, wire_table_build: B1/B2's table with p beside
// each s, scale(p, b, f) for every p the clip reaches), so that an
// element's p and s are an exponent-field index, one shared-memory float4
// and a compare, and what is left is the clip, the division, the rounding
// and the code's assembly (pack_code_tab). A unit whose clip that table
// cannot hold (none of E4M3's or E5M2's, ref.wire_table_ok) or whose
// alphas differ takes pack_code itself. A launch smaller than one wave (the
// small models' planes) or with an operand off a 16-byte boundary takes the
// first port's kernel, one element a thread, grid-stride
// (quant_pack_elem_kernel; fp8_common.cuh, wire_vector). Every route gives
// pack_code's code bit for bit. The counter bits stay counter_bits(row *
// 1024 + col, key) at each element's global index.
#include "fp8_common.cuh"

static constexpr int kWarps = fp8::kThreads / 32;
static constexpr int G = fp8::kWireG;

template <bool COL, bool RAND>
__global__ void __launch_bounds__(fp8::kThreads) quant_pack_kernel(
    const float* __restrict__ x, const float* __restrict__ a2,
    const uint32_t* __restrict__ key, uint8_t* __restrict__ out, long long units,
    fp8::Fmt f) {
  __shared__ fp8::ScaleTable ttab[kWarps];          // each warp's threshold table
  fp8::ScaleTable& t = ttab[threadIdx.x >> 5];
  const int lane = (int)(threadIdx.x & 31u);
  long long u0, u1;
  fp8::wire_run((long long)blockIdx.x * kWarps + (threadIdx.x >> 5),
                (long long)gridDim.x * kWarps, units, &u0, &u1);
  if (u0 >= u1) return;   // warp-uniform
  const uint32_t k0 = RAND ? key[0] : 0u, k1 = RAND ? key[1] : 0u;
  bool built = false;      // the table was built for alpha bits ``held``
  bool thr_ok = false;     // ... and holds that clip (binades from tb, tn of them)
  uint32_t held = 0u;
  int tb = 0, tn = 1;
  float xv[G], av[COL ? 1 : G];
  fp8::wire_load(x, u0, lane, xv);
  fp8::wire_load_alpha<COL>(a2, u0, lane, av);
  for (long long u = u0; u < u1; ++u) {
    float nx[G], na[COL ? 1 : G];
    if (u + 1 < u1) {   // the next unit's loads before this one's arithmetic
      fp8::wire_load(x, u + 1, lane, nx);
      fp8::wire_load_alpha<COL>(a2, u + 1, lane, na);
    }
    float a;
    int code[G];
    // the per-element branch below stays apart from this one: merged into
    // one, the (R, 1024) layout ran 6-19% slower (PERF.md section 6)
    if (fp8::wire_unit_alpha<COL>(av, &a)) {
      if (!built || __float_as_uint(a) != held) {   // warp-uniform
        __syncwarp();
        thr_ok = fp8::wire_table_build(t, a, fp8::bias(a, f), f);
        tb = t.base;
        tn = t.n;
        built = true;
        held = __float_as_uint(a);
      }
      if (thr_ok) {
#pragma unroll
        for (int j = 0; j < G; ++j)
          code[j] = fp8::pack_code_tab(xv[j], a, t.e, tb, tn, f, RAND,
                                       (uint32_t)fp8::wire_elem(u, lane, j), k0, k1);
      } else {
#pragma unroll
        for (int j = 0; j < G; ++j)
          code[j] = fp8::pack_code(xv[j], a, f, RAND, (uint32_t)fp8::wire_elem(u, lane, j), k0,
                                   k1);
      }
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j)
        code[j] = fp8::pack_code(xv[j], av[COL ? 0 : j], f, RAND,
                                 (uint32_t)fp8::wire_elem(u, lane, j), k0, k1);
    }
#pragma unroll
    for (int i = 0; i < G / 4; ++i)
      *reinterpret_cast<uint32_t*>(out + fp8::wire_elem(u, lane, 4 * i)) =
          (uint32_t)(code[4 * i] & 0xFF) | ((uint32_t)(code[4 * i + 1] & 0xFF) << 8) |
          ((uint32_t)(code[4 * i + 2] & 0xFF) << 16) | ((uint32_t)(code[4 * i + 3] & 0xFF) << 24);
#pragma unroll
    for (int j = 0; j < G; ++j) xv[j] = nx[j];
#pragma unroll
    for (int j = 0; j < (COL ? 1 : G); ++j) av[j] = na[j];
  }
}

// The first port's kernel: one element a thread, grid-stride, pack_code at
// each
__global__ void quant_pack_elem_kernel(const float* __restrict__ x,
                                       const float* __restrict__ a2, int a_cols,
                                       const uint32_t* __restrict__ key,
                                       uint8_t* __restrict__ out, long long n,
                                       fp8::Fmt f) {
  const bool stochastic = key != nullptr;
  const uint32_t k0 = stochastic ? key[0] : 0u;
  const uint32_t k1 = stochastic ? key[1] : 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = a2[a_cols == 1 ? i / fp8::kLane : i];
    out[i] = (uint8_t)fp8::pack_code(x[i], a, f, stochastic, (uint32_t)i, k0, k1);
  }
}

// The 16-element kernel on one wave where fp8::wire_vector takes it (true
// when launched), on its own residency
template <bool COL, bool RAND>
static bool launch_vector(const float* x, const float* a2, const uint32_t* key, uint8_t* out,
                          long long n, bool aligned, const fp8::Fmt& f, cudaStream_t stream) {
  static fp8::Residency resident[fp8::kMaxDevices] = {};
  const fp8::Residency r = fp8::residency(quant_pack_kernel<COL, RAND>, resident);
  if (!fp8::wire_vector(n, aligned, (long long)r.blocks * kWarps)) return false;
  quant_pack_kernel<COL, RAND><<<r.blocks, fp8::kThreads, 0, stream>>>(x, a2, key, out,
                                                                       n / fp8::kWireUnit, f);
  return true;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0u; }

// n elements of (n / 1024, 1024) tiles; alpha a (R, 1) column (a_cols 1) or
// (R, 1024). A format of more than 8 exponent bits has no one-byte code.
extern "C" int repro_quant_pack_tiles(const float* x, const float* a2,
                                      int a_cols, const uint32_t* key,
                                      uint8_t* out, long long n, int exp,
                                      int mant, float mant_const,
                                      cudaStream_t stream) {
  if (exp > 8 || n % fp8::kLane != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const fp8::Fmt f{exp, mant, mant_const};
  const bool col = a_cols == 1;
  const bool aligned = aligned16(x) && aligned16(out) && (col || aligned16(a2));
  const bool vec =
      col ? (key != nullptr ? launch_vector<true, true>(x, a2, key, out, n, aligned, f, stream)
                            : launch_vector<true, false>(x, a2, key, out, n, aligned, f, stream))
          : (key != nullptr ? launch_vector<false, true>(x, a2, key, out, n, aligned, f, stream)
                            : launch_vector<false, false>(x, a2, key, out, n, aligned, f, stream));
  if (!vec) {
    quant_pack_elem_kernel<<<fp8::grid_for(n), fp8::kThreads, 0, stream>>>(x, a2, a_cols, key,
                                                                            out, n, f);
  }
  return (int)cudaGetLastError();
}
