// Q_det fake-quant with a per-tensor clipping scalar (paper Eq. 2).
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant.py::quant_det
// (_quant_det_kernel). It runs at every QAT weight and activation site of
// every local step, forward. Two instances: f32 in and out, and bf16 in and
// out (the LM's activations once the trainer has pre-quantized its weights,
// launch/steps.py opt_level >= 1); both compute in f32, as the reference
// kernel does for either dtype.
//
// Bound (qat_probe.py on an H100; PERF.md §6). The bytes are 4 an
// element in bf16 (x read, out written), 8 in f32, but det_code's element
// function is no dozen operations: accurate log2f (a 9-FFMA polynomial),
// exp2f and the IEEE division (the library is built with --fmad=false) run
// about 500 G elements/s on the whole card with no memory traffic at all.
// The first port, one element a thread with a scalar load and at most 8192
// blocks, added that to a copy in its own pattern that alone took 2.5x the
// bf16 bytes bound: 10.6 us at (8, 128, 2048), a quarter of the bound.
//
// Design. (1) Bytes in flight: each thread walks units of 8 elements in
// 16-byte vectors (one of bf16, two of f32), loading each unit's successor
// before it computes the unit; about kBatchesPerThread units a thread (one
// where that would leave SMs idle), at most the blocks the card holds at
// once. The ragged head and tail, and every element of an operand whose
// offset mod 16 differs from out's, take the one-element path of the same
// loop. In this pattern the copy alone is near the bound. (2) Fewer
// instructions: from kTabMinN elements on, each block first builds the
// clip's scale table (fp8_common.cuh, ScaleTable: det_code's thresholds of
// |xc| found with the same log2f, a threshold and two scales a binade), its
// alpha and first loads issued before; an element is then a clip, an
// exponent-field index, one shared float4, a compare, the division, rintf
// and a multiply (about 830 G elements/s alone). The table gives det_code's
// s bit for bit, so out is bitwise det_code's on either route. What is left
// at the trainer's shapes: the table's build (about 0.9 us a block) and the
// arithmetic, which a one-wave launch overlaps with its memory traffic only
// in part.
//
// qat_probe.py also launches this kernel with the arithmetic removed (the
// copy probe) and the element functions alone (the arithmetic probe).
#include "fp8_common.cuh"

// From here on the table route pays: its build (about 0.9 us a block on the
// card, qat_probe.py) against det_code's longer element function.
static constexpr long long kTabMinN = 1 << 20;
static constexpr int kBatchesPerThread = 4;   // a thread's units of work, each 8 elements

// Vectors in a thread's unit of work: 8 elements (one bf16 vector, two f32)
template <typename T>
static constexpr int kUnroll = 8 / fp8::Vec<T>::kN;

// Element i of the one-element path: the head, then the tail after the
// vectors.
static __device__ __forceinline__ long long scalar_index(long long k, long long head,
                                                         long long vec_end) {
  return k < head ? k : vec_end + (k - head);
}

// The grid-stride loop over one launch's elements, with ``op`` the element
// function on a vector's elements in place (float[V::kN]): the vectors,
// kUnroll a unit (the first unit already loaded into r), each unit's
// successor loaded before the unit is computed, then the one-element path
// (head and tail, or everything where the operands are misaligned), a
// one-element array at a time. One copy a route, so no element branches on
// the route.
template <typename T, typename Op>
static __device__ __forceinline__ void stream_fwd(const T* __restrict__ x, T* __restrict__ out,
                                                  long long n, long long head, long long nvec,
                                                  uint4 (&r)[kUnroll<T>], Op op) {
  using V = fp8::Vec<T>;
  constexpr int U = kUnroll<T>;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  uint4* __restrict__ ov = reinterpret_cast<uint4*>(out + head);
  for (long long j0 = tid; j0 < nvec; j0 += U * nthreads) {
    const long long next = j0 + U * nthreads;
    uint4 nx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = next + u * nthreads;
      if (j < nvec) nx[u] = xv[j];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = j0 + u * nthreads;
      if (j < nvec) {
        float v[V::kN];
        V::unpack(r[u], v);
        op(v);
        ov[j] = V::pack(v);
      }
      r[u] = nx[u];
    }
  }
  const long long vec_end = head + nvec * V::kN;
  const long long n_scalar = head + (n - vec_end);
  for (long long k = tid; k < n_scalar; k += nthreads) {
    const long long i = scalar_index(k, head, vec_end);
    float v[1] = {fp8::to_f32(x[i])};
    op(v);
    out[i] = fp8::from_f32<T>(v[0]);
  }
}

// KIND 0: Q_det. KIND 1: the copy probe (out = x, no alpha read, no table).
template <typename T, int KIND>
__global__ void __launch_bounds__(fp8::kThreads) quant_det_kernel(
    const T* __restrict__ x, const float* __restrict__ alpha, T* __restrict__ out,
    long long n, long long head, long long nvec, int use_tab, fp8::Fmt f) {
  __shared__ fp8::ScaleTable tab;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  // alpha first (the table's chain starts at it), then the first unit's
  // loads, all before the table is built
  const float alpha0 = KIND == 0 ? alpha[0] : 1.0f;
  uint4 r[kUnroll<T>];
#pragma unroll
  for (int u = 0; u < kUnroll<T>; ++u) {
    const long long j = tid + u * nthreads;
    if (j < nvec) r[u] = xv[j];
  }
  if (KIND == 1) {
    stream_fwd(x, out, n, head, nvec, r, [](auto&) {});
    return;
  }
  const float a = fmaxf(alpha0, fp8::kAlphaFloor);
  const float la = log2f(a);
  const float b = fp8::bias_of_log(la, f);
  if (use_tab) fp8::scale_table_build(tab, a, la, b, f);   // block-uniform
  if (use_tab && tab.ok) {
    stream_fwd(x, out, n, head, nvec, r, [&](auto& v) {
#pragma unroll
      for (int e = 0; e < (int)(sizeof(v) / sizeof(float)); ++e)
        v[e] = fp8::quant_det_tab(v[e], a, tab);
    });
  } else {
    stream_fwd(x, out, n, head, nvec, r, [&](auto& v) {
#pragma unroll
      for (int e = 0; e < (int)(sizeof(v) / sizeof(float)); ++e)
        v[e] = fp8::quant_det_elem(v[e], a, b, f);
    });
  }
}

// One launch on n elements: about kBatchesPerThread units of kUnroll
// vectors a thread (fp8::stream_blocks), every one-element-path element a
// unit;
// ``one_a_thread`` (the copy probe's kind 1) puts every element on the
// one-element path over the first port's grid.
template <typename T, int KIND>
static int launch(const void* x, const float* alpha, void* out, long long n,
                  bool one_a_thread, const fp8::Fmt& f, cudaStream_t stream) {
  static fp8::Residency resident[fp8::kMaxDevices] = {};
  const auto kernel = quant_det_kernel<T, KIND>;
  fp8::Split s = fp8::split_for(n, sizeof(T), {x, out});
  int blocks;
  const fp8::Residency res = fp8::residency(kernel, resident);
  if (one_a_thread || (n + fp8::kThreads - 1) / fp8::kThreads <= res.blocks) {
    // every element on the one-element path, one a thread: where the card
    // holds all those threads at once, a unit of 8 elements one after
    // another would only lengthen each thread's chain
    s = {n, 0};
    blocks = fp8::grid_for(n);
  } else {
    const long long units = (s.nvec + kUnroll<T> - 1) / kUnroll<T> + (n - s.nvec * fp8::Vec<T>::kN);
    blocks = fp8::stream_blocks(units, kBatchesPerThread, res);
  }
  kernel<<<blocks, fp8::kThreads, 0, stream>>>(
      static_cast<const T*>(x), alpha, static_cast<T*>(out), n, s.head, s.nvec,
      n >= kTabMinN ? 1 : 0, f);
  return (int)cudaGetLastError();
}

// Probes (qat_probe.py): each element function on values held in registers,
// no global traffic but one store a thread. OP 0 quant_det_elem, 1 ste_terms
// (det_code's log2f / exp2f route), 2 quant_det_tab, 3 ste_terms_tab (the
// table built once a block first).
template <int OP>
__global__ void qat_arith_probe(const float* __restrict__ alpha,
                                float* __restrict__ sink, int iters, fp8::Fmt f) {
  __shared__ fp8::ScaleTable tab;
  const float a = fmaxf(alpha[0], fp8::kAlphaFloor);
  const float la = log2f(a);
  const float b = fp8::bias_of_log(la, f);
  if (OP >= 2) fp8::scale_table_build(tab, a, la, b, f);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float v = (float)(t & 4095) * (1.0f / 1024.0f) - 2.0f;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    float in, route;
    if (OP == 0) {
      acc += fp8::quant_det_elem(v, a, b, f);
    } else if (OP == 1) {
      fp8::ste_terms(v, a, b, f, &in, &route);
      acc += in * v + route;
    } else if (OP == 2) {
      acc += fp8::quant_det_tab(v, a, tab);
    } else {
      fp8::ste_terms_tab(v, a, 1.0f / a, tab, &in, &route);
      acc += in * v + route;
    }
    v += 0.0371f;
  }
  sink[t] = acc;
}

// One element of each det_code function, for a static SASS count (cuobjdump
// -sass): OP 0 a plain copy (the baseline), 1 quant_det_elem, 2 ste_terms.
// Never launched. (The table's functions have no such count: static code
// holds the division's slow path, which a table route runs as rarely; the
// arithmetic probe times them.)
template <int OP>
__global__ void sass_elem_kernel(const float* __restrict__ x, float* __restrict__ o,
                                 float a, float b, fp8::Fmt f) {
  const int i = threadIdx.x;
  float in = 0.0f, route = 0.0f;
  if (OP == 0) {
    in = x[i];
  } else if (OP == 1) {
    in = fp8::quant_det_elem(x[i], a, b, f);
  } else {
    fp8::ste_terms(x[i], a, b, f, &in, &route);
  }
  o[i] = in;
  if (OP == 2) o[i + 256] = route;
}

template __global__ void sass_elem_kernel<0>(const float*, float*, float, float, fp8::Fmt);
template __global__ void sass_elem_kernel<1>(const float*, float*, float, float, fp8::Fmt);
template __global__ void sass_elem_kernel<2>(const float*, float*, float, float, fp8::Fmt);

// bf16 != 0: x and out are __nv_bfloat16, else float.
extern "C" int repro_quant_det(const void* x, const float* alpha, void* out,
                               long long n, int bf16, int exp, int mant,
                               float mant_const, cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  return bf16 ? launch<__nv_bfloat16, 0>(x, alpha, out, n, false, f, stream)
              : launch<float, 0>(x, alpha, out, n, false, f, stream);
}

// The copy probe: the kernel's grid and access pattern with the arithmetic
// removed (out = x). kind 0 the kernel's own pattern, 1 one element a thread
// in a grid-stride loop of at most 8192 blocks (the first port's pattern).
extern "C" int repro_quant_det_probe(int kind, const void* x, void* out, long long n,
                                     int bf16, cudaStream_t stream) {
  const fp8::Fmt f{4, 3, 0.0f};
  return bf16 ? launch<__nv_bfloat16, 1>(x, nullptr, out, n, kind == 1, f, stream)
              : launch<float, 1>(x, nullptr, out, n, kind == 1, f, stream);
}

// The arithmetic probe: blocks x 256 threads, iters evaluations each of the
// element function op (qat_arith_probe's OP).
extern "C" int repro_qat_arith_probe(int op, const float* alpha, float* sink,
                                     int blocks, int iters, int exp, int mant,
                                     float mant_const, cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  switch (op) {
    case 0: qat_arith_probe<0><<<blocks, fp8::kThreads, 0, stream>>>(alpha, sink, iters, f); break;
    case 1: qat_arith_probe<1><<<blocks, fp8::kThreads, 0, stream>>>(alpha, sink, iters, f); break;
    case 2: qat_arith_probe<2><<<blocks, fp8::kThreads, 0, stream>>>(alpha, sink, iters, f); break;
    case 3: qat_arith_probe<3><<<blocks, fp8::kThreads, 0, stream>>>(alpha, sink, iters, f); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The scale table's premise, checked over every pattern (chip_smoke.py):
// log2f non-decreasing from +0 to FLT_MAX. Each thread walks a run of
// consecutive bit patterns and compares each log2f with the next one's;
// bad[0] counts the decreases, bad[1] keeps the least pattern where one
// starts (0xFFFFFFFF if none).
__global__ void log2f_monotone_kernel(unsigned long long* __restrict__ bad,
                                      uint32_t run) {
  const uint32_t top = 0x7F7FFFFFu;
  const uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint64_t first = t * run;
  if (first >= top) return;
  const uint32_t last = (uint32_t)(first + run < top ? first + run : top);
  float prev = log2f(__uint_as_float((uint32_t)first));
  unsigned int n_bad = 0, first_bad = 0xFFFFFFFFu;
  for (uint32_t i = (uint32_t)first + 1u; i <= last; ++i) {
    const float cur = log2f(__uint_as_float(i));
    if (cur < prev) {
      ++n_bad;
      first_bad = min(first_bad, i - 1u);
    }
    prev = cur;
  }
  if (n_bad) {
    atomicAdd(bad, (unsigned long long)n_bad);
    atomicMin(bad + 1, (unsigned long long)first_bad);
  }
}

// bad: two zeroed words, the second set to all ones by the caller.
extern "C" int repro_log2f_monotone(unsigned long long* bad, cudaStream_t stream) {
  const uint32_t run = 4096;
  const uint64_t threads = (0x7F7FFFFFull + run - 1) / run;
  const int blocks = (int)((threads + fp8::kThreads - 1) / fp8::kThreads);
  log2f_monotone_kernel<<<blocks, fp8::kThreads, 0, stream>>>(bad, run);
  return (int)cudaGetLastError();
}
