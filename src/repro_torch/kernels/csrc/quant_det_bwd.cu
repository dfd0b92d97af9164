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
// Bound (qat_probe.py on an H100; PERF.md §6). The bytes are 6 an
// element in bf16 (x and g read, gx written), 12 in f32; ste_terms adds a
// second IEEE division to det_code's function (about 360 G elements/s alone
// on the card). The first port ran one element a thread in a grid-stride
// loop of 1024 blocks, then a second launch folded the block partials: a
// third of the bf16 bytes bound at the trainer's shapes, and on the small
// models 1.47 us of its 3.77 us a call went to the second launch.
//
// Design. quant_det.cu's: units of 8 elements of x and g in 16-byte
// vectors, each unit's successor loaded before the unit is computed, about
// kBatchesPerThread units a thread, the one-element path for the ragged
// head and tail and for operands whose offsets differ mod 16, and from
// kTabMinN on the clip's scale table (fp8_common.cuh, ste_terms_tab), which
// gives ste_terms' s, y and q bit for bit, so gx is bitwise ste_terms'
// either way; the route's division by a is a product by 1 / a, once a
// block (g_alpha's terms within a ULP of ste_terms'). One launch: each
// block's partial goes to a cached workspace and the last block to finish
// folds them (reduce.cuh, fold_by_last_block) in a fixed order. The grid
// depends only on n and the card, so g_alpha is the same on every call; it
// is not the first port's to the last bit (another grid, other partial
// sums, the product by 1 / a), and stays within GA_RTOL of the twin's. The
// workspace (a ticket word, then the partials) is shared by the calls on
// one stream, B6's backward (quant_rand.cu) included: two calls that overlap in time, on two streams or replayed
// together from a graph, must not share it. What is left at the trainer's
// shapes: the fold's tail (a fence-ordered ticket, then one block reading
// every partial: about 1.5 us, the copy probe's excess over B1's), the
// table's build and the arithmetic.
#include "reduce.cuh"

// From here on the table route pays: its build (about 0.9 us a block on the
// card, qat_probe.py) against det_code's longer element function.
static constexpr long long kTabMinN = 1 << 20;
static constexpr int kBatchesPerThread = 4;   // a thread's units of work, each 8 elements

// Vectors of each operand in a thread's unit of work: 8 elements
template <typename T>
static constexpr int kUnroll = 8 / fp8::Vec<T>::kN;
// Up to this many elements a thread, on the one-element path, where that
// keeps the grid within one block an SM: the fold's tail grows with the
// blocks, and a unit of 8 elements one after another would lengthen each
// thread's chain more.
static constexpr long long kSmallPerThread = 4;

// The grid-stride loop over one launch's elements, with ``op(x, g, acc)``
// the element function (gx returned, the g_alpha term added to acc): the
// vectors, kUnroll of x and of g a unit (the first unit already loaded),
// each unit's successor loaded before the unit is computed, then the
// one-element path (head and tail, or everything where the operands are
// misaligned). One copy a route, so no element branches on the route.
template <typename T, typename Op>
static __device__ __forceinline__ float stream_bwd(const T* __restrict__ x,
                                                   const T* __restrict__ g,
                                                   T* __restrict__ gx, long long n,
                                                   long long head, long long nvec,
                                                   uint4 (&rx)[kUnroll<T>],
                                                   uint4 (&rg)[kUnroll<T>], Op op) {
  using V = fp8::Vec<T>;
  constexpr int U = kUnroll<T>;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  const uint4* __restrict__ gv = reinterpret_cast<const uint4*>(g + head);
  uint4* __restrict__ gxv = reinterpret_cast<uint4*>(gx + head);
  float acc = 0.0f;
  for (long long j0 = tid; j0 < nvec; j0 += U * nthreads) {
    const long long next = j0 + U * nthreads;
    uint4 nx[U], ng[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = next + u * nthreads;
      if (j < nvec) {
        nx[u] = xv[j];
        ng[u] = gv[j];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = j0 + u * nthreads;
      if (j < nvec) {
        float vx[V::kN], vg[V::kN];
        V::unpack(rx[u], vx);
        V::unpack(rg[u], vg);
#pragma unroll
        for (int e = 0; e < V::kN; ++e) vg[e] = op(vx[e], vg[e], acc);
        gxv[j] = V::pack(vg);
      }
      rx[u] = nx[u];
      rg[u] = ng[u];
    }
  }
  const long long vec_end = head + nvec * V::kN;
  const long long n_scalar = head + (n - vec_end);
  for (long long k = tid; k < n_scalar; k += nthreads) {
    const long long i = k < head ? k : vec_end + (k - head);   // head, then tail
    gx[i] = fp8::from_f32<T>(op(fp8::to_f32(x[i]), fp8::to_f32(g[i]), acc));
  }
  return acc;
}

// KIND 0: the STE backward. KIND 1: the copy probe (gx = g, the partials sum
// x; no alpha read, no table).
template <typename T, int KIND>
__global__ void __launch_bounds__(fp8::kThreads) quant_det_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ alpha, const T* __restrict__ g,
    T* __restrict__ gx, float* __restrict__ ws, float* __restrict__ galpha, long long n,
    long long head, long long nvec, int use_tab, fp8::Fmt f) {
  __shared__ fp8::ScaleTable tab;
  __shared__ float sh[fp8::kThreads / 32];
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  const uint4* __restrict__ gv = reinterpret_cast<const uint4*>(g + head);
  // alpha first (the table's chain starts at it), then the first unit's
  // loads, all before the table is built
  const float alpha0 = KIND == 0 ? alpha[0] : 1.0f;
  uint4 rx[kUnroll<T>], rg[kUnroll<T>];
#pragma unroll
  for (int u = 0; u < kUnroll<T>; ++u) {
    const long long j = tid + u * nthreads;
    if (j < nvec) {
      rx[u] = xv[j];
      rg[u] = gv[j];
    }
  }
  float acc;
  if (KIND == 1) {
    acc = stream_bwd(x, g, gx, n, head, nvec, rx, rg, [](float xi, float gi, float& s) {
      s += xi;
      return gi;
    });
  } else {
    const float a = fmaxf(alpha0, fp8::kAlphaFloor);
    const float la = log2f(a);
    const float b = fp8::bias_of_log(la, f);
    if (use_tab) fp8::scale_table_build(tab, a, la, b, f);   // block-uniform
    if (use_tab && tab.ok) {
      const float inv_a = 1.0f / a;
      acc = stream_bwd(x, g, gx, n, head, nvec, rx, rg, [&](float xi, float gi, float& s) {
        float inside, route;
        fp8::ste_terms_tab(xi, a, inv_a, tab, &inside, &route);
        s += gi * route;
        return gi * inside;
      });
    } else {
      acc = stream_bwd(x, g, gx, n, head, nvec, rx, rg, [&](float xi, float gi, float& s) {
        float inside, route;
        fp8::ste_terms(xi, a, b, f, &inside, &route);
        s += gi * route;
        return gi * inside;
      });
    }
  }
  fp8::fold_by_last_block(acc, ws + fp8::kFoldTicketFloats,
                          reinterpret_cast<unsigned int*>(ws), galpha, sh);
}

template <typename T, int KIND>
static int launch(const void* x, const float* alpha, const void* g, void* gx, float* ws,
                  float* galpha, long long n, bool one_a_thread, const fp8::Fmt& f,
                  cudaStream_t stream) {
  static fp8::Residency resident[fp8::kMaxDevices] = {};
  const auto kernel = quant_det_bwd_kernel<T, KIND>;
  fp8::Split s = fp8::split_for(n, sizeof(T), {x, g, gx});
  int blocks;
  if (one_a_thread) {   // the first port's pattern: one element a thread, 1024 blocks at most
    s = {n, 0};
    blocks = fp8::bwd_blocks(n);
  } else {
    const fp8::Residency res = fp8::residency(kernel, resident);
    if (n <= (long long)res.sms * fp8::kThreads * kSmallPerThread) {
      s = {n, 0};
      const long long want = (n + fp8::kThreads - 1) / fp8::kThreads;
      blocks = (int)(want < res.sms ? want : res.sms);
    } else {
      const long long units = (s.nvec + kUnroll<T> - 1) / kUnroll<T> +
                              (n - s.nvec * fp8::Vec<T>::kN);
      blocks = fp8::stream_blocks(units, kBatchesPerThread, res);
    }
  }
  if (blocks > fp8::kFoldPartials) return (int)cudaErrorInvalidConfiguration;
  kernel<<<blocks, fp8::kThreads, 0, stream>>>(
      static_cast<const T*>(x), alpha, static_cast<const T*>(g), static_cast<T*>(gx), ws,
      galpha, n, s.head, s.nvec, n >= kTabMinN ? 1 : 0, f);
  return (int)cudaGetLastError();
}

// Floats of the workspace B2 and B6 share: the ticket (zeroed once, by the
// caller, when it allocates the workspace; every launch leaves it 0), then
// the partials.
extern "C" int repro_quant_det_bwd_workspace() { return fp8::kFoldWorkspaceFloats; }

// bf16 != 0: x, g and gx are __nv_bfloat16, else float. One launch.
extern "C" int repro_quant_det_bwd(const void* x, const float* alpha,
                                   const void* g, void* gx, float* ws,
                                   float* galpha, long long n, int bf16,
                                   int exp, int mant, float mant_const,
                                   cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  return bf16 ? launch<__nv_bfloat16, 0>(x, alpha, g, gx, ws, galpha, n, false, f, stream)
              : launch<float, 0>(x, alpha, g, gx, ws, galpha, n, false, f, stream);
}

// The copy probe: the kernel's grid, access pattern and fold with the
// arithmetic removed (gx = g, the partials sum x). kind 0 the kernel's own
// pattern, 1 one element a thread in a grid-stride loop of at most 1024
// blocks (the first port's pattern, here with the fold in the same launch).
extern "C" int repro_quant_det_bwd_probe(int kind, const void* x, const void* g, void* gx,
                                         float* ws, float* galpha, long long n,
                                         int bf16, cudaStream_t stream) {
  const fp8::Fmt f{4, 3, 0.0f};
  return bf16 ? launch<__nv_bfloat16, 1>(x, nullptr, g, gx, ws, galpha, n, kind == 1, f,
                                         stream)
              : launch<float, 1>(x, nullptr, g, gx, ws, galpha, n, kind == 1, f, stream);
}
