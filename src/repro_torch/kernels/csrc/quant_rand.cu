// Q_rand (paper Eq. 3) and its straight-through backward: the weight
// quantizer of stochastic QAT (QATConfig(mode="rand"), the Table 2 ablation).
//
// Replaces the TPU kernels src/repro/kernels/fp8_quant.py::quant_rand
// (_quant_rand_kernel) and quant_rand_bwd (_quant_rand_bwd_kernel):
//
//   forward   out     = s * (floor(y) + 1{u < y - floor(y)}),  u = bits * 2^-32
//   backward  gx      = g * 1{|x| <= a}
//             g_alpha = sum g * (sign(x) * 1{|x| > a} + (q - y) * s / a)
//
// with q the forward's stochastic value (the same bits). Two routes for the
// bits, a template parameter of both kernels: read from memory, one u32 an
// element (the reference's replayed jax.random.bits, which parity needs),
// or drawn inside the kernel from the counter RNG, bits[i] =
// fmix32(fmix32((u32)i ^ (k0 ^ mix)) ^ k1) with (k0, k1) the client step's
// key words, read from the device, and mix the site's word (counter_bits,
// bitwise ref.CounterKey.bits). The counter route reads no bits and leaves
// no bits tensor to make or to keep for the backward.
//
// Bound: memory, but launch-sized at the rand-qat weights (6400 elements at
// most: 0.02-0.03 us of bytes against about 2 us a launch). The bytes are 8
// an element forward with counter bits (x read, out written) and 12 with
// bits read; 12 and 16 backward (g read, gx written). The first port read
// one element a thread with scalar loads, took det_code's log2f / exp2f for
// every element at every size, and ran its backward as two launches (block
// partials, then a second kernel folding them), and the engine spent about
// 42 elementwise launches a weight site making the bits in int64.
//
// Design. B1/B2's (quant_det.cu, quant_det_bwd.cu): units of 8 elements in
// 16-byte vectors of x (and g, and the bits when read), each unit's
// successor loaded before the unit is computed, about kBatchesPerThread
// units a thread, the one-element path for the ragged head and tail and for
// operands whose offsets differ mod 16; one element a thread at the small
// shapes (the forward while the card holds every thread, the backward on at
// most one block an SM, so that the fold's tail stays short); from kTabMinN
// elements on, s from the clip's scale table (fp8_common.cuh), which gives
// det_code's s bit for bit. So out and gx are bitwise the twins' on either
// route. The backward is one launch: each block's partial goes to the
// workspace B2 uses (reduce.cuh, fold_by_last_block) and the last block
// folds them in a fixed order; the grid depends only on n and the card, so
// g_alpha is the same on every call, within GA_RTOL of the twin's (another
// order of the sum; on the table route the last division by a is a product
// by 1 / a, as B2's).
#include "reduce.cuh"

// From here on the table route pays (its build, about 0.9 us a block on the
// card, qat_probe.py, against det_code's longer element function), as B1/B2.
static constexpr long long kTabMinN = 1 << 20;
static constexpr int kBatchesPerThread = 4;   // a thread's units of work, each 8 elements
static constexpr int kUnroll = 2;             // f32 vectors of each operand in a unit
// The backward: up to this many elements a thread on the one-element path,
// where that keeps the grid within one block an SM (quant_det_bwd.cu).
static constexpr long long kSmallPerThread = 4;

// Element i's 32 bits: read from ``bits`` (COUNTER 0), or drawn from the
// key words (COUNTER 1; k0 already holds the site's mix).
template <int COUNTER>
struct SiteBits {
  const uint32_t* __restrict__ bits;
  uint32_t k0, k1;
  __device__ __forceinline__ uint32_t at(long long i) const {
    return COUNTER ? fp8::counter_bits((uint32_t)i, k0, k1) : bits[i];
  }
};

// The grid-stride loop over one launch's elements: ``op(x, g, bits, acc)``
// is the element function (its result written to out; g is 0 forward, where
// ``g`` is null). Vectors of x, g (BWD) and the bits (read route), kUnroll a
// unit, the first unit already loaded into rx / rg / rb, each unit's
// successor loaded before the unit is computed; then the one-element path
// (head and tail, or everything where the operands are misaligned).
template <bool BWD, int COUNTER, typename Op>
static __device__ __forceinline__ float stream_rand(
    const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ out,
    const SiteBits<COUNTER>& sb, long long n, long long head, long long nvec,
    uint4 (&rx)[kUnroll], uint4 (&rg)[kUnroll], uint4 (&rb)[kUnroll], Op op) {
  constexpr int U = kUnroll;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  const uint4* __restrict__ gv = reinterpret_cast<const uint4*>(BWD ? g + head : nullptr);
  const uint4* __restrict__ bv =
      reinterpret_cast<const uint4*>(COUNTER ? nullptr : sb.bits + head);
  uint4* __restrict__ ov = reinterpret_cast<uint4*>(out + head);
  float acc = 0.0f;
  for (long long j0 = tid; j0 < nvec; j0 += U * nthreads) {
    const long long next = j0 + U * nthreads;
    uint4 nx[U], ng[U], nb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = next + u * nthreads;
      if (j < nvec) {
        nx[u] = xv[j];
        if constexpr (BWD) ng[u] = gv[j];
        if constexpr (!COUNTER) nb[u] = bv[j];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = j0 + u * nthreads;
      if (j < nvec) {
        float vx[4], vg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        uint32_t w[4];
        fp8::Vec<float>::unpack(rx[u], vx);
        if constexpr (BWD) fp8::Vec<float>::unpack(rg[u], vg);
        if constexpr (COUNTER) {
          const long long i0 = head + 4 * j;
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] = sb.at(i0 + e);
        } else {
          w[0] = rb[u].x;
          w[1] = rb[u].y;
          w[2] = rb[u].z;
          w[3] = rb[u].w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) vx[e] = op(vx[e], vg[e], w[e], acc);
        ov[j] = fp8::Vec<float>::pack(vx);
      }
      rx[u] = nx[u];
      if constexpr (BWD) rg[u] = ng[u];
      if constexpr (!COUNTER) rb[u] = nb[u];
    }
  }
  const long long vec_end = head + nvec * 4;
  const long long n_scalar = head + (n - vec_end);
  for (long long k = tid; k < n_scalar; k += nthreads) {
    const long long i = k < head ? k : vec_end + (k - head);   // head, then tail
    out[i] = op(x[i], BWD ? g[i] : 0.0f, sb.at(i), acc);
  }
  return acc;
}

// A launch's arguments (bits null on the counter route, key and mix unused
// on the other; g, ws and galpha null forward)
struct RandArgs {
  const float* x;
  const float* alpha;
  const uint32_t* bits;
  const uint32_t* key;
  uint32_t mix;
  const float* g;
  float* out;
  float* ws;
  float* galpha;
  long long n, head, nvec;
  int use_tab;
  fp8::Fmt f;
};

// The forward (BWD false: out = Q_rand(x)) or the backward (BWD true: out =
// gx, and g_alpha folded into galpha through the workspace ws); the two
// kernels below, one name each for a profile.
template <bool BWD, int COUNTER>
static __device__ __forceinline__ void quant_rand_body(const RandArgs& p) {
  const float* __restrict__ x = p.x;
  const uint32_t* __restrict__ bits = p.bits;
  const float* __restrict__ g = p.g;
  float* __restrict__ out = p.out;
  const long long n = p.n, head = p.head, nvec = p.nvec;
  const bool use_tab = p.use_tab != 0;
  const fp8::Fmt f = p.f;
  __shared__ fp8::ScaleTable tab;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // alpha and the key first (the table's chain starts at alpha), then the
  // first unit's loads, all before the table is built
  const float alpha0 = p.alpha[0];
  SiteBits<COUNTER> sb{bits, 0u, 0u};
  if constexpr (COUNTER) {
    sb.k0 = p.key[0] ^ p.mix;
    sb.k1 = p.key[1];
  }
  uint4 rx[kUnroll], rg[kUnroll], rb[kUnroll];
  {
    const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
    const uint4* __restrict__ gv = reinterpret_cast<const uint4*>(BWD ? g + head : nullptr);
    const uint4* __restrict__ bv =
        reinterpret_cast<const uint4*>(COUNTER ? nullptr : bits + head);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = tid + u * nthreads;
      if (j < nvec) {
        rx[u] = xv[j];
        if constexpr (BWD) rg[u] = gv[j];
        if constexpr (!COUNTER) rb[u] = bv[j];
      }
    }
  }
  const float a = fmaxf(alpha0, fp8::kAlphaFloor);
  const float la = log2f(a);
  const float b = fp8::bias_of_log(la, f);
  if (use_tab) fp8::scale_table_build(tab, a, la, b, f);   // block-uniform
  if constexpr (!BWD) {
    if (use_tab && tab.ok) {
      stream_rand<false>(x, g, out, sb, n, head, nvec, rx, rg, rb,
                         [&](float xi, float, uint32_t w, float&) {
        const float xc = fp8::clip(xi, a);
        const float s = fp8::table_scale(tab, xc);
        return s * fp8::round_rand(xc / s, w);
      });
    } else {
      stream_rand<false>(x, g, out, sb, n, head, nvec, rx, rg, rb,
                         [&](float xi, float, uint32_t w, float&) {
        const float xc = fp8::clip(xi, a);
        const float s = fp8::scale(fp8::exponent(xc, b), b, f);
        return s * fp8::round_rand(xc / s, w);
      });
    }
  } else {
    __shared__ float sh[fp8::kThreads / 32];
    float acc;
    if (use_tab && tab.ok) {
      const float inv_a = 1.0f / a;
      acc = stream_rand<true>(x, g, out, sb, n, head, nvec, rx, rg, rb,
                              [&](float xi, float gi, uint32_t w, float& s_acc) {
        const float inside = fabsf(xi) <= a ? 1.0f : 0.0f;
        const float xc = fp8::clip(xi, a);
        const float s = fp8::table_scale(tab, xc);
        const float y = xc / s;
        const float q = fp8::round_rand(y, w);
        const float sg = xi > 0.0f ? 1.0f : (xi < 0.0f ? -1.0f : 0.0f);
        s_acc += gi * (sg * (1.0f - inside) + ((q - y) * s) * inv_a);
        return gi * inside;
      });
    } else {
      acc = stream_rand<true>(x, g, out, sb, n, head, nvec, rx, rg, rb,
                              [&](float xi, float gi, uint32_t w, float& s_acc) {
        const float inside = fabsf(xi) <= a ? 1.0f : 0.0f;
        const float xc = fp8::clip(xi, a);
        const float s = fp8::scale(fp8::exponent(xc, b), b, f);
        const float y = xc / s;
        const float q = fp8::round_rand(y, w);
        const float sg = xi > 0.0f ? 1.0f : (xi < 0.0f ? -1.0f : 0.0f);
        s_acc += gi * (sg * (1.0f - inside) + (q - y) * s / a);
        return gi * inside;
      });
    }
    fp8::fold_by_last_block(acc, p.ws + fp8::kFoldTicketFloats,
                            reinterpret_cast<unsigned int*>(p.ws), p.galpha, sh);
  }
}

template <int COUNTER>
__global__ void __launch_bounds__(fp8::kThreads) quant_rand_kernel(RandArgs p) {
  quant_rand_body<false, COUNTER>(p);
}

template <int COUNTER>
__global__ void __launch_bounds__(fp8::kThreads) quant_rand_bwd_kernel(RandArgs p) {
  quant_rand_body<true, COUNTER>(p);
}

template <bool BWD, int COUNTER>
static int launch(const float* x, const float* alpha, const uint32_t* bits,
                  const uint32_t* key, uint32_t mix, const float* g, float* out, float* ws,
                  float* galpha, long long n, const fp8::Fmt& f, cudaStream_t stream) {
  static fp8::Residency resident[fp8::kMaxDevices] = {};
  const auto kernel = BWD ? quant_rand_bwd_kernel<COUNTER> : quant_rand_kernel<COUNTER>;
  const fp8::Residency res = fp8::residency(kernel, resident);
  fp8::Split s = COUNTER ? (BWD ? fp8::split_for(n, 4, {x, g, out})
                                : fp8::split_for(n, 4, {x, out}))
                         : (BWD ? fp8::split_for(n, 4, {x, g, out, bits})
                                : fp8::split_for(n, 4, {x, out, bits}));
  const long long want = (n + fp8::kThreads - 1) / fp8::kThreads;
  int blocks;
  if (!BWD && want <= res.blocks) {   // every thread held at once: one element each
    s = {n, 0};
    blocks = fp8::grid_for(n);
  } else if (BWD && n <= (long long)res.sms * fp8::kThreads * kSmallPerThread) {
    s = {n, 0};
    blocks = (int)(want < res.sms ? (want < 1 ? 1 : want) : res.sms);
  } else {
    const long long units = (s.nvec + kUnroll - 1) / kUnroll + (n - s.nvec * 4);
    blocks = fp8::stream_blocks(units, kBatchesPerThread, res);
  }
  if (BWD && blocks > fp8::kFoldPartials) return (int)cudaErrorInvalidConfiguration;
  const RandArgs args{x, alpha, bits, key, mix, g, out, ws, galpha,
                      n, s.head, s.nvec, n >= kTabMinN ? 1 : 0, f};
  kernel<<<blocks, fp8::kThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

// bits != nullptr: the bits read from memory, one u32 an element of x; else
// drawn from the two u32 key words at ``key`` (on the device) and the site's
// word ``mix``.
extern "C" int repro_quant_rand(const float* x, const float* alpha, const uint32_t* bits,
                                const uint32_t* key, uint32_t mix, float* out, long long n,
                                int exp, int mant, float mant_const, cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  return bits ? launch<false, 0>(x, alpha, bits, nullptr, 0u, nullptr, out, nullptr, nullptr,
                                 n, f, stream)
              : launch<false, 1>(x, alpha, nullptr, key, mix, nullptr, out, nullptr, nullptr,
                                 n, f, stream);
}

// One launch; ``ws`` is B2's workspace (repro_quant_det_bwd_workspace floats,
// the ticket at 0), shared by the calls on one stream.
extern "C" int repro_quant_rand_bwd(const float* x, const float* alpha, const uint32_t* bits,
                                    const uint32_t* key, uint32_t mix, const float* g,
                                    float* gx, float* ws, float* galpha, long long n, int exp,
                                    int mant, float mant_const, cudaStream_t stream) {
  const fp8::Fmt f{exp, mant, mant_const};
  return bits ? launch<true, 0>(x, alpha, bits, nullptr, 0u, g, gx, ws, galpha, n, f, stream)
              : launch<true, 1>(x, alpha, nullptr, key, mix, g, gx, ws, galpha, n, f, stream);
}
