// Static-table interleaved rANS over the wire's byte code stream: the decode
// (B12) and the encode that mirrors it.
//
// The decode replaces the TPU kernel src/repro/kernels/rans.py::
// rans_decode_pallas (_decode_kernel over _decode_step). The encode has no
// TPU kernel: the reference computes rans_encode as a lax.scan
// (src/repro/kernels/rans.py:81-125); a step-by-step PyTorch loop on the
// card would launch some twenty small operations per row of 16 symbols, so
// it runs here, with the decode's arithmetic mirrored. core/entropy.py
// RansCodec encodes every rans: leg's code stream with rans_encode_kernel and
// decodes it with rans_decode_kernel (through kernels/dispatch.py
// rans_decode), once per payload.
//
// The coder (the rans_byte configuration of the reference, int32-safe):
// frequencies of 12 bits summing to 4096, every one >= 1 (so <= 4096 - 255);
// the state stays in [L, 2^31) with L = 2^23; byte renormalization emits or
// consumes at most two bytes per symbol; 16 lanes, lane l codes symbols
// t * 16 + l of row t, the stream zero-padded to whole rows.
//
// Bound: neither bytes nor operations. Each lane is a chain of `steps`
// dependent iterations (a table lookup, a division or multiply, and up to
// two byte moves whose condition depends on the state just computed), so a
// call takes at least steps times the latency of one iteration, far above
// the time to move its few bytes. Design: one block per payload; its 128
// threads stage the table into shared memory (freq and cum as int32,
// slot2sym as u8: 6 KB), then threads 0..15 each run one lane's iterations
// in order. The encode writes each lane's bytes in order from column 0 into a
// buffer the wrapper zero-fills; the decode reads its lane backward from
// lens - 1, at clip(rpos, 0, cols - 1) as _decode_step does, but only when
// the byte is needed (the reference reads it and then discards it), so it
// never reads outside the buffer. Integer-only: bitwise equal to the twins
// in src/repro_torch/kernels/ref.py.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;
constexpr int kScaleBits = 12;
constexpr int kTab = 1 << kScaleBits;
constexpr int kL = 1 << 23;
constexpr int kRenorms = 2;
constexpr int kThreshShift = 23 - kScaleBits + 8;  // x < f << 19 before coding f
constexpr int kThreads = 128;

}  // namespace

__global__ void rans_encode_kernel(const uint8_t* __restrict__ syms, long long n,
                                   long long steps, long long cols,
                                   const int* __restrict__ freq,
                                   const int* __restrict__ cum,
                                   uint8_t* __restrict__ buf,
                                   int* __restrict__ state,
                                   int* __restrict__ lens) {
  __shared__ int s_freq[256];
  __shared__ int s_cum[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_freq[i] = freq[i];
    s_cum[i] = cum[i];
  }
  __syncthreads();
  const int lane = threadIdx.x;
  if (lane >= kLanes) return;
  uint8_t* row = buf + lane * cols;
  int x = kL;
  long long ptr = 0;
  // rANS is a stack: code the last row first so the decode pops in order
  for (long long t = steps - 1; t >= 0; --t) {
    const long long i = t * kLanes + lane;
    const int s = i < n ? syms[i] : 0;
    const int f = s_freq[s];
    const int thresh = f << kThreshShift;
#pragma unroll
    for (int r = 0; r < kRenorms; ++r) {
      if (x >= thresh) {
        row[ptr++] = (uint8_t)(x & 0xFF);
        x >>= 8;
      }
    }
    x = ((x / f) << kScaleBits) + (x % f) + s_cum[s];
  }
  state[lane] = x;
  lens[lane] = (int)ptr;
}

__global__ void rans_decode_kernel(const uint8_t* __restrict__ buf, long long cols,
                                   const int* __restrict__ state,
                                   const int* __restrict__ lens, long long n,
                                   long long steps, const int* __restrict__ freq,
                                   const int* __restrict__ cum,
                                   const int* __restrict__ slot2sym,
                                   uint8_t* __restrict__ out) {
  __shared__ int s_freq[256];
  __shared__ int s_cum[256];
  __shared__ uint8_t s_sym[kTab];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_freq[i] = freq[i];
    s_cum[i] = cum[i];
  }
  for (int i = threadIdx.x; i < kTab; i += blockDim.x) {
    s_sym[i] = (uint8_t)slot2sym[i];
  }
  __syncthreads();
  const int lane = threadIdx.x;
  if (lane >= kLanes) return;
  const uint8_t* row = buf + lane * cols;
  int x = state[lane];
  long long rpos = (long long)lens[lane] - 1;
  for (long long t = 0; t < steps; ++t) {
    const int slot = x & (kTab - 1);
    const int s = s_sym[slot];
    x = s_freq[s] * (x >> kScaleBits) + slot - s_cum[s];
#pragma unroll
    for (int r = 0; r < kRenorms; ++r) {
      if (x < kL) {
        const long long p = rpos < 0 ? 0 : (rpos > cols - 1 ? cols - 1 : rpos);
        x = (x << 8) | (int)row[p];
        --rpos;
      }
    }
    const long long i = t * kLanes + lane;
    if (i < n) out[i] = (uint8_t)s;
  }
}

extern "C" int repro_rans_encode(const uint8_t* syms, long long n, long long steps,
                                 long long cols, const int* freq, const int* cum,
                                 uint8_t* buf, int* state, int* lens,
                                 cudaStream_t stream) {
  rans_encode_kernel<<<1, kThreads, 0, stream>>>(syms, n, steps, cols, freq, cum,
                                                 buf, state, lens);
  return (int)cudaGetLastError();
}

extern "C" int repro_rans_decode(const uint8_t* buf, long long cols, const int* state,
                                 const int* lens, long long n, long long steps,
                                 const int* freq, const int* cum,
                                 const int* slot2sym, uint8_t* out,
                                 cudaStream_t stream) {
  rans_decode_kernel<<<1, kThreads, 0, stream>>>(buf, cols, state, lens, n, steps,
                                                 freq, cum, slot2sym, out);
  return (int)cudaGetLastError();
}
