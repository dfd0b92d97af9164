// Static-table interleaved rANS over the wire's byte code stream: the decode
// (B12) and the encode that mirrors it, each over a cohort of same-table
// payloads in one launch.
//
// The decode replaces the TPU kernel src/repro/kernels/rans.py::
// rans_decode_pallas (_decode_kernel over _decode_step). The encode has no
// TPU kernel: the reference computes rans_encode as a lax.scan
// (src/repro/kernels/rans.py:81-125); a step-by-step PyTorch loop on the
// card would launch some twenty small operations per row of 16 symbols, so
// it runs here. core/entropy.py RansCodec codes a downlink's payload, or a
// cohort's uplink payloads together, with rans_encode_kernel and
// rans_decode_kernel (through kernels/dispatch.py): one launch of each a leg.
//
// The coder (the rans_byte configuration of the reference, int32-safe):
// frequencies of 12 bits summing to 4096, every one >= 1 (so <= 4096 - 255);
// the state stays in [L, 2^31) with L = 2^23; byte renormalization emits or
// consumes at most two bytes per symbol; 16 lanes, lane l codes symbols
// t * 16 + l of row t, the stream zero-padded to whole rows.
//
// Bound: neither bytes nor operations but each lane's dependent chain, one
// iteration a row: the next state needs the last one. A call takes at least
// rows times the latency of one iteration. Four things lengthened that
// iteration in the first port (one 16-thread block a payload, one launch a
// payload), and the design answers each:
// 1. Lanes idle and SMs idle: one block per payload, every payload of a
//    cohort in one launch (a block each, on its own SM). In a block, warp 0's
//    lanes 0..15 run the 16 chains and nothing else; warps 1..3 stage the
//    next phase's inputs into shared memory and write the last phase's
//    outputs to device memory while they do (phases of kDecRows / kEncRows
//    rows, double-buffered, __syncthreads between phases).
// 2. Memory on the decode's chain: a row looked up s_sym[slot], then
//    s_freq[s] and s_cum[s], then read row[p] from device memory, its address
//    known only once the state was. Now one 4096-entry u32 table, built per
//    launch in shared memory, packs freq | (slot - cum) << 12 | sym << 24, so a
//    row is x = freq * (x >> 12) + bias after one shared load. The staging
//    warps lay each lane's bytes out in shared memory in the order it
//    consumes them, byte k at clip(lens - 1 - k, 0, cols - 1) as
//    _decode_step reads it (so a stream whose lens or bytes are wrong decodes
//    as the reference's does); a row reads the two bytes at its index beside
//    its table lookup, both addresses known when the row starts. Which byte
//    comes k-th does not depend on the state, only how many a row takes
//    does, so the window of phase k + 1 is staged from where the lane stood
//    when phase k began, at most 2 bytes a row of both phases on. Decoded
//    symbols go to shared memory; the staging warps copy them out.
// 3. A 32-bit division and modulo on the encode's chain: ryg's rans_byte
//    reciprocals instead (a 256-entry table built once per table on the host,
//    kernels/ref.py rans_enc_table): x + bias + (mulhi(x, rcp) >> shift) *
//    (4096 - f) == ((x / f) << 12) + x % f + cum for every state the coder
//    reaches (proved over every f by the CPU tests). The staging warps look
//    each row's entry up, so a row reads one 8-byte entry at an address that
//    does not depend on the state; it writes its bytes out and their count
//    to shared memory, and the staging warps append them to the lane's
//    stream after the phase (a warp's shuffle scan places each run of rows),
//    so no global load or store is left in the coding loop.
// 4. Two dependent renorm steps: one decision from the state, n = (x < 2^23)
//    + (x < 2^15) bytes in the decode and (x >= f << 19) + (x >> 8 >= f << 19)
//    out in the encode, then one select among 0, 1 and 2 bytes; both equal the
//    two sequential steps for every state (the CPU tests).
// The format is unchanged: buffers, states, lengths and decoded symbols are
// bitwise the twins' in src/repro_torch/kernels/ref.py.
//
// rans_chain_kernel times the chains alone (one warp, no memory but the
// table): the decode's shared lookup, multiply-add and select, and the
// encode's select, high multiply, shift and multiply-add. Rows times that
// time is the pair's chain bound in chip_smoke.py.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;
constexpr int kScaleBits = 12;
constexpr int kTab = 1 << kScaleBits;
constexpr uint32_t kL = 1u << 23;
constexpr uint32_t kL2 = 1u << 15;          // x < kL2: a second byte after the first
constexpr int kThreshShift = 23 - kScaleBits + 8;  // emit while x >= f << 19
constexpr int kThreads = 128;                // warp 0: the lanes; warps 1..3: staging
constexpr int kStagers = kThreads - 32;
constexpr int kDecRows = 1024;               // decode rows a phase
constexpr int kWinWords = kDecRows + 5;      // a lane's window: >= 4 kDecRows + 8 bytes, odd words
constexpr int kEncRows = 512;                // encode rows a phase
constexpr int kEmitStride = kEncRows + 1;    // a lane's emit row: an odd stride, no bank conflict
constexpr size_t kDecodeSmem = sizeof(uint32_t) * (kTab + 2 * kLanes * kWinWords + 2 * 256) +
                               2 * kDecRows * kLanes + sizeof(int) * 2 * kLanes;
constexpr size_t kEncodeSmem = sizeof(uint2) * (256 + 2 * kEncRows * kLanes) +
                               sizeof(uint32_t) * 2 * kLanes * kEmitStride +
                               sizeof(long long) * kLanes;

__device__ __forceinline__ long long clip(long long p, long long hi) {
  return p < 0 ? 0 : (p > hi ? hi : p);
}

// The decode table: slot -> freq[s] | (slot - cum[s]) << 12 | s << 24,
// freq and cum staged in shared memory first (s_fc, 512 ints).
__device__ void build_decode_table(uint32_t* s_dec, int* s_fc, const int* __restrict__ freq,
                                   const int* __restrict__ cum,
                                   const int* __restrict__ slot2sym) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_fc[i] = __ldg(freq + i);
    s_fc[256 + i] = __ldg(cum + i);
  }
  __syncthreads();
#pragma unroll 8
  for (int i = threadIdx.x; i < kTab; i += blockDim.x) {
    const int s = __ldg(slot2sym + i);
    s_dec[i] = (uint32_t)s_fc[s] | (uint32_t)(i - s_fc[256 + s]) << 12 | (uint32_t)s << 24;
  }
}

// Window words a lane needs for a phase of `rows` rows after one of
// `prev` rows from the window's anchor: the reads lie below 2 (prev +
// rows) + 2 bytes on.
__device__ __forceinline__ int window_words(int prev, int rows) {
  return (2 * (prev + rows) + 2 + 3) / 4 + 1;
}

// Each lane's bytes in the order its decode consumes them, from consumption
// index s_k[l] on: byte i of lane l is its row's byte at clip(lens - 1 -
// s_k[l] - i, 0, cols - 1), as _decode_step reads it. Byte loads without a
// branch, so that many are in flight at once.
__device__ void stage_window(uint32_t* win, const int* s_k, const int* s_lens,
                             const uint8_t* __restrict__ buf, long long cols, int words,
                             int first, int stride) {
#pragma unroll 4
  for (int idx = first; idx < kLanes * words; idx += stride) {
    const int l = idx / words, j = idx - l * words;
    const uint8_t* row = buf + (long long)l * cols;
    const long long top = (long long)s_lens[l] - 1 - s_k[l] - 4LL * j;  // byte 4 j's position
    uint32_t v = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) v |= (uint32_t)__ldg(row + clip(top - c, cols - 1)) << (8 * c);
    win[l * kWinWords + j] = v;
  }
}

// The encode table entries of rows [r_lo, kEncRows) of a phase whose row 0
// is the payload's row t_lo (symbol 0 outside [0, n)), row r's lane l at
// r * 16 + l.
__device__ void stage_entries(uint2* dst, const uint2* s_enc, const uint8_t* __restrict__ syms,
                              long long n, long long t_lo, int r_lo, int first, int stride) {
#pragma unroll 8
  for (int idx = r_lo * kLanes + first; idx < kEncRows * kLanes; idx += stride) {
    const long long i = t_lo * kLanes + idx;
    dst[idx] = s_enc[i >= 0 && i < n ? __ldg(syms + i) : 0];
  }
}

// One phase's emitted bytes appended to each lane's stream, in coding order
// (rows from kEncRows - 1 down to r_lo), lanes dealt to warps 1..3: each
// warp's 32 threads take consecutive runs of rows (an odd count, so their
// reads fall in distinct banks), a shuffle scan places their bytes. emit
// holds out | n << 16 for lane l's row r at l * kEmitStride + r (n <= 2
// bytes, the first in out's low byte).
__device__ void append_bytes(const uint32_t* emit, int r_lo, uint8_t* __restrict__ buf,
                             long long cols, long long* s_pos) {
  const int warp = threadIdx.x / 32 - 1, t = threadIdx.x % 32;
  const int cnt = kEncRows - r_lo, per = (cnt + 31) / 32 | 1;
  const int j0 = min(cnt, t * per), j1 = min(cnt, j0 + per);
  for (int l = warp; l < kLanes; l += kStagers / 32) {
    int tot = 0;
    const uint32_t* e = emit + l * kEmitStride + kEncRows - 1;
    for (int j = j0; j < j1; ++j) tot += e[-j] >> 16;
    int inc = tot;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (t >= d) inc += v;
    }
    long long p = s_pos[l] + inc - tot;
    __syncwarp();
    uint8_t* row = buf + (long long)l * cols;
    for (int j = j0; j < j1; ++j) {
      const uint32_t v = e[-j];
      const uint32_t nn = v >> 16;
      if (nn > 0) row[p++] = (uint8_t)v;
      if (nn > 1) row[p++] = (uint8_t)(v >> 8);
    }
    if (t == 31) s_pos[l] += inc;
    __syncwarp();
  }
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
rans_encode_kernel(const uint8_t* __restrict__ syms_all, long long n, long long steps,
                   long long cols, const uint2* __restrict__ enc,
                   uint8_t* __restrict__ buf_all, int* __restrict__ state_all,
                   int* __restrict__ lens_all) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* s_enc = reinterpret_cast<uint2*>(smem);
  uint2* s_ent = s_enc + 256;                                         // [2][kEncRows][16]
  // [2][kLanes][kEmitStride]
  uint32_t* s_emit = reinterpret_cast<uint32_t*>(s_ent + 2 * kEncRows * kLanes);
  long long* s_pos = reinterpret_cast<long long*>(s_emit + 2 * kLanes * kEmitStride);
  const long long b = blockIdx.x;
  const uint8_t* syms = syms_all + b * n;
  uint8_t* buf = buf_all + b * kLanes * cols;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_enc[i] = enc[i];
  if (threadIdx.x < kLanes) s_pos[threadIdx.x] = 0;
  // rows run from the last down; phase k covers rows [t_lo(k), t_lo(k) +
  // kEncRows) of which those >= 0, its local row r the payload's t_lo + r
  const long long phases = (steps + kEncRows - 1) / kEncRows;
  auto t_lo = [&](long long k) { return steps - (k + 1) * kEncRows; };
  auto r_lo = [&](long long k) { return t_lo(k) < 0 ? (int)-t_lo(k) : 0; };
  __syncthreads();
  stage_entries(s_ent, s_enc, syms, n, t_lo(0), r_lo(0), threadIdx.x, kThreads);
  __syncthreads();
  const int lane = threadIdx.x;
  uint32_t x = kL;
  for (long long k = 0; k < phases; ++k) {
    if (threadIdx.x >= 32) {
      if (k + 1 < phases)
        stage_entries(s_ent + ((k + 1) & 1) * kEncRows * kLanes, s_enc, syms, n, t_lo(k + 1),
                      r_lo(k + 1), threadIdx.x - 32, kStagers);
      if (k > 0) append_bytes(s_emit + ((k - 1) & 1) * kLanes * kEmitStride, r_lo(k - 1), buf,
                              cols, s_pos);
    } else if (lane < kLanes) {
      const uint2* e_row = s_ent + (k & 1) * kEncRows * kLanes + lane;
      uint32_t* o = s_emit + ((k & 1) * kLanes + lane) * kEmitStride;
      const int r_end = r_lo(k);
      uint2 e_next = e_row[(kEncRows - 1) * kLanes];
#pragma unroll 4
      for (int r = kEncRows - 1; r >= r_end; --r) {
        // the next row's entry is read before this row's store, a row ahead
        const uint2 e = e_next;
        e_next = e_row[max(r - 1, r_end) * kLanes];
        const uint32_t rcp = e.x, bias = e.y & 0x1FFF, cmpl = (e.y >> 13) & 0xFFF,
                       shift = e.y >> 25;
        const uint32_t thresh = (4096u - cmpl) << kThreshShift;
        const bool one = x >= thresh, two = (x >> 8) >= thresh;
        const uint32_t out = two ? (x & 0xFFFF) | (2u << 16)
                                 : (one ? (x & 0xFF) | (1u << 16) : 0u);
        x = two ? x >> 16 : (one ? x >> 8 : x);
        x = x + bias + (__umulhi(x, rcp) >> shift) * cmpl;
        o[r] = out;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x >= 32)
    append_bytes(s_emit + ((phases - 1) & 1) * kLanes * kEmitStride, r_lo(phases - 1), buf,
                 cols, s_pos);
  __syncthreads();
  if (lane < kLanes) {
    state_all[b * kLanes + lane] = (int)x;
    lens_all[b * kLanes + lane] = (int)s_pos[lane];
  }
}

__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const uint8_t* __restrict__ buf_all, long long cols,
                   const int* __restrict__ state_all, const int* __restrict__ lens_all,
                   long long n, long long steps, const int* __restrict__ freq,
                   const int* __restrict__ cum, const int* __restrict__ slot2sym,
                   uint8_t* __restrict__ out_all) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_dec = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_win = s_dec + kTab;                        // [2][kLanes][kWinWords]
  int* s_fc = reinterpret_cast<int*>(s_win + 2 * kLanes * kWinWords);   // freq, cum
  uint8_t* s_out = reinterpret_cast<uint8_t*>(s_fc + 2 * 256);          // [2][kDecRows][16]
  int* s_k = reinterpret_cast<int*>(s_out + 2 * kDecRows * kLanes);     // window anchors
  int* s_lens = s_k + kLanes;
  const long long b = blockIdx.x;
  const uint8_t* buf = buf_all + b * kLanes * cols;
  uint8_t* out = out_all + b * n;
  const int lane = threadIdx.x;
  const bool coder = lane < kLanes;
  uint32_t x = 0;
  if (coder) {
    x = (uint32_t)state_all[b * kLanes + lane];
    s_lens[lane] = lens_all[b * kLanes + lane];
    s_k[lane] = 0;
  }
  build_decode_table(s_dec, s_fc, freq, cum, slot2sym);
  const long long phases = (steps + kDecRows - 1) / kDecRows;
  auto rows_of = [&](long long k) { return (int)min((long long)kDecRows, steps - k * kDecRows); };
  __syncthreads();
  stage_window(s_win, s_k, s_lens, buf, cols, window_words(0, rows_of(0)), threadIdx.x,
               kThreads);
  __syncthreads();
  int anchor = 0, kk = 0;   // the window's anchor and the lane's index in it
  for (long long k = 0; k < phases; ++k) {
    const int start = anchor + kk;   // consumed so far: the next window's anchor
    if (coder) s_k[lane] = start;
    __syncthreads();
    if (threadIdx.x >= 32) {
      if (k + 1 < phases)
        stage_window(s_win + ((k + 1) & 1) * kLanes * kWinWords, s_k, s_lens, buf, cols,
                     window_words(rows_of(k), rows_of(k + 1)), threadIdx.x - 32, kStagers);
      if (k > 0) {   // the last phase's symbols out
        const uint8_t* so = s_out + ((k - 1) & 1) * kDecRows * kLanes;
        const long long i0 = (k - 1) * kDecRows * kLanes;
        const int cnt = (int)min((long long)kDecRows * kLanes, n - i0);
#pragma unroll 4
        for (int i = threadIdx.x - 32; i < cnt; i += kStagers) out[i0 + i] = so[i];
      }
    } else if (coder) {
      const uint8_t* w = reinterpret_cast<const uint8_t*>(s_win + ((k & 1) * kLanes + lane) *
                                                          kWinWords);
      uint8_t* o = s_out + (k & 1) * kDecRows * kLanes + lane;
      const int rows = rows_of(k);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const uint32_t e = s_dec[x & (kTab - 1)];
        const uint32_t b0 = w[kk], b1 = w[kk + 1];
        x = (e & 0xFFF) * (x >> kScaleBits) + ((e >> 12) & 0xFFF);
        const bool one = x < kL, two = x < kL2;
        x = two ? (x << 16) | (b0 << 8) | b1 : (one ? (x << 8) | b0 : x);
        kk += (int)one + (int)two;
        o[r * kLanes] = (uint8_t)(e >> 24);
      }
      kk = anchor + kk - start;   // the next window is anchored where this phase began
      anchor = start;
    }
    __syncthreads();
  }
  const uint8_t* so = s_out + ((phases - 1) & 1) * kDecRows * kLanes;
  const long long i0 = (phases - 1) * kDecRows * kLanes;
  const int cnt = (int)min((long long)kDecRows * kLanes, n - i0);
  for (int i = threadIdx.x; i < cnt; i += kThreads) out[i0 + i] = so[i];
}

// The chains alone: `iters` dependent iterations on each of 32 threads.
// mode 0: the decode's (shared lookup, multiply-add, select); mode 1: the
// encode's (select, high multiply, shift, multiply-add) at symbol lane % 256.
__global__ void rans_chain_kernel(int mode, long long iters, const int* __restrict__ freq,
                                  const int* __restrict__ cum,
                                  const int* __restrict__ slot2sym,
                                  const uint2* __restrict__ enc, unsigned* __restrict__ out) {
  __shared__ uint32_t s_dec[kTab];
  __shared__ int s_fc[2 * 256];
  build_decode_table(s_dec, s_fc, freq, cum, slot2sym);
  __syncthreads();
  uint32_t x = kL + 977u * threadIdx.x;
  if (mode == 0) {
    const uint32_t b8 = 0x5Au, b16 = 0x5AA5u;
    for (long long i = 0; i < iters; ++i) {
      const uint32_t e = s_dec[x & (kTab - 1)];
      x = (e & 0xFFF) * (x >> kScaleBits) + ((e >> 12) & 0xFFF);
      const bool one = x < kL, two = x < kL2;
      x = two ? (x << 16) | b16 : (one ? (x << 8) | b8 : x);
    }
  } else {
    const uint2 e = enc[threadIdx.x];
    const uint32_t rcp = e.x, bias = e.y & 0x1FFF, cmpl = (e.y >> 13) & 0xFFF,
                   shift = e.y >> 25, thresh = (4096u - cmpl) << kThreshShift;
    for (long long i = 0; i < iters; ++i) {
      const bool one = x >= thresh, two = (x >> 8) >= thresh;
      x = two ? x >> 16 : (one ? x >> 8 : x);
      x = x + bias + (__umulhi(x, rcp) >> shift) * cmpl;
    }
  }
  out[threadIdx.x] = x;
}

extern "C" int repro_rans_encode(const uint8_t* syms, long long n, long long steps,
                                 long long cols, int batch, const void* enc, uint8_t* buf,
                                 int* state, int* lens, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        rans_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kEncodeSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  rans_encode_kernel<<<batch, kThreads, kEncodeSmem, stream>>>(
      syms, n, steps, cols, static_cast<const uint2*>(enc), buf, state, lens);
  return (int)cudaGetLastError();
}

extern "C" int repro_rans_decode(const uint8_t* buf, long long cols, const int* state,
                                 const int* lens, long long n, long long steps, int batch,
                                 const int* freq, const int* cum, const int* slot2sym,
                                 uint8_t* out, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        rans_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDecodeSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  rans_decode_kernel<<<batch, kThreads, kDecodeSmem, stream>>>(buf, cols, state, lens, n,
                                                               steps, freq, cum, slot2sym, out);
  return (int)cudaGetLastError();
}

extern "C" int repro_rans_chain(int mode, long long iters, const int* freq, const int* cum,
                                const int* slot2sym, const void* enc, unsigned* out,
                                cudaStream_t stream) {
  rans_chain_kernel<<<1, 32, 0, stream>>>(mode, iters, freq, cum, slot2sym,
                                          static_cast<const uint2*>(enc), out);
  return (int)cudaGetLastError();
}
