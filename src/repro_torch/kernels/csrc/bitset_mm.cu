// K3 bitset_mm: boolean matrix product over bit-packed operands (the OR-AND semiring).
//
// Replaces the TPU kernel src/repro/kernels/bitset_mm.py::bitset_mm_pallas, which the
// public kernel API (repro.kernels.ops.bitset_mm) reaches: one transitive-closure step
// R |= R (.) R.
//
// Computes, for every row i of a uint32[n, wk] (wk = ceil(k/32); bit j of word w is
// column 32w + j) and every word c < wm of x uint32[k, wm]:
//     out[i, c] = OR over j < k with bit j of a[i] set of x[j, c]
// The port keeps the words as int32 bit patterns; the kernel reads them as uint32.  A bit
// at or beyond k in the last word of a row is masked off and never read through.
//
// Bound on an H100: it reads a once, one row of x per set bit of a, and writes out; one
// OR per set bit and word of x, so it is bound by bytes unless a is dense.  At the
// closure step of the "human" analogue (n = k = 38,811, wm = 1,213, 89,992 set bits, at
// most 64 in a row) that is a and out, 188 MB each, and 437 MB of x rows: 0.243 ms at
// 3.35 TB/s.
//
// Design.  The TPU kernel unpacks a (TN, TK) tile of a's bits in registers and OR-selects
// TK rows of x into a VMEM accumulator, for every bit, set or not.  On the card the work
// is a gather over the set bits only, and each row of a is read once.  A block owns one
// row of a and the whole output row:
//   1. its threads read the row in ranges of kRangeWords words (coalesced, evict-first),
//      each thread kRangeWords / kThreads words, kept in shared memory, and count their
//      set bits; a scan of the counts (shuffles in a warp, then the warps' sums) gives
//      each thread where its bits go in a list of column indices in shared memory;
//   2. each thread owns the output words c0 + tid + kThreads * s (s < kStrip), a strip
//      held in registers, walks the list and ORs the matching words of every listed x
//      row into them (4-byte loads at consecutive words: wm need not be a multiple of 4,
//      so a row of x is not 16-byte aligned in general), and writes its strip once
//      (streaming stores).  A row with no set bit reads no x and writes zeros.
// A range with more set bits than the list holds (a dense a) is gathered in passes of
// kList entries into the same registers, and an output row wider than kThreads * kStrip
// words in column chunks, so no row overflows shared memory.  Offsets are int64 and a
// grid-stride loop covers any n.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerThread = 8;
constexpr int kRangeWords = kThreads * kWordsPerThread;  // words of a a range holds
constexpr int kStrip = 8;                                // output words a thread holds
constexpr int kChunkWords = kThreads * kStrip;           // output words a chunk covers
constexpr int kList = 2048;                              // column indices a pass holds
constexpr int64_t kMaxBlocks = int64_t{1} << 20;

__global__ void __launch_bounds__(kThreads)
    bitset_mm_kernel(const uint32_t* __restrict__ a, int64_t n, int32_t wk,
                     const uint32_t* __restrict__ x, int64_t k, int32_t wm,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t a_s[kRangeWords];  // a thread reads back only the words it wrote
  __shared__ uint32_t cols[kList];  // column indices: k < 2^32
  __shared__ int32_t warp_sums[2][kWarps];  // two, so a range's scan never waits on the last
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t last_mask = (k % 32) ? ((1u << (k % 32)) - 1u) : 0xffffffffu;
  int parity = 0;
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    const uint32_t* a_row = a + i * wk;
    for (int32_t c0 = 0; c0 < wm; c0 += kChunkWords) {
      uint32_t acc[kStrip];
#pragma unroll
      for (int s = 0; s < kStrip; ++s) acc[s] = 0u;
      const uint32_t* x_col = x + c0 + tid;
      const int32_t strip_end = wm - c0 - tid;  // s is in the row while kThreads * s < this
      for (int32_t w0 = 0; w0 < wk; w0 += kRangeWords) {
        // 1. this thread's words of the range (w0 + tid + kThreads * r) and their bits
        int cnt = 0;
#pragma unroll
        for (int r = 0; r < kWordsPerThread; ++r) {
          const int32_t w = w0 + tid + kThreads * r;
          uint32_t v = 0u;
          if (w < wk) {
            v = __ldcs(a_row + w);
            if (w == wk - 1) v &= last_mask;
          }
          a_s[tid + kThreads * r] = v;
          cnt += __popc(v);
        }
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        if (lane == 31) warp_sums[parity][warp] = incl;
        __syncthreads();
        int start = incl - cnt, total = 0;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) {
          const int v = warp_sums[parity][q];
          total += v;
          if (q < warp) start += v;
        }
        parity ^= 1;
        // 2. the list in passes of kList entries, each gathered into the strip
        for (int32_t p0 = 0; p0 < total; p0 += kList) {
          if (p0) __syncthreads();  // every thread is done with the last pass's columns
          if (cnt && start < p0 + kList && start + cnt > p0) {
            int pos = start;
            for (int r = 0; r < kWordsPerThread; ++r) {
              uint32_t v = a_s[tid + kThreads * r];
              const uint32_t col0 = static_cast<uint32_t>(w0 + tid + kThreads * r) * 32u;
              while (v) {
                const int b = __ffs(v) - 1;
                v &= v - 1;
                if (pos >= p0 && pos < p0 + kList) cols[pos - p0] = col0 + b;
                ++pos;
              }
            }
          }
          __syncthreads();
          const int m = min(kList, total - p0);
#pragma unroll 2
          for (int e = 0; e < m; ++e) {
            const uint32_t* xr = x_col + static_cast<int64_t>(cols[e]) * wm;
#pragma unroll
            for (int s = 0; s < kStrip; ++s)
              if (kThreads * s < strip_end) acc[s] |= __ldg(xr + kThreads * s);
          }
        }
        // the next range's columns are written only after its scan's __syncthreads, which
        // every thread reaches after this gather
      }
      uint32_t* o = out + i * wm + c0 + tid;
#pragma unroll
      for (int s = 0; s < kStrip; ++s)
        if (kThreads * s < strip_end) __stcs(o + kThreads * s, acc[s]);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = success).
// All pointers are device pointers; the caller has checked shapes and types
// (wk == ceil(k / 32)).
extern "C" int bitset_mm_launch(const int32_t* a, int64_t n, int32_t wk, const int32_t* x,
                                int64_t k, int32_t wm, int32_t* out, void* stream) {
  if (n <= 0 || wm <= 0) return 0;
  if (k > int64_t{0xffffffff}) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = n < kMaxBlocks ? n : kMaxBlocks;
  bitset_mm_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(a), n, wk, reinterpret_cast<const uint32_t*>(x), k,
      wm, reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
