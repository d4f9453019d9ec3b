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
// Bound on an H100: it reads a and x once and writes out, and does one OR per set bit
// of a and word of x, so it is bound by bytes unless a is dense.  A closure step
// bitset_mm(R, R) reads R once: at the "human" analogue (n = k = 38,811, wm = 1,213,
// 89,992 set bits) R and out are 188 MB each, about 0.112 ms at 3.35 TB/s.
//
// Design.  The TPU kernel unpacks a (TN, TK) tile of a's bits in registers and OR-selects
// TK rows of x into a VMEM accumulator, for every bit, set or not.  On the card the work
// is a gather over the set bits only: a block owns one row of a and a run of up to 256
// word columns, one column per thread.  The row's words are staged in shared memory in
// tiles of 1024; each warp finds the nonzero words 32 at a time with a ballot, and for
// every set bit all its threads read one row of x at consecutive words (coalesced) and OR
// it into their column.  The blocks of one row are adjacent in the grid, so the row of a
// they all stage comes from L2 after the first.  Offsets are int64 and a grid-stride loop
// covers any n.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileWords = 1024;
constexpr int kMaxThreads = 256;
constexpr int64_t kMaxBlocks = int64_t{1} << 20;

__global__ void bitset_mm_kernel(const uint32_t* __restrict__ a, int64_t n, int32_t wk,
                                 const uint32_t* __restrict__ x, int64_t k, int32_t wm,
                                 int32_t col_blocks, uint32_t* __restrict__ out) {
  __shared__ uint32_t a_s[kTileWords];
  const int lane = threadIdx.x & 31;
  const uint32_t last_mask = (k % 32) ? ((1u << (k % 32)) - 1u) : 0xffffffffu;
  const int64_t total = n * col_blocks;
  for (int64_t t = blockIdx.x; t < total; t += gridDim.x) {
    const int64_t i = t / col_blocks;
    const int32_t c = static_cast<int32_t>(t - i * col_blocks) * blockDim.x + threadIdx.x;
    const bool active = c < wm;
    const uint32_t* a_row = a + i * wk;
    uint32_t acc = 0;
    for (int32_t w0 = 0; w0 < wk; w0 += kTileWords) {
      const int32_t nw = min(kTileWords, wk - w0);
      __syncthreads();  // every thread is done with the previous tile
      for (int32_t w = threadIdx.x; w < nw; w += blockDim.x) {
        uint32_t word = __ldg(a_row + w0 + w);
        if (w0 + w == wk - 1) word &= last_mask;
        a_s[w] = word;
      }
      __syncthreads();
      // warp-uniform walk: every lane sees the same words and bits
      for (int32_t w = 0; w < nw; w += 32) {
        const uint32_t mine = (w + lane < nw) ? a_s[w + lane] : 0u;
        uint32_t nonzero = __ballot_sync(0xffffffffu, mine != 0u);
        while (nonzero) {
          const int src = __ffs(nonzero) - 1;
          nonzero &= nonzero - 1;
          uint32_t word = __shfl_sync(0xffffffffu, mine, src);
          const int64_t base = static_cast<int64_t>(w0 + w + src) * 32;
          while (word) {
            const int b = __ffs(word) - 1;
            word &= word - 1;
            if (active) acc |= __ldg(x + (base + b) * wm + c);
          }
        }
      }
    }
    if (active) out[i * wm + c] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = success).
// All pointers are device pointers; the caller has checked shapes and types
// (wk == ceil(k / 32)).
extern "C" int bitset_mm_launch(const int32_t* a, int64_t n, int32_t wk, const int32_t* x,
                                int64_t k, int32_t wm, int32_t* out, void* stream) {
  if (n <= 0 || wm <= 0) return 0;
  const int threads = wm >= kMaxThreads ? kMaxThreads : ((wm + 31) / 32) * 32;
  const int32_t col_blocks = (wm + threads - 1) / threads;
  int64_t blocks = n * col_blocks;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bitset_mm_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(a), n, wk, reinterpret_cast<const uint32_t*>(x), k,
      wm, col_blocks, reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
