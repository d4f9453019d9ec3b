// K2 frontier_or: packed-frontier OR-gather over one ELL neighbor slab.
//
// Replaces the TPU kernel src/repro/kernels/frontier_ell.py::frontier_or_pallas, as
// src/repro/build/engine_jax.py::_expand_fn calls it (expand="pallas"): one BFS level
// of every member of a construction wave at once.
//
// Computes, for every row i of the slab nbr int32[r, d] and every word k < wm:
//     acc[i, k] = OR over s with nbr[i, s] != INVALID (-1) of f[nbr[i, s], k]
// where f uint32[n_src, wm] holds the packed member words (bit j of word k: wave member
// 32k + j expands here; the port keeps them as int32 bit patterns).  Two forms:
//   * perm == nullptr: out[i, k] = acc[i, k]            (out uint32[r, wm])
//   * perm != nullptr: out[perm[i], k] |= acc[i, k]     (out uint32[n_out, wm], in place)
//     the device build's fused form: the slab's rows are vertices perm[i] of the
//     degree-sorted ELL layout, so this ORs the slab into the running visited words and
//     undoes the permutation in the same pass.  flags[0] is set when a word gained a
//     bit (the BFS fixpoint's "changed" test).
// An id outside [-1, n_src), or a perm entry outside [0, n_out), is never read through:
// it is skipped and flags[1] is set; the wrapper (or its caller) raises on it.
//
// Bound on an H100: per launch it reads r*d*4 bytes of ids, wm*4 bytes of f for each
// valid slot and writes r*wm*4 bytes, with one OR per gathered word, so it is bound by
// bytes.  At the citeseer@1.0 out-slab (r = 273,180, d = 16, wm = 8) that is about
// 37 MB, about 11 us at 3.35 TB/s.  f (22 MB there) fits in the 50 MB L2.
//
// Design.  The TPU kernel walks a 128-row tile one slot and one row at a time with
// dynamic row loads from f held whole.  On the card the work is a gather, so one thread
// owns one (row, word) pair: the wm threads of a row read the row's ids (the same
// addresses, served once per warp) and, for each valid slot, wm consecutive words of
// one f row (one 32-byte sector at wm = 8).  The grid covers any r (no block_n padding;
// a grid-stride loop past 2^20 blocks), offsets are int64, and rows whose gathered
// words add no bit write nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalid = -1;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t{1} << 20;

__global__ void frontier_or_kernel(const int32_t* __restrict__ nbr, int64_t r, int32_t d,
                                   const uint32_t* __restrict__ f, int64_t n_src, int32_t wm,
                                   uint32_t* __restrict__ out, int64_t n_out,
                                   const int64_t* __restrict__ perm,
                                   int32_t* __restrict__ flags) {
  const int64_t total = r * wm;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t i = t / wm;
    const int32_t k = static_cast<int32_t>(t - i * wm);
    const int32_t* row = nbr + i * d;
    uint32_t acc = 0;
    bool bad = false;
    for (int32_t s = 0; s < d; ++s) {
      const int64_t id = __ldg(row + s);
      if (id == kInvalid) continue;
      if (id < 0 || id >= n_src) {
        bad = true;
        continue;
      }
      acc |= __ldg(f + id * wm + k);
    }
    if (perm == nullptr) {
      out[i * wm + k] = acc;
    } else {
      const int64_t dst = __ldg(perm + i);
      if (dst < 0 || dst >= n_out) {
        bad = true;
      } else {
        uint32_t* o = out + dst * wm + k;
        const uint32_t old = *o;
        if (acc & ~old) {
          *o = old | acc;
          flags[0] = 1;
        }
      }
    }
    if (bad) flags[1] = 1;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = success).
// All pointers are device pointers (perm may be null); the caller has checked shapes,
// types and that f does not alias out.
extern "C" int frontier_or_launch(const int32_t* nbr, int64_t r, int32_t d,
                                  const int32_t* f, int64_t n_src, int32_t wm,
                                  int32_t* out, int64_t n_out, const int64_t* perm,
                                  int32_t* flags, void* stream) {
  const int64_t total = r * wm;
  if (total <= 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  frontier_or_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      nbr, r, d, reinterpret_cast<const uint32_t*>(f), n_src, wm,
      reinterpret_cast<uint32_t*>(out), n_out, perm, flags);
  return static_cast<int>(cudaGetLastError());
}
