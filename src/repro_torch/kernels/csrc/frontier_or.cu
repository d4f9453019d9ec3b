// K2 frontier_or: packed-frontier OR-gather over one ELL neighbor slab.
//
// Replaces the TPU kernel src/repro/kernels/frontier_ell.py::frontier_or_pallas, as
// src/repro/build/engine_jax.py::_expand_fn calls it (expand="pallas"): one BFS level
// of every member of a construction wave at once.  K2's slab form, the public
// ops.frontier_or; the device build runs K2's frontier form, frontier_expand.cu.
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
// valid slot, perm and the out rows, and writes the out rows that gain a bit, with one
// OR per gathered word, so it is bound by bytes.  At the citeseer@1.0 out-slab (r =
// 273,180, d = 16, wm = 8, about 1.3 valid slots a row) that is 39.5 MB, 11.8 us at
// 3.35 TB/s; f (22 MB there) fits in the 50 MB L2.
//
// Design.  The TPU kernel walks a 128-row tile one slot and one row at a time with
// dynamic row loads from f held whole.  On the card the work is a gather of short
// rows.  A thread per (row, word) read all d ids of its row 4 bytes at a time (16 loads
// a thread at d = 16, most of them INVALID) and put each slot's f load behind its id's
// load and a branch, so few gathers were in flight.  Here:
//   1. wm / VEC threads own a row, VEC = 4 consecutive words each (one 16-byte load;
//      one thread a row at wm = 4, two at wm = 8).  They read the row's ids once, 16
//      slots at a time as 16-byte vectors, and turn them into a bitmask of valid slots.
//      The ids and perm are read once a call, so they are loaded evict-first (__ldcs),
//      which leaves the L2 to f and out.
//   2. The frontier words of the valid slots are loaded kInFlight at a time, every load
//      issued before the ORs, as K5's ell_spmm does with its source rows; padding costs
//      no load of f.  In the fused form perm[i] is read with the ids and out[perm[i]]
//      while the gathers are in flight: two dependent round trips a row.
//   3. The fused form reads and writes out[perm[i]] 16 bytes a thread, and writes only
//      a vector that gained a bit.  flags[0] and flags[1] are set once a warp after a
//      vote, not by every thread.
//   4. wm not a multiple of 4, or f / out not 16-byte aligned, take the same loop one
//      word a thread (VEC = 1); d not a multiple of 4, or an unaligned slab, read the
//      ids 4 bytes at a time (IDV = 1).  The launch picks both.
// The grid covers any r (a grid-stride loop past 2^20 blocks, warp-uniform so the votes
// see every lane) and offsets are int64.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalid = -1;
constexpr int kThreads = 256;
constexpr int kChunk = 16;      // slots whose ids a thread holds at once
constexpr int kInFlight = 4;    // frontier vectors loaded before they are ORed
constexpr int64_t kMaxBlocks = int64_t{1} << 20;

template <int VEC>
struct Words;
template <>
struct Words<1> {
  using type = uint32_t;
  static __device__ __forceinline__ type zero() { return 0u; }
  static __device__ __forceinline__ type ldg(const uint32_t* p) { return __ldg(p); }
  static __device__ __forceinline__ type load(const uint32_t* p) { return *p; }
  static __device__ __forceinline__ void store(uint32_t* p, type v) { *p = v; }
  static __device__ __forceinline__ void orin(type& a, type b) { a |= b; }
  static __device__ __forceinline__ bool gains(type acc, type old) { return (acc & ~old) != 0; }
};
template <>
struct Words<4> {
  using type = uint4;
  static __device__ __forceinline__ type zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ type ldg(const uint32_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ type load(const uint32_t* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void store(uint32_t* p, type v) {
    *reinterpret_cast<uint4*>(p) = v;
  }
  static __device__ __forceinline__ void orin(type& a, type b) {
    a.x |= b.x;
    a.y |= b.y;
    a.z |= b.z;
    a.w |= b.w;
  }
  static __device__ __forceinline__ bool gains(type acc, type old) {
    return ((acc.x & ~old.x) | (acc.y & ~old.y) | (acc.z & ~old.z) | (acc.w & ~old.w)) != 0;
  }
};

// ids[k] for a k known only at run time, by selects: an indexed register array would
// go to local memory
__device__ __forceinline__ int32_t pick(const int32_t (&ids)[kChunk], int k) {
  int32_t x = ids[0];
#pragma unroll
  for (int j = 1; j < kChunk; ++j) x = k == j ? ids[j] : x;
  return x;
}

template <int VEC, int IDV>
__global__ void __launch_bounds__(kThreads)
    frontier_or_kernel(const int32_t* __restrict__ nbr, int64_t r, int32_t d,
                       const uint32_t* __restrict__ f, int64_t n_src, int32_t wm,
                       uint32_t* __restrict__ out, int64_t n_out,
                       const int64_t* __restrict__ perm, int32_t* __restrict__ flags) {
  using W = Words<VEC>;
  using V = typename W::type;
  const int32_t per_row = wm / VEC;   // threads a row
  const int64_t total = r * per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int lane = threadIdx.x & 31;
  bool bad = false, changed = false;
  // warp-uniform trip count: every lane reaches the votes at the end
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
       base < total; base += stride) {
    const int64_t t = base + lane;
    if (t >= total) continue;
    const int64_t i = t / per_row;
    const int32_t c = static_cast<int32_t>(t - i * per_row) * VEC;   // first word
    const int32_t* row = nbr + i * d;
    int64_t dst = 0;
    if (perm != nullptr) dst = __ldcs(perm + i);
    const bool fused_ok = perm != nullptr && dst >= 0 && dst < n_out;
    bad |= perm != nullptr && !fused_ok;
    V acc = W::zero();
    V old = W::zero();
    for (int32_t s0 = 0; s0 < d; s0 += kChunk) {
      // the chunk's ids, every load issued before any is used
      int32_t ids[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; k += IDV) {
        const int32_t s = s0 + k;
        if constexpr (IDV == 4) {
          if (s < d) {   // d % 4 == 0: the whole vector lies in the row
            const int4 v = __ldcs(reinterpret_cast<const int4*>(row + s));
            ids[k] = v.x; ids[k + 1] = v.y; ids[k + 2] = v.z; ids[k + 3] = v.w;
          } else {
            ids[k] = ids[k + 1] = ids[k + 2] = ids[k + 3] = kInvalid;
          }
        } else {
          ids[k] = s < d ? __ldcs(row + s) : kInvalid;
        }
      }
      // the row's out words, read while the gathers below are in flight
      if (s0 == 0 && fused_ok) old = W::load(out + dst * wm + c);
      uint32_t todo = 0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const bool ok = ids[k] >= 0 && ids[k] < n_src;
        bad |= !ok && ids[k] != kInvalid;
        todo |= static_cast<uint32_t>(ok) << k;
      }
      while (todo) {
        V v[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          v[j] = W::zero();
          if (todo) {
            const int k = __ffs(todo) - 1;
            todo &= todo - 1;
            v[j] = W::ldg(f + static_cast<int64_t>(pick(ids, k)) * wm + c);
          }
        }
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) W::orin(acc, v[j]);
      }
    }
    if (perm == nullptr) {
      W::store(out + i * wm + c, acc);
    } else if (fused_ok && W::gains(acc, old)) {
      W::orin(acc, old);
      W::store(out + dst * wm + c, acc);
      changed = true;
    }
  }
  const bool any_changed = __any_sync(0xffffffffu, changed);
  const bool any_bad = __any_sync(0xffffffffu, bad);
  if (lane == 0) {
    if (any_changed) flags[0] = 1;
    if (any_bad) flags[1] = 1;
  }
}

template <int VEC, int IDV>
void launch(unsigned int blocks, cudaStream_t s, const int32_t* nbr, int64_t r, int32_t d,
            const int32_t* f, int64_t n_src, int32_t wm, int32_t* out, int64_t n_out,
            const int64_t* perm, int32_t* flags) {
  frontier_or_kernel<VEC, IDV><<<blocks, kThreads, 0, s>>>(
      nbr, r, d, reinterpret_cast<const uint32_t*>(f), n_src, wm,
      reinterpret_cast<uint32_t*>(out), n_out, perm, flags);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = success).
// All pointers are device pointers (perm may be null); the caller has checked shapes,
// types and that f does not alias out.
extern "C" int frontier_or_launch(const int32_t* nbr, int64_t r, int32_t d,
                                  const int32_t* f, int64_t n_src, int32_t wm,
                                  int32_t* out, int64_t n_out, const int64_t* perm,
                                  int32_t* flags, void* stream) {
  if (r <= 0 || wm <= 0) return 0;
  const bool vec4 = wm % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool idv4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(nbr) % 16 == 0;
  const int64_t total = r * (vec4 ? wm / 4 : wm);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto g = static_cast<unsigned int>(blocks);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec4 && idv4) {
    launch<4, 4>(g, s, nbr, r, d, f, n_src, wm, out, n_out, perm, flags);
  } else if (vec4) {
    launch<4, 1>(g, s, nbr, r, d, f, n_src, wm, out, n_out, perm, flags);
  } else if (idv4) {
    launch<1, 4>(g, s, nbr, r, d, f, n_src, wm, out, n_out, perm, flags);
  } else {
    launch<1, 1>(g, s, nbr, r, d, f, n_src, wm, out, n_out, perm, flags);
  }
  return static_cast<int>(cudaGetLastError());
}
