// K1's batch form serve_batch: one whole serving batch of the engine's kernel backend in
// one launch -- the id range check, the four prefilters, the planner's tier choice and
// the label intersection, fused.
//
// Replaces the TPU kernel src/repro/kernels/label_intersect.py::label_intersect_pallas
// together with what src/repro/serve/engine.py::QueryEngine.query_batch runs around it
// for the kernel backend: apply_prefilters (serve/prefilter.py), plan_batch's tier
// assignment (serve/planner.py), each tier's gather, truncation and intersection
// (_tier_intersect) and the scatter back.
//
// Computes, for every query i of queries int32[B, 2] = (u, v) in condensation ids:
//   * an id outside [-n, n) reads no memory: it stores 1 into *flag (the wrapper reads
//     the flag back with the codes, raises IndexError and clears it) and the query's
//     byte is 0.  An id in [-n, 0) counts from the end, as a numpy index does.
//   * out[i] = 2 * fate + verdict, with
//       fate 0      decided by a prefilter: u == v -> true; else out_len[u] == 0,
//                   in_len[v] == 0 or (level given) level[u] >= level[v] -> false;
//       fate 1 + t  intersected in tier t = the number of widths[] below
//                   max(out_len[u], in_len[v]), clamped to the last tier (numpy's
//                   searchsorted(widths, need, side="left")): verdict = L_out[u, :w]
//                   and L_in[v, :w] share a value that is not INVALID (-1), w =
//                   widths[t].
//   * under a memory budget (truncation masks given for both sides, the packed bit
//     masks of serve/budget.py's TruncatedStore: np.packbits order, row i is bit
//     7 - (i & 7) of byte i >> 3), bit 7 of the code (kUncertain) marks a query whose
//     false verdict the cut labels cannot prove: decided false by the emptiness
//     prefilter or by the intersection, with both rows truncated, u != v and (level
//     given) level[u] < level[v].  It is the JAX engine's three-valued epilogue
//     (src/repro/serve/engine.py: QueryEngine.query_batch); fate and verdict keep
//     their bits, and without masks no code has bit 7 set.
// The labels keep INVALID at and after each row's length (the wrapper checks this
// once), so the compare runs to min(len, w) of each row instead of the padded width;
// it still skips any INVALID it meets inside a row, as the all-pairs compare does.
//
// Bound on an H100: a query moves 8 bytes of ids, 16 bytes of lengths and levels and,
// when it reaches intersection, 4 * (la + lb) bytes of labels in, one byte out, and
// does at most la * lb int32 compares, so it is bound by bytes (a budgeted call adds
// one mask bit a side: the byte of each, read with the lengths).  At the serving batch
// (B = 4096, L_out 16 and L_in 8 wide) that is ~0.2 MB, well under a microsecond at
// 3.35 TB/s: a launch is bound by its latency, and the design gains by making one
// launch, one copy in and one copy out a batch where the tier form made one launch,
// one copy in and one blocking read per tier.  What is left to the kernel is latency:
//
//   1. Two dependent memory round trips, not three.  A query's lanes read the ids;
//      then they issue the four scalar gathers (lengths, levels) and the first 16-byte
//      vector of each label row together, before the prefilter decides.  The row
//      vectors are wasted for a prefiltered query (96 bytes at 16/8 wide), but the
//      queries that reach intersection then need no third round trip.
//   2. 16-byte loads and every SM.  A group of kGroup = 4 lanes answers one query,
//      each lane holding four consecutive entries of the L_out row, so a 16-wide row
//      is one load per lane; the L_in row's vectors are shared across the group by
//      shuffles and the verdict is taken by a group vote.  4,096 queries make 16,384
//      threads, 128 blocks, which spreads over 128 of the 132 SMs (a thread per query
//      would make 32 blocks).  Rows wider than a group's 16 entries loop.  Rows whose
//      widths are not a multiple of 4 (or an unaligned base) take the same loop with
//      one entry a lane (VEC = 1).  The loop and its loads (load_or_invalid, cut,
//      intersect) live in label_rows.cuh, which the tier form label_intersect.cu
//      shares.
//   3. Early exit at the first shared value, checked after each step of the loop.
//      The compare stays all-pairs: no sorted merge, so the verdict equals the tier
//      form on any rows, sorted or not.
//   4. Out-of-range ids set the flag word and read nothing (above).
//
// The launch function issues the batch's whole round trip on the stream, so that the
// wrapper makes one foreign call a batch: the ids' copy in from pinned host memory, the
// launch and the copy back of the flag word and the codes, none of which blocks; the
// wrapper then synchronises once.  Row offsets are computed in int64.
#include <cstdint>
#include <cuda_runtime.h>

#include "label_rows.cuh"

namespace {

constexpr int kThreads = 128;   // 32 queries a block
constexpr int kMaxTiers = 16;   // the planner makes at most 3
constexpr uint8_t kUncertain = 0x80;   // 2 * fate + verdict stays below it

struct Tiers {
  int32_t count;
  int32_t width[kMaxTiers];
};

struct Args {
  const int32_t* L_out;
  const int32_t* L_in;
  int64_t n;
  int32_t Lo, Li;
  const int32_t* out_len;
  const int32_t* in_len;
  const int32_t* level;   // nullptr: no level prefilter
  const uint8_t* trunc_out;   // nullptr (both): no budget
  const uint8_t* trunc_in;
  const int32_t* queries;
  int64_t B;
  uint8_t* out;
  int32_t* flag;
  Tiers tiers;
};

template <int VEC>
__global__ void __launch_bounds__(kThreads) serve_batch_kernel(const Args a) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kGroup;
  if (i >= a.B) return;   // whole groups: kThreads is a multiple of kGroup
  const int lane = threadIdx.x % kGroup;
  const unsigned gmask = 0xFu << ((threadIdx.x & 31) & ~(kGroup - 1));

  // round trip 1: the ids (every lane of the group reads the same 8 bytes)
  const int2 q = __ldg(reinterpret_cast<const int2*>(a.queries) + i);
  int64_t u = q.x, v = q.y;
  const int64_t n = a.n;
  if (u < -n || u >= n || v < -n || v >= n) {
    if (lane == 0) {
      *a.flag = 1;
      a.out[i] = 0;
    }
    return;
  }
  if (u < 0) u += n;
  if (v < 0) v += n;

  // round trip 2: the four scalars and the first vector of each row, all issued
  // before any of them is used
  const int32_t* ra = a.L_out + u * a.Lo;
  const int32_t* rb = a.L_in + v * a.Li;
  const int32_t lu = __ldg(a.out_len + u);
  const int32_t lv = __ldg(a.in_len + v);
  int32_t hu = 0, hv = 1;
  if (a.level != nullptr) {
    hu = __ldg(a.level + u);
    hv = __ldg(a.level + v);
  }
  uint8_t tu = 0, tv = 0;
  if (a.trunc_out != nullptr) {
    tu = __ldg(a.trunc_out + (u >> 3));
    tv = __ldg(a.trunc_in + (v >> 3));
  }
  const int32_t c0 = lane * VEC;
  int32_t x0[VEC], y0[VEC];
  load_or_invalid<VEC>(ra, c0, a.Lo, x0);
  load_or_invalid<VEC>(rb, c0, a.Li, y0);

  uint8_t code;
  if (u == v) {
    code = 1;                                  // fate 0, true
  } else if (lu == 0 || lv == 0 || hu >= hv) {
    code = 0;                                  // fate 0, false
  } else {
    const int32_t need = lu > lv ? lu : lv;
    int t = 0;
    int32_t w = a.tiers.width[0];
#pragma unroll
    for (int k = 0; k < kMaxTiers - 1; ++k) {
      if (k + 1 < a.tiers.count && a.tiers.width[k] < need) {
        t = k + 1;
        w = a.tiers.width[k + 1];
      }
    }
    const int32_t la = lu < w ? lu : w;
    const int32_t lb = lv < w ? lv : w;
    cut<VEC>(c0, la, x0);
    cut<VEC>(c0, lb, y0);
    const bool hit = intersect<VEC>(ra, la, rb, lb, x0, y0, lane, gmask);
    code = static_cast<uint8_t>(((t + 1) << 1) | (hit ? 1 : 0));
  }
  // a false verdict is u != v; hu < hv leaves out the level prefilter's, which is a
  // graph fact, exact at any budget
  if (a.trunc_out != nullptr && !(code & 1) && hu < hv &&
      ((tu >> (7 - (u & 7))) & (tv >> (7 - (v & 7))) & 1))
    code |= kUncertain;
  if (lane == 0) a.out[i] = code;
}

}  // namespace

// Byte offset of the codes in the output buffers: the flag word (int32) leads them.
constexpr int64_t kCodesAt = 16;

// On `stream`, without blocking: copies the int32[B, 2] ids from `host_queries` (pinned)
// to `dev_queries`, launches the kernel, and copies the flag word and the codes
// (kCodesAt + B bytes) from `dev_out` back to `host_out` (pinned).  Returns the first
// CUDA error as an int (0 = success).  `widths` is host memory (n_tiers entries,
// ascending); the other pointers without `host_` are device pointers; `level` may be
// null, and `trunc_out` / `trunc_in` (uint8[ceil(n / 8)] each) are both null or both
// given.  The caller has checked shapes, types and the labels' layout, and keeps the
// flag word 0 between calls.
extern "C" int serve_batch_launch(const int32_t* L_out, const int32_t* L_in, int64_t n,
                                  int32_t Lo, int32_t Li, const int32_t* out_len,
                                  const int32_t* in_len, const int32_t* level,
                                  const uint8_t* trunc_out, const uint8_t* trunc_in,
                                  const int32_t* widths, int32_t n_tiers,
                                  const int32_t* host_queries, int32_t* dev_queries, int64_t B,
                                  uint8_t* host_out, uint8_t* dev_out, void* stream) {
  if (B <= 0) return 0;
  if (n_tiers < 1 || n_tiers > kMaxTiers) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyAsync(dev_queries, host_queries, B * 2 * sizeof(int32_t),
                                  cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((trunc_out == nullptr) != (trunc_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{L_out, L_in, n, Lo, Li, out_len, in_len, level, trunc_out, trunc_in, dev_queries, B,
         dev_out + kCodesAt, reinterpret_cast<int32_t*>(dev_out), {}};
  a.tiers.count = n_tiers;
  for (int k = 0; k < kMaxTiers; ++k) a.tiers.width[k] = widths[k < n_tiers ? k : n_tiers - 1];
  const bool vec4 = Lo % 4 == 0 && Li % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(L_out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(L_in) % 16 == 0;
  const int64_t blocks = (B * kGroup + kThreads - 1) / kThreads;
  if (vec4) {
    serve_batch_kernel<4><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(a);
  } else {
    serve_batch_kernel<1><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyAsync(host_out, dev_out, kCodesAt + B,
                                          cudaMemcpyDeviceToHost, s));
}
