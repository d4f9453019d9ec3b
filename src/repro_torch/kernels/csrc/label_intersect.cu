// K1 label_intersect: batched hop-label intersection with the row gather fused in.
//
// Replaces the TPU kernel src/repro/kernels/label_intersect.py::label_intersect_pallas
// together with the gather and tier-width truncation around it in
// src/repro/serve/engine.py::_tier_intersect (use_kernel=True): K1's tier form, behind
// ops.tier_intersect and serve_step, which serves the dynamic oracle's pinned epochs
// (LabelEpoch.query_batch).  The serve engine's kernel backend runs K1's batch form,
// serve_batch.cu, which also takes the prefilters and the tier choice.
//
// Computes, for every query i of queries int32[B, 2] = (u, v):
//     out[i] = L_out[u, :wa] and L_in[v, :wb] share a value that is not INVALID (-1)
// with wa = min(width, Lo) and wb = min(width, Li), each side clamped on its own
// (the widest serving tier can be wider than one of the two matrices).  The label
// matrices L_out int32[n, Lo] and L_in int32[n, Li] stay resident on the card; the
// kernel reads only the two rows each query names.  Output is one byte per query,
// written into the storage of a torch.bool tensor.  An id outside [0, n) never reads
// memory: its verdict is false.
//
// Bound on an H100: a query moves 8 + 4*(wa + wb) bytes in and 1 byte out and does at
// most wa*wb int32 compares, so the kernel is bound by bytes.  At a pinned batch
// (B ~ 2,300, width 16 -> wa = 16, wb = 8) one launch moves about 240 KB, well under a
// microsecond at 3.35 TB/s: what a small batch pays is latency, the chain of dependent
// memory round trips each query waits for.  A large batch names a row many times:
// phase 4's residue repeated to B = 2^20 needs 23.8 MB with each row read once, while
// this kernel gathers two rows a query, 110 MB through the L2.
//
// Design.  The TPU kernel gets pre-gathered rows padded to a 256-query block and does an
// all-pairs compare over a (block, La, Lb) tile on the VPU.  A thread a query, reading
// its rows 4 bytes at a time and re-reading the L_in row for each L_out entry, made
// every step of its loop a round trip and filled 18 of 132 SMs at B = 2,293.  Here the
// batch form's scheme answers a query with a group of kGroup = 4 lanes:
//   1. Two dependent round trips.  The ids are one 8-byte load; the first 16-byte
//      vector of each row is issued right after it, before anything is compared.
//   2. 16-byte loads and every SM.  Each lane holds four consecutive entries of the
//      L_out row, so a 16-wide row is one load per lane; the L_in row's vectors go
//      round the group by shuffles and the verdict is a group vote, with early exit at
//      the first shared value.  B = 2,293 makes 9,172 threads, 72 blocks; 4,096 make
//      128.  Rows wider than a group's 16 entries loop.
//   3. Widths or strides not a multiple of 4, or a base that is not 16-byte aligned,
//      take the same loop with one entry a lane (VEC = 1), chosen by the launch.
// The compare (load_or_invalid, cut, intersect) is label_rows.cuh's, the batch form's:
// the tier form passes wa and wb where the batch form passes the row lengths.  It stays
// all-pairs (INVALID entries are skipped, not taken as the end of the row), so the
// kernel agrees with the plain version on any input, sorted or not.  Row offsets are
// computed in int64.
#include <cstdint>
#include <cuda_runtime.h>

#include "label_rows.cuh"

namespace {

constexpr int kThreads = 128;   // 32 queries a block

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    label_intersect_kernel(const int32_t* __restrict__ L_out, const int32_t* __restrict__ L_in,
                           int64_t n, int32_t lo_stride, int32_t li_stride,
                           const int32_t* __restrict__ queries, int64_t B, int32_t wa,
                           int32_t wb, uint8_t* __restrict__ out) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kGroup;
  if (i >= B) return;   // whole groups: kThreads is a multiple of kGroup
  const int lane = threadIdx.x % kGroup;
  const unsigned gmask = 0xFu << ((threadIdx.x & 31) & ~(kGroup - 1));

  // round trip 1: the ids (every lane of the group reads the same 8 bytes; a view
  // that starts 4 bytes into an allocation takes two 4-byte loads)
  int64_t u, v;
  if (reinterpret_cast<uintptr_t>(queries) % 8 == 0) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(queries) + i);
    u = q.x;
    v = q.y;
  } else {
    u = __ldg(queries + 2 * i);
    v = __ldg(queries + 2 * i + 1);
  }
  bool hit = false;
  if (u >= 0 && u < n && v >= 0 && v < n) {
    // round trip 2: the first vector of each row, both issued before either is used
    const int32_t* ra = L_out + u * lo_stride;
    const int32_t* rb = L_in + v * li_stride;
    const int32_t c0 = lane * VEC;
    int32_t x0[VEC], y0[VEC];
    load_or_invalid<VEC>(ra, c0, wa, x0);
    load_or_invalid<VEC>(rb, c0, wb, y0);
    cut<VEC>(c0, wa, x0);
    cut<VEC>(c0, wb, y0);
    hit = intersect<VEC>(ra, wa, rb, wb, x0, y0, lane, gmask);
  }
  if (lane == 0) out[i] = hit ? 1 : 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = success).
// All pointers are device pointers; the caller has checked shapes and types and
// passes wa <= lo_stride and wb <= li_stride.
extern "C" int label_intersect_launch(const int32_t* L_out, const int32_t* L_in,
                                      int64_t n, int32_t lo_stride, int32_t li_stride,
                                      const int32_t* queries, int64_t B,
                                      int32_t wa, int32_t wb, uint8_t* out,
                                      void* stream) {
  if (B <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = lo_stride % 4 == 0 && li_stride % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(L_out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(L_in) % 16 == 0;
  const auto blocks = static_cast<unsigned int>((B * kGroup + kThreads - 1) / kThreads);
  if (vec4) {
    label_intersect_kernel<4><<<blocks, kThreads, 0, s>>>(L_out, L_in, n, lo_stride,
                                                          li_stride, queries, B, wa, wb, out);
  } else {
    label_intersect_kernel<1><<<blocks, kThreads, 0, s>>>(L_out, L_in, n, lo_stride,
                                                          li_stride, queries, B, wa, wb, out);
  }
  return static_cast<int>(cudaGetLastError());
}
