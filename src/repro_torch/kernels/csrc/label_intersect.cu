// K1 label_intersect: batched hop-label intersection with the row gather fused in.
//
// Replaces the TPU kernel src/repro/kernels/label_intersect.py::label_intersect_pallas
// together with the gather and tier-width truncation around it in
// src/repro/serve/engine.py::_tier_intersect (use_kernel=True).
//
// Computes, for every query i of queries int32[B, 2] = (u, v):
//     out[i] = L_out[u, :wa] and L_in[v, :wb] share a value that is not INVALID (-1)
// with wa = min(width, Lo) and wb = min(width, Li), each side clamped on its own
// (the widest serving tier can be wider than one of the two matrices).  The label
// matrices L_out int32[n, Lo] and L_in int32[n, Li] stay resident on the card; the
// kernel reads only the two rows each query names.  Output is one byte per query,
// written into the storage of a torch.bool tensor.
//
// Bound on an H100: a query moves 8 + 4*(wa + wb) bytes in and 1 byte out and does at
// most wa*wb int32 compares, so the kernel is bound by bytes.  At the serving shape
// (B = 4096, width 16 -> wa = 16, wb = 8) one launch moves about 430 KB, about 0.13 us
// at 3.35 TB/s: far below the launch overhead, so a launch is bound by its latency,
// not by the card.
//
// Design.  The TPU kernel gets pre-gathered rows padded to a 256-query block and does
// an all-pairs compare over a (block, La, Lb) tile on the VPU.  Here one thread
// answers one query: it reads its two ids, compares the rows pairwise and stops at
// the first shared value.  The compare keeps the all-pairs semantics of the TPU
// kernel exactly (INVALID entries are skipped, not taken as the end of the row), so
// the kernel agrees with the plain version on any input, sorted or not.  Row offsets
// are computed in int64.  An id outside [0, n) never reads memory: its verdict is
// false (the engine only sends valid ids; the planner's pad rows use vertex 0).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalid = -1;
constexpr int kThreads = 128;

__global__ void label_intersect_kernel(const int32_t* __restrict__ L_out,
                                       const int32_t* __restrict__ L_in,
                                       int64_t n, int32_t lo_stride, int32_t li_stride,
                                       const int32_t* __restrict__ queries, int64_t B,
                                       int32_t wa, int32_t wb,
                                       uint8_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int64_t u = __ldg(queries + 2 * i);
  const int64_t v = __ldg(queries + 2 * i + 1);
  uint8_t hit = 0;
  if (u >= 0 && u < n && v >= 0 && v < n) {
    const int32_t* a = L_out + u * lo_stride;
    const int32_t* b = L_in + v * li_stride;
    for (int32_t p = 0; p < wa && !hit; ++p) {
      const int32_t x = __ldg(a + p);
      if (x == kInvalid) continue;
      for (int32_t q = 0; q < wb; ++q) {
        if (__ldg(b + q) == x) {
          hit = 1;
          break;
        }
      }
    }
  }
  out[i] = hit;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = success).
// All pointers are device pointers; the caller has checked shapes and types.
extern "C" int label_intersect_launch(const int32_t* L_out, const int32_t* L_in,
                                      int64_t n, int32_t lo_stride, int32_t li_stride,
                                      const int32_t* queries, int64_t B,
                                      int32_t wa, int32_t wb, uint8_t* out,
                                      void* stream) {
  if (B <= 0) return 0;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  label_intersect_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      L_out, L_in, n, lo_stride, li_stride, queries, B, wa, wb, out);
  return static_cast<int>(cudaGetLastError());
}
