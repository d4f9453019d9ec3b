// K5 ell_spmm: weighted sparse-dense product over a padded neighbor list (ELL).
//
// Replaces the TPU kernel src/repro/kernels/ell_spmm.py::ell_spmm_pallas, which the
// public kernel API (repro.kernels.ops.ell_spmm) reaches: GNN message passing.
//
// Computes, for every row i of nbr int32[n, d] and every feature f < F:
//     out[i, f] = sum over s with nbr[i, s] != -1 of wgt[i, s] * x[nbr[i, s], f]
// in float32, slot by slot in slot order.  Only -1 is padding: any other id outside
// [0, n_src) is skipped and never read through, and flags[0] is set; the wrapper raises.
//
// Bound on an H100: it must read the ids and weights, write out, and read each source
// row x[j] at least once, so it is bound by bytes.  At ogb_products (n = n_src =
// 2,449,029, d = 32, F = 100, 61,859,140 valid slots) that is about 2.59 GB, 0.77 ms at
// 3.35 TB/s.  But x (980 MB) does not fit the 50 MB L2 and the ids are uniform, so no
// schedule reuses a source row from L2 and a gather reads 400 bytes a valid slot: with
// the ids, weights and out, 26.35 GB, 7.87 ms at 3.35 TB/s (the gather floor).  A
// 400-byte row spans 13 32-byte sectors wherever it starts, so the card moves 416.
//
// Design.  The TPU kernel owns a tile of destination rows and pulls one source row per
// (slot, row) with a dynamic slice, the scalar core issuing every read.  On the card a
// warp owns one destination row; lane s reads the id and weight of slot s (one
// coalesced, evict-first read per 32 slots), and a ballot of the valid ids gives the
// slots in order, so padding and bad slots cost no read of x and no step of the walk.
// The warp takes the valid slots kGroup at a time: each slot's id and weight are
// broadcast by shuffle and its source row's load is issued at once, then the
// multiply-adds run in slot order.  The lanes read a row at consecutive features, 16
// bytes a lane when F % 4 == 0 and the rows are 16-byte aligned (F = 100: 25 lanes cover
// the row in one load; a 100-wide row leaves 7 of 32 lanes idle under any split into
// 16-byte pieces), 4 bytes a lane otherwise; out is written with streaming stores.
// What bounds it is the card's rate of random 416-byte reads, about 2.7 TB/s on an
// NVIDIA H100 80GB HBM3 at 700.00 W: there, at ogb_products, more rows in flight a warp
// measured slower, whether as kGroup 8 or 16 (more registers, fewer warps) or as a ring
// of rows in shared memory filled ahead by TMA bulk copies (cp.async.bulk on mbarriers)
// or by cp.async (PERF.md, §6).  Offsets are int64 and a grid-stride loop covers any n.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalid = -1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // source rows a warp loads before it adds them
constexpr int64_t kMaxBlocks = int64_t{1} << 20;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using type = float;
  static __device__ __forceinline__ void fma(float& acc, float w, float v) { acc += w * v; }
};
template <>
struct Vec<4> {
  using type = float4;
  static __device__ __forceinline__ void fma(float4& acc, float w, float4 v) {
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    ell_spmm_kernel(const int32_t* __restrict__ nbr, const float* __restrict__ wgt,
                    int64_t n, int32_t d, const float* __restrict__ x, int64_t n_src,
                    int32_t F, float* __restrict__ out, int32_t* __restrict__ flags) {
  using V = typename Vec<VEC>::type;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  bool bad = false;  // this lane saw an id outside [-1, n_src)
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); i < n;
       i += stride) {
    const int32_t* ids = nbr + i * d;
    const float* ws = wgt + i * d;
    for (int32_t f0 = 0; f0 < F; f0 += 32 * VEC) {  // warp-uniform
      const int32_t f = f0 + lane * VEC;
      const bool active = f < F;
      V acc{};
      for (int32_t s0 = 0; s0 < d; s0 += 32) {
        const bool in_row = s0 + lane < d;
        const int32_t mine = in_row ? __ldcs(ids + s0 + lane) : kInvalid;
        const float my_w = in_row ? __ldcs(ws + s0 + lane) : 0.0f;
        const bool valid = mine >= 0 && mine < n_src;
        bad |= !valid && mine != kInvalid;
        uint32_t todo = __ballot_sync(0xffffffffu, valid);
        while (todo) {  // warp-uniform: kGroup slots a round
          const int m = min(__popc(todo), kGroup);
          V v[kGroup];
          float w[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const int src = j < m ? __ffs(todo) - 1 : 0;
            todo &= todo - 1;
            const int64_t id = __shfl_sync(0xffffffffu, mine, src);
            w[j] = __shfl_sync(0xffffffffu, my_w, src);
            v[j] = V{};
            if (j < m && active) v[j] = __ldg(reinterpret_cast<const V*>(x + id * F + f));
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (j < m) Vec<VEC>::fma(acc, w[j], v[j]);
        }
      }
      if (active) __stcs(reinterpret_cast<V*>(out + i * F + f), acc);
    }
  }
  if (__any_sync(0xffffffffu, bad) && lane == 0) flags[0] = 1;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = success).
// All pointers are device pointers; the caller has checked shapes and types and
// zeroed flags.
extern "C" int ell_spmm_launch(const int32_t* nbr, const float* wgt, int64_t n, int32_t d,
                               const float* x, int64_t n_src, int32_t F, float* out,
                               int32_t* flags, void* stream) {
  if (n <= 0 || F <= 0) return 0;
  int64_t blocks = (n + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned int>(blocks);
  if (vec4) {
    ell_spmm_kernel<4><<<grid, kThreads, 0, s>>>(nbr, wgt, n, d, x, n_src, F, out, flags);
  } else {
    ell_spmm_kernel<1><<<grid, kThreads, 0, s>>>(nbr, wgt, n, d, x, n_src, F, out, flags);
  }
  return static_cast<int>(cudaGetLastError());
}
