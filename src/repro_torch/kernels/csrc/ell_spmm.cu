// K5 ell_spmm: weighted sparse-dense product over a padded neighbor list (ELL).
//
// Replaces the TPU kernel src/repro/kernels/ell_spmm.py::ell_spmm_pallas, which the
// public kernel API (repro.kernels.ops.ell_spmm) reaches: GNN message passing.
//
// Computes, for every row i of nbr int32[n, d] and every feature f < F:
//     out[i, f] = sum over s with nbr[i, s] != -1 of wgt[i, s] * x[nbr[i, s], f]
// in float32, slot by slot in slot order.  Only -1 is padding: any other id outside
// [0, n_src) is skipped and never read through, and the flag word is set; the wrapper
// raises.
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
// or by cp.async (PERF.md, §6).
//
// Narrow rows (F <= 64: GCN's hidden and output widths, 16 and 7, and their transposed
// backward), ell_spmm_narrow_kernel.  A warp a row leaves most lanes idle there: F = 16
// loads 64 bytes a source row, 4 of 32 lanes with 16-byte loads, and a transposed row of
// GCN's training graph holds about 3 valid slots of 17, so a warp had a few 64-byte loads
// in flight.  So a row takes a lane group of G lanes, ceil(F / VEC) rounded up to a power
// of two and at most 16 (4 at F = 16 with 16-byte loads, 8 at F = 7), and a warp 32 / G
// rows.  Each lane reads 32 / G of its row's slots (32 at a time), marks the valid ones
// in a word whose bit s is slot s, and the group ORs its lanes' words by shuffles; the
// group then walks its valid slots in slot order, kGroup at a time, every lane rereading
// a slot's id and weight (a broadcast from L1) and loading its features of the source row
// at once, then adding them in slot order.  A row's sum is thus the same sequence of
// multiply-adds, in the same order, as the warp-a-row kernel's: the two give the same
// bits.  Groups of a warp walk together (the loop runs while any has a slot left), so
// the warp's shuffles stay converged.  Features past G VEC (VEC = 1, F > 16) are walked in
// chunks of 16, as the wide kernel walks chunks of 32 VEC.
//
// The bad-id flag is a word of pinned host memory, mapped into the card's address space
// (as embedding_bag.cu's): the wrapper clears it, launches, synchronises the stream once
// and reads it, one launch and no copy a call.  Offsets are int64 and a grid-stride loop
// covers any n.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalid = -1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // source rows a warp loads before it adds them
constexpr int64_t kMaxBlocks = int64_t{1} << 20;
constexpr int32_t kNarrowF = 64;  // rows this wide or narrower take the narrow-row kernel

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

// G lanes a row (a power of two, at most 16), 32 / G rows a warp
template <int VEC, int G>
__global__ void __launch_bounds__(kThreads)
    ell_spmm_narrow_kernel(const int32_t* __restrict__ nbr, const float* __restrict__ wgt,
                           int64_t n, int32_t d, const float* __restrict__ x, int64_t n_src,
                           int32_t F, float* __restrict__ out, int32_t* __restrict__ flags) {
  using V = typename Vec<VEC>::type;
  constexpr int R = 32 / G;  // rows a warp; also the slots a lane reads of 32
  const int lane = threadIdx.x & 31;
  const int li = lane % G;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps * R;
  bool bad = false;  // this lane saw an id outside [-1, n_src)
  for (int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * R;
       i0 < n; i0 += stride) {  // warp-uniform
    const int64_t i = i0 + lane / G;
    const bool row_ok = i < n;
    const int32_t* ids = nbr + i * d;
    const float* ws = wgt + i * d;
    for (int32_t f0 = 0; f0 < F; f0 += G * VEC) {  // warp-uniform
      const int32_t f = f0 + li * VEC;
      const bool active = row_ok && f < F;
      V acc{};
      for (int32_t s0 = 0; s0 < d; s0 += 32) {  // warp-uniform
        // bit s of todo: slot s0 + s of this group's row is valid; lane li reads the
        // slots s0 + li + G t
        uint32_t todo = 0;
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const int s = li + G * t;
          if (row_ok && s0 + s < d) {
            const int32_t id = __ldg(ids + s0 + s);
            const bool valid = id >= 0 && id < n_src;
            bad |= !valid && id != kInvalid;
            todo |= static_cast<uint32_t>(valid) << s;
          }
        }
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) todo |= __shfl_xor_sync(0xffffffffu, todo, o);
        while (__any_sync(0xffffffffu, todo != 0)) {  // warp-uniform: kGroup slots a group
          const int m = min(__popc(todo), kGroup);
          V v[kGroup];
          float w[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            v[j] = V{};
            w[j] = 0.0f;
            if (j < m) {
              const int s = s0 + __ffs(todo) - 1;
              todo &= todo - 1;
              w[j] = __ldg(ws + s);
              if (active) v[j] = __ldg(reinterpret_cast<const V*>(x + int64_t{__ldg(ids + s)} * F + f));
            }
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

template <int VEC, int G>
void launch_narrow(const int32_t* nbr, const float* wgt, int64_t n, int32_t d, const float* x,
                   int64_t n_src, int32_t F, float* out, int32_t* flags, cudaStream_t s) {
  constexpr int64_t rows = int64_t{kWarps} * (32 / G);  // rows a block
  int64_t blocks = (n + rows - 1) / rows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ell_spmm_narrow_kernel<VEC, G><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      nbr, wgt, n, d, x, n_src, F, out, flags);
}

template <int VEC>
void launch_narrow_g(const int32_t* nbr, const float* wgt, int64_t n, int32_t d,
                     const float* x, int64_t n_src, int32_t F, float* out, int32_t* flags,
                     cudaStream_t s) {
  const int32_t lanes = (F + VEC - 1) / VEC;  // at most 16 lanes; past 16 G chunks
  if (lanes <= 1)
    launch_narrow<VEC, 1>(nbr, wgt, n, d, x, n_src, F, out, flags, s);
  else if (lanes <= 2)
    launch_narrow<VEC, 2>(nbr, wgt, n, d, x, n_src, F, out, flags, s);
  else if (lanes <= 4)
    launch_narrow<VEC, 4>(nbr, wgt, n, d, x, n_src, F, out, flags, s);
  else if (lanes <= 8)
    launch_narrow<VEC, 8>(nbr, wgt, n, d, x, n_src, F, out, flags, s);
  else
    launch_narrow<VEC, 16>(nbr, wgt, n, d, x, n_src, F, out, flags, s);
}

}  // namespace

// Launches on `stream` and returns a CUDA error code as an int (0 = success).  nbr, wgt,
// x and out are device pointers; h_flag is pinned host memory (cudaHostAlloc, as torch's
// pin_memory allocates it), which the kernel sets to 1 if it meets an id outside
// [-1, n_src) and the caller zeroed; it is read after the stream has run.  The caller has
// checked shapes and types.  F <= 64 takes the narrow-row kernel, wider rows a warp a row.
extern "C" int ell_spmm_launch(const int32_t* nbr, const float* wgt, int64_t n, int32_t d,
                               const float* x, int64_t n_src, int32_t F, float* out,
                               int32_t* h_flag, void* stream) {
  if (n <= 0 || F <= 0) return 0;
  int32_t* flags = nullptr;  // h_flag as the card addresses it
  const cudaError_t err =
      cudaHostGetDevicePointer(reinterpret_cast<void**>(&flags), h_flag, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (F <= kNarrowF) {
    if (vec4)
      launch_narrow_g<4>(nbr, wgt, n, d, x, n_src, F, out, flags, s);
    else
      launch_narrow_g<1>(nbr, wgt, n, d, x, n_src, F, out, flags, s);
    return static_cast<int>(cudaGetLastError());
  }
  int64_t blocks = (n + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto grid = static_cast<unsigned int>(blocks);
  if (vec4) {
    ell_spmm_kernel<4><<<grid, kThreads, 0, s>>>(nbr, wgt, n, d, x, n_src, F, out, flags);
  } else {
    ell_spmm_kernel<1><<<grid, kThreads, 0, s>>>(nbr, wgt, n, d, x, n_src, F, out, flags);
  }
  return static_cast<int>(cudaGetLastError());
}
