// K6 embedding_bag: the sum of each bag's embedding rows.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::embedding_bag_pallas, which
// the public kernel API (repro.kernels.ops.embedding_bag) reaches: the recsys sparse
// lookup.
//
// Computes, for every bag b of idx int32[B, bag] and every column f < D of table
// float32[V, D]:
//     out[b, f] = sum over s with idx[b, s] >= 0 of table[idx[b, s], f]
// in float32, in slot order.  Every negative id is padding.  An id >= V is skipped and
// never read through, and the flag word is set; the wrapper raises.
//
// Bound on an H100: it reads the ids, one table row per valid slot, and writes out, one
// add per gathered value, so it is bound by bytes.  At xDeepFM's serve_bulk batch
// (B = 262,144, bag 8, D = 10, a quarter of the slots padding) that is about 82 MB,
// about 25 us at 3.35 TB/s; the table (39 x 1,000,000 rows, 1.56 GB) does not fit L2,
// and a 40-byte row spans two 32-byte sectors wherever it starts, so the card moves
// about 120 MB (36 us).  What binds is the card's rate of random row reads, not their
// bytes: on an NVIDIA H100 80GB HBM3 at 700 W the same 1.57M rows take 68.6 us at 32
// bytes a row, 71.4 at 64 and 78.2 at 40 (tools/kernel_ab.py --bag-width, PERF.md §6),
// and a 32-byte L2 fetch granularity does not move them.
//
// Design.  The TPU kernel owns a tile of bags and pulls one table row per (slot, bag)
// with a dynamic slice.  On the card a group of G lanes (8, 16 or 32: the fewest that
// cover a row's vectors) owns a bag, so a warp owns 32 / G bags.  The group reads the
// bag's ids once, 8 slots at a time, one id a lane with an evict-first load; then each
// lane takes the 8 ids by shuffle and issues the loads of its column of all 8 rows
// before it adds them in slot order, with no branch a slot (a padding slot or a slot past
// the bag loads nothing and adds 0).  A row is read 8 bytes a lane (float2) when D is even
// and table and out are 8-byte aligned (D = 10: 5 lanes a row), 4 bytes otherwise; rows
// wider than G vectors are taken G vectors at a time.  out is written with streaming
// stores, and a warp sets the bad-id flag with one __any_sync.  A grid-stride loop covers
// any B; offsets are int64.
//
// The bad-id flag is a word of pinned host memory, mapped into the card's address space:
// the kernel writes it directly and the wrapper clears and reads it on the host, so a
// call is one foreign call (one launch) and one synchronisation.  That measured faster
// than clearing a device flag with cudaMemsetAsync and copying it back with
// cudaMemcpyAsync in the same launch function (PERF.md, §6).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;  // slots whose rows a lane loads before it adds them
constexpr int64_t kMaxBlocks = int64_t{1} << 20;

template <int W>
struct Vec;
template <>
struct Vec<1> {
  using type = float;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ void add(float& acc, float v) { acc += v; }
};
template <>
struct Vec<2> {
  using type = float2;
  static __device__ __forceinline__ float2 zero() { return make_float2(0.0f, 0.0f); }
  static __device__ __forceinline__ void add(float2& acc, float2 v) {
    acc.x += v.x;
    acc.y += v.y;
  }
};

// W: floats a load (1 or 2); G: lanes a bag (8, 16 or 32)
template <int W, int G>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const float* __restrict__ table, int64_t V, int32_t D,
                         const int32_t* __restrict__ idx, int64_t B, int32_t bag,
                         float* __restrict__ out, int32_t* __restrict__ flag) {
  using T = typename Vec<W>::type;
  constexpr int kBags = 32 / G;  // bags a warp
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;       // lane in its group
  const int g0 = lane - gl;      // the group's first lane
  const int32_t nv = D / W;      // vectors a row
  const T* rows = reinterpret_cast<const T*>(table);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps * kBags;
  bool bad = false;  // this lane read an id >= V
  for (int64_t b0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kBags;
       b0 < B; b0 += stride) {  // warp-uniform
    const int64_t b = b0 + lane / G;
    const bool live = b < B;
    const int32_t* ids = idx + b * bag;
    for (int32_t v0 = 0; v0 < nv; v0 += G) {  // warp-uniform
      const int32_t vi = v0 + gl;
      const bool col = live && vi < nv;
      T acc = Vec<W>::zero();
      for (int32_t s0 = 0; s0 < bag; s0 += kSlots) {  // warp-uniform
        const int32_t mine =
            live && gl < kSlots && s0 + gl < bag ? __ldcs(ids + s0 + gl) : -1;
        bad |= mine >= V;
        T val[kSlots];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int32_t id = __shfl_sync(0xffffffffu, mine, g0 + j);
          const bool ok = col && id >= 0 && id < V;
          val[j] = ok ? __ldg(rows + static_cast<int64_t>(id) * nv + vi) : Vec<W>::zero();
        }
#pragma unroll
        for (int j = 0; j < kSlots; ++j) Vec<W>::add(acc, val[j]);
      }
      if (col) __stcs(reinterpret_cast<T*>(out + b * D) + vi, acc);
    }
  }
  if (__any_sync(0xffffffffu, bad) && lane == 0) *flag = 1;
}

template <int W>
void launch_w(int32_t nv, const float* table, int64_t V, int32_t D, const int32_t* idx,
              int64_t B, int32_t bag, float* out, int32_t* flag, cudaStream_t s) {
  const int G = nv <= 8 ? 8 : nv <= 16 ? 16 : 32;
  const int64_t warps = (B + 32 / G - 1) / (32 / G);
  int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto grid = static_cast<unsigned int>(blocks);
  if (G == 8) {
    embedding_bag_kernel<W, 8><<<grid, kThreads, 0, s>>>(table, V, D, idx, B, bag, out, flag);
  } else if (G == 16) {
    embedding_bag_kernel<W, 16><<<grid, kThreads, 0, s>>>(table, V, D, idx, B, bag, out, flag);
  } else {
    embedding_bag_kernel<W, 32><<<grid, kThreads, 0, s>>>(table, V, D, idx, B, bag, out, flag);
  }
}

}  // namespace

// Launches on `stream` and returns a CUDA error code as an int (0 = success).  table,
// idx and out are device pointers; h_flag is pinned host memory (cudaHostAlloc, as
// torch's pin_memory allocates it), which the kernel sets to 1 if it reads an id >= V
// and the caller zeroed; it is read after the stream has run.  The caller has checked
// shapes and types (D >= 1, bag >= 1).
extern "C" int embedding_bag_launch(const float* table, int64_t V, int32_t D,
                                    const int32_t* idx, int64_t B, int32_t bag, float* out,
                                    int32_t* h_flag, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  int32_t* flag = nullptr;  // h_flag as the card addresses it
  const cudaError_t err =
      cudaHostGetDevicePointer(reinterpret_cast<void**>(&flag), h_flag, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool w2 = D % 2 == 0 && reinterpret_cast<uintptr_t>(table) % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (w2) {
    launch_w<2>(D / 2, table, V, D, idx, B, bag, out, flag, s);
  } else {
    launch_w<1>(D, table, V, D, idx, B, bag, out, flag, s);
  }
  return static_cast<int>(cudaGetLastError());
}
