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
// never read through, and flags[0] is set; the wrapper raises.
//
// Bound on an H100: it reads the ids, one table row per valid slot, and writes out, one
// add per gathered value, so it is bound by bytes.  At xDeepFM's serve_bulk batch
// (B = 262,144, bag 8, D = 10, a quarter of the slots padding) that is about 82 MB,
// about 25 us at 3.35 TB/s; the table (39 x 1,000,000 rows, 1.56 GB) does not fit L2.
//
// Design.  The TPU kernel owns a tile of bags and pulls one table row per (slot, bag)
// with a dynamic slice.  On the card one thread owns one (bag, column) pair, so the D
// threads of a bag read one table row at consecutive addresses and a warp's reads of one
// slot are as few sectors as the rows allow.  D = 10 gives 40-byte rows, which 16-byte
// vector loads cannot take, so every load is 4 bytes.  The grid covers any B * D with a
// grid-stride loop; offsets are int64.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t{1} << 20;

__global__ void embedding_bag_kernel(const float* __restrict__ table, int64_t V, int32_t D,
                                     const int32_t* __restrict__ idx, int64_t B,
                                     int32_t bag, float* __restrict__ out,
                                     int32_t* __restrict__ flags) {
  const int64_t total = B * D;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t b = t / D;
    const int32_t f = static_cast<int32_t>(t - b * D);
    const int32_t* row = idx + b * bag;
    float acc = 0.0f;
    bool bad = false;
    for (int32_t s = 0; s < bag; ++s) {
      const int64_t id = __ldg(row + s);
      if (id < 0) continue;
      if (id >= V) {
        bad = true;
        continue;
      }
      acc += __ldg(table + id * D + f);
    }
    out[t] = acc;
    if (bad) flags[0] = 1;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = success).
// All pointers are device pointers; the caller has checked shapes and types and
// zeroed flags.
extern "C" int embedding_bag_launch(const float* table, int64_t V, int32_t D,
                                    const int32_t* idx, int64_t B, int32_t bag, float* out,
                                    int32_t* flags, void* stream) {
  const int64_t total = B * D;
  if (total <= 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  embedding_bag_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(table, V, D, idx, B, bag, out,
                                                              flags);
  return static_cast<int>(cudaGetLastError());
}
