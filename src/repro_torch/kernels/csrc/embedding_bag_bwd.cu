// K6 embedding_bag, backward: the gradient of the bags' sums by their table.
//
// Replaces no TPU kernel: src/repro/kernels/embedding_bag.py::embedding_bag_pallas has no
// backward, and the JAX package's training differentiates jnp.take with jax.grad.  The
// port's xDeepFM gathers through K6 (embedding_bag.cu), so training needs K6's backward on
// the card: this is it, behind ops.embedding_bag's autograd Function.
//
// Computes, for idx int32[B, bag] and the forward's output gradient dout float32[B, D]:
//     dtable[v, f] = sum over (b, s) with idx[b, s] == v of dout[b, f]
// into a float32[V, D] that the launch function zeroes first.  Every negative id is padding;
// an id >= V is skipped (the forward has refused it already).  A repeated id, within a bag
// or across bags, adds once a slot.  The sums are float32 atomicAdds, so their order, and
// the last bits of a row that several slots hit, change from run to run.
//
// Bound on an H100: it writes the whole table once (the zeroing) and reads idx and dout,
// then adds one value a valid (slot, column): bound by bytes, the table's V D 4 bytes
// (xDeepFM: 1.56 GB for the rows, 156 MB for the linear term's [V, 1] view) against the
// few MB the adds touch.
//
// Design: cudaMemsetAsync zeroes the table; then one thread a (bag, slot, column), a
// grid-stride loop, each reading its id and its dout value (both through the read-only
// path) and adding with atomicAdd, which the L2 performs; neighbouring threads take
// neighbouring columns of one row, so a row's adds share its sectors.  Offsets are int64.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t{1} << 20;

__global__ void __launch_bounds__(kThreads)
    embedding_bag_bwd_kernel(const int32_t* __restrict__ idx, int64_t B, int32_t bag,
                             const float* __restrict__ dout, int32_t D,
                             float* __restrict__ dtable, int64_t V) {
  const int64_t n = B * bag * D;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t slot = i / D;            // b * bag + s
    const int32_t f = static_cast<int32_t>(i - slot * D);
    const int32_t id = __ldg(idx + slot);
    if (id >= 0 && id < V) {
      atomicAdd(dtable + static_cast<int64_t>(id) * D + f, __ldg(dout + (slot / bag) * D + f));
    }
  }
}

}  // namespace

// Zeroes dtable and launches on `stream`; returns a CUDA error code as an int (0 =
// success).  idx, dout and dtable are device pointers (dtable float32[V, D]); the caller has
// checked shapes and types (D >= 1, bag >= 1).
extern "C" int embedding_bag_bwd_launch(const int32_t* idx, int64_t B, int32_t bag,
                                        const float* dout, int32_t D, float* dtable, int64_t V,
                                        void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (V <= 0 || D <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(dtable, 0, static_cast<size_t>(V) * D * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = B * bag * D;
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  embedding_bag_bwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      idx, B, bag, dout, D, dtable, V);
  return static_cast<int>(cudaGetLastError());
}
