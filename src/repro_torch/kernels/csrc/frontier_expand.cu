// K2 frontier_expand: one BFS level of a construction wave, pushed from the rows that the
// level reached.
//
// Replaces the TPU kernel src/repro/kernels/frontier_ell.py::frontier_or_pallas on the
// device build's path (src/repro/build/engine_jax.py::_make_wave_step runs it once per
// BFS level through _expand_fn).  The TPU kernel pulls, for EVERY row of a degree-sorted
// ELL slab, the OR of its neighbors' frontier words; a level then costs the whole slab
// and the dense [n, wm] passes around it.  This kernel computes the same level from the
// frontier alone: its cost is the frontier's rows, their edges and their label rows.
//
// Inputs (all device pointers; words are uint32 bit patterns, kept by the port as int32):
//   frontier int32[cap]  a ring of row ids; this level's rows are positions [lo, hi)
//                        (mod cap), distinct.  Rows claimed for the next level are
//                        appended at counts[0] (mod cap): cap >= (hi - lo) + n keeps them
//                        clear of this level's rows.
//   indptr int64[n + 1], indices int32[m]: the CSR the bits are pushed over (a row's
//                        neighbors receive its bits).
//   v, pruned, d_cur, d_next uint32[n, wm]: visited words, prune verdicts, the bits a row
//                        gained in the previous level (read and cleared here) and those
//                        it gains in this one (ORed here).
//   L_tgt int32[>= n, l_max], hop_mask uint32[n_hop, wm]: the verdict of row y is
//                        pruned[y] = OR over h in L_tgt[y] (h != -1) of hop_mask[h].
//   stamps int32[3, n]:  row 0 the id of the level a row was last claimed for, row 1 the
//                        sweep whose verdict it holds, row 2 the sweep whose cone holds it.
//   cone int32[n], counts int64[3]: counts[0] is the ring's write position, counts[1] the
//                        cone's length, counts[2] the bad-id flag.
//
// For each frontier row y (a warp per row):
//   1. if stamps[1][y] != sweep: pruned[y] = its verdict; stamps[1][y] = sweep.  L_tgt and
//      hop_mask do not change within a sweep, so the verdict is computed once, before the
//      row's bits are first pushed;
//   2. bits[k] = d_cur[y][k] & ~pruned[y][k]; d_cur[y][k] = 0;
//   3. for each neighbor x of y and word k with bits[k] != 0:
//          old = atomicOr(&v[x][k], bits[k]); gained = bits[k] & ~old;
//          if gained: atomicOr(&d_next[x][k], gained), and x claims itself for the next
//          level once (atomicExch(&stamps[0][x], level) != level): it is appended to the
//          ring, and to the cone the first time in this sweep (stamps[2][x] != sweep).
// OR is order-free, so v, d_next and pruned are the same in every run; only the order of
// the ring and the cone varies, and the caller reads both as sets.  A frontier id, a
// frontier row's neighbor id or CSR range, or a label entry read for a verdict, outside
// its range is never read through: it is skipped and counts[2] is set (whether or not
// the row pushes a bit); the caller raises on it.
//
// Bound on an H100: a level moves each frontier row's ids, words, label row and the
// hop-mask rows it names, and each edge's neighbor id and words: about 10 rows of ~7 KB
// at citeseer@1.0, nanoseconds at 3.35 TB/s.  So the kernel is bound by its launch and
// by the host read that follows it, not by bytes; its design keeps the level to one
// launch and touches nothing else.
//
// Design.  A warp per frontier row keeps a hub from stalling a block: the warp strides
// over the row's (neighbor, word) pairs, 32 at a time.  The verdict is a warp reduction
// (each lane ORs the hop rows of every 32nd label entry, then __shfl_xor).  The row's
// pushed bits are staged in shared memory (wm words a warp), so d_cur is cleared before
// the pushes and a row that gains bits in this level writes only d_next.  Grid-stride over
// the rows; offsets are int64.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalid = -1;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int64_t kMaxBlocks = int64_t{1} << 16;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  int32_t* frontier;
  int64_t cap, lo, hi;
  const int64_t* indptr;
  const int32_t* indices;
  int64_t n, m;
  uint32_t* v;
  uint32_t* pruned;
  uint32_t* d_cur;
  uint32_t* d_next;
  int32_t wm;
  const int32_t* L_tgt;
  int32_t l_max;
  const uint32_t* hop_mask;
  int64_t n_hop;
  int32_t* stamps;
  int32_t sweep, level;
  int32_t* cone;
  unsigned long long* counts;
};

// x gained a bit: claim it for the next level (once) and, the first time in this sweep,
// for the cone.  Returns false when the cone is full (the caller flags it).
__device__ bool claim(const Args& a, int64_t x) {
  if (atomicExch(a.stamps + x, a.level) == a.level) return true;
  const unsigned long long p = atomicAdd(a.counts, 1ull);
  a.frontier[p % static_cast<unsigned long long>(a.cap)] = static_cast<int32_t>(x);
  if (atomicExch(a.stamps + 2 * a.n + x, a.sweep) == a.sweep) return true;
  const unsigned long long c = atomicAdd(a.counts + 1, 1ull);
  if (c >= static_cast<unsigned long long>(a.n)) return false;
  a.cone[c] = static_cast<int32_t>(x);
  return true;
}

__global__ void frontier_expand_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* bits = smem + warp * a.wm;
  const int64_t rows = a.hi - a.lo;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  bool bad = false;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + warp; r < rows; r += n_warps) {
    // lane 0 reads the row and its stamps; every lane takes the same branches
    int64_t y = 0;
    int32_t fresh = 0;
    if (lane == 0) {
      y = a.frontier[(a.lo + r) % a.cap];
      if (y >= 0 && y < a.n) fresh = a.stamps[a.n + y] != a.sweep;
    }
    y = __shfl_sync(kFull, y, 0);
    fresh = __shfl_sync(kFull, fresh, 0);
    if (y < 0 || y >= a.n) {
      bad = true;
      continue;
    }
    uint32_t* pr = a.pruned + y * a.wm;
    if (fresh) {  // 1. the verdict
      const int32_t* lrow = a.L_tgt + y * a.l_max;
      for (int32_t k = 0; k < a.wm; ++k) {
        uint32_t acc = 0;
        for (int32_t e = lane; e < a.l_max; e += 32) {
          const int64_t h = lrow[e];
          if (h == kInvalid) continue;
          if (h < 0 || h >= a.n_hop) {
            bad = true;
            continue;
          }
          acc |= a.hop_mask[h * a.wm + k];
        }
        for (int s = 16; s > 0; s >>= 1) acc |= __shfl_xor_sync(kFull, acc, s);
        if (lane == 0) pr[k] = acc;
      }
      if (lane == 0) a.stamps[a.n + y] = a.sweep;
      __syncwarp();
    }
    // 2. the bits this row pushes; its d_cur words are cleared
    uint32_t* dc = a.d_cur + y * a.wm;
    for (int32_t k = lane; k < a.wm; k += 32) {
      bits[k] = dc[k] & ~pr[k];
      dc[k] = 0;
    }
    __syncwarp();
    // 3. push over the row's neighbors, a (neighbor, word) pair a lane
    const int64_t e0 = a.indptr[y], e1 = a.indptr[y + 1];
    if (e0 < 0 || e1 > a.m || e1 < e0) {
      bad = true;
    } else {
      const int64_t items = (e1 - e0) * a.wm;
      for (int64_t i = lane; i < items; i += 32) {
        const int64_t s = i / a.wm;
        const int32_t k = static_cast<int32_t>(i - s * a.wm);
        const int64_t x = a.indices[e0 + s];
        if (x < 0 || x >= a.n) {
          bad = true;
          continue;
        }
        const uint32_t b = bits[k];
        if (b == 0) continue;
        const uint32_t gained = b & ~atomicOr(a.v + x * a.wm + k, b);
        if (gained) {
          atomicOr(a.d_next + x * a.wm + k, gained);
          if (!claim(a, x)) bad = true;
        }
      }
    }
    __syncwarp();  // bits is rewritten by the warp's next row
  }
  if (bad) a.counts[2] = 1ull;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = success).  The
// caller has checked shapes, types, 0 <= lo <= hi, cap >= (hi - lo) + n, wm <= 1024 and
// that d_cur and d_next do not alias.
extern "C" int frontier_expand_launch(int32_t* frontier, int64_t cap, int64_t lo, int64_t hi,
                                      const int64_t* indptr, const int32_t* indices,
                                      int64_t n, int64_t m, int32_t* v, int32_t* pruned,
                                      int32_t* d_cur, int32_t* d_next, int32_t wm,
                                      const int32_t* L_tgt, int32_t l_max,
                                      const int32_t* hop_mask, int64_t n_hop, int32_t* stamps,
                                      int32_t sweep, int32_t level, int32_t* cone,
                                      int64_t* counts, void* stream) {
  const int64_t rows = hi - lo;
  if (rows <= 0) return 0;
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  Args a{frontier, cap, lo, hi, indptr, indices, n, m,
         reinterpret_cast<uint32_t*>(v), reinterpret_cast<uint32_t*>(pruned),
         reinterpret_cast<uint32_t*>(d_cur), reinterpret_cast<uint32_t*>(d_next), wm,
         L_tgt, l_max, reinterpret_cast<const uint32_t*>(hop_mask), n_hop, stamps, sweep,
         level, cone, reinterpret_cast<unsigned long long*>(counts)};
  const size_t smem = static_cast<size_t>(kWarps) * wm * sizeof(uint32_t);
  frontier_expand_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
