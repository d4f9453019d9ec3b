// Label-row helpers of K1's two kernels: serve_batch.cu (the batch form) and
// label_intersect.cu (the tier form) include this header, so both compare rows with one
// tested code path.
//
// A group of kGroup lanes answers one query.  Each lane holds VEC consecutive entries of
// the L_out row (VEC = 4: one 16-byte load; VEC = 1 where the widths are not a multiple
// of 4 or a base is not 16-byte aligned), the L_in row's vectors go round the group by
// shuffles, and the verdict is a group vote after each step, so a query stops at the
// first shared value.  The compare is all-pairs: an INVALID inside a row is skipped, not
// taken as its end.  The batch form passes each row's length, cut to its tier, as `la` /
// `lb`; the tier form, which has no lengths, passes the width clamped to each matrix.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalid = -1;
constexpr int kGroup = 4;       // lanes per query

// VEC entries of a row from column `col`, or INVALID where col >= limit.  The caller
// keeps col a multiple of VEC and limit <= the row's width, and for VEC = 4 the
// width a multiple of 4, so a load never leaves the row.
template <int VEC>
__device__ __forceinline__ void load_or_invalid(const int32_t* row, int32_t col,
                                                int32_t limit, int32_t (&x)[VEC]) {
  if (col >= limit) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = kInvalid;
    return;
  }
  if constexpr (VEC == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(row + col));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = __ldg(row + col);
  }
}

// entries at column `col` + k >= len become INVALID
template <int VEC>
__device__ __forceinline__ void cut(int32_t col, int32_t len, int32_t (&x)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (col + k >= len) x[k] = kInvalid;
}

// Does L_out row `ra` cut to la share a valid value with L_in row `rb` cut to lb?
// All kGroup lanes of the query call it with the same la and lb.  x0 and y0 are the
// lane's first vectors of the two rows, loaded before the prefilter, already cut.
template <int VEC>
__device__ bool intersect(const int32_t* ra, int32_t la, const int32_t* rb, int32_t lb,
                          const int32_t (&x0)[VEC], const int32_t (&y0)[VEC], int lane,
                          unsigned gmask) {
  constexpr int kSpan = kGroup * VEC;   // columns a group covers in one step
  int32_t x[VEC];
  for (int32_t ca = 0; ca < la; ca += kSpan) {
    const int32_t xa = ca + lane * VEC;
    if (ca == 0) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) x[k] = x0[k];
    } else {
      load_or_invalid<VEC>(ra, xa, la, x);
      cut<VEC>(xa, la, x);
    }
    for (int32_t cb = 0; cb < lb; cb += kSpan) {
      int32_t y[VEC];
      const int32_t yb = cb + lane * VEC;
      if (cb == 0) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) y[k] = y0[k];
      } else {
        load_or_invalid<VEC>(rb, yb, lb, y);
        cut<VEC>(yb, lb, y);
      }
      bool hit = false;
      // each lane's L_out entries against the group's whole L_in chunk: lane j's
      // vector, broadcast by shuffle; vectors past lb are skipped (uniform in the group)
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (cb + j * VEC >= lb) break;
        int32_t b[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) b[k] = __shfl_sync(gmask, y[k], j, kGroup);
#pragma unroll
        for (int p = 0; p < VEC; ++p) {
          if (x[p] == kInvalid) continue;
#pragma unroll
          for (int k = 0; k < VEC; ++k) hit |= x[p] == b[k];
        }
      }
      if (__any_sync(gmask, hit)) return true;
    }
  }
  return false;
}

}  // namespace
