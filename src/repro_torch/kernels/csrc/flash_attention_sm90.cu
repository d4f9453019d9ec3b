// K4 flash_attention, bfloat16, on Hopper's tensor cores: online-softmax attention with
// causal, sliding-window and GQA masks, both products issued as wgmma.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_pallas
// for bfloat16 inputs, with the semantics of its wrapper repro.kernels.ops.flash_attention
// (float32 inputs stay on the CUDA-core kernel in flash_attention.cu: on the tensor cores
// float32 would run as TF32).
//
// Computes, for q [B, Hq, S, D], k [B, Hkv, T, D] and v [B, Hkv, T, Dv] in bfloat16 (Hq a
// multiple of Hkv, D and Dv multiples of 8, 8 <= Dv <= D <= 192, Dv <= 128: MLA's prefill
// is D = 192, Dv = 128), every query row (b, h, s) against kv head h / (Hq / Hkv):
//     out[b, h, s] = sum_t softmax_t(scale * q[b, h, s] . k[b, kvh, t]) v[b, kvh, t]
// over the keys the masks keep.  Only the first L = kv_len <= T keys of a head exist (T is
// the heads' stride: a decode step passes its preallocated cache and the filled length);
// keys t >= L are never read, the tensor maps ending at L.  Query positions are
// right-aligned to them, qpos = s + L - S; causal keeps t <= qpos, a window keeps
// t > qpos - window (also without causal).  A row that keeps no key gives 0.  Logits, the
// softmax statistics and the accumulator are float32; the output is bfloat16.  Given an
// lse buffer (training: the backward in flash_attention_bwd_sm90.cu reads it), the kernel
// also writes each row's base-2 log-sum-exp of scale * log2(e) * q . k, m + log2(l) over
// the kept keys and +inf for a row that keeps none; serving passes none.
//
// Bound on an H100: prefill by operations, 2 (D + Dv) Hq B (visible pairs) at the 989
// TFLOP/s of the bf16 tensor cores; decode (S = 1) by bytes, K and V read once at 3.35 TB/s.
//
// Design.  A block is one warpgroup (128 threads) and owns a 64-row tile of the rep * S
// query rows of one (batch, kv head), packed position-major (row = s * rep + q head in
// the group), so one K/V tile serves every q head that shares it and decode is one partly
// filled tile a (batch, kv head).  The block stages its Q tile once in shared memory and
// walks 64-key tiles of K and V, which thread 0 loads by TMA through 3-D tensor maps over
// [B * Hkv, L, D] and [B * Hkv, L, Dv] (keys past L and columns past D or Dv zero-fill
// inside the head) into two
// buffers, each completing on an mbarrier: one tile loads while the block computes on the
// other, and the shared memory a deeper ring would take goes to more blocks an SM, which
// is what keeps decode's bytes in flight.  Key tiles that no row of the block can see
// (past the causal end, before the window) are never loaded; the masks are applied only
// on tiles that straddle an edge or L.
//   * S = Q K^T: wgmma m64n64k16, Q and K both K-major in shared memory.
//   * Online softmax in registers, in base 2 (scale * log2 e folded into the logits), each
//     row's max and sum kept by the four threads (a quad) that hold it.
//   * O += P V: wgmma m64nNk16 with P as the register A operand and V MN-major ([T, Dv]
//     row-major, transposed B), one instruction per column chunk of V (below).  bf16 P alone
//     (rounded to 2^-8 of each value) would put an error of up to 2^-8 of max |v| into
//     an output, above the contract's tolerance for outputs near 0, so P is split into a
//     bf16 high part and a bf16 low part (P - high) and both are multiplied: the error
//     falls to 2^-16, for 1.5x the tensor work of a single bf16 P.
//   * Epilogue: divide by the row sum (0 -> output 0), round to bf16 in shared memory and
//     store each row's Dv values 16 bytes at a time; the lse of each row from the thread
//     of its quad that holds column 0.
// Layout (sm90_tiles.cuh).  A tile's D columns, padded to DP, lie in column chunks of 64
// columns and a last one of 64, 32 or 16; each chunk holds the tile's rows at 128, 64 or 32
// bytes a row with the matching TMA and wgmma swizzle (128B, 64B or 32B), so a TMA box row
// is a whole chunk row; the unswizzled layout would need boxes 16 bytes wide, each row a
// copy request of its own, and on an H100 held the copies to about 1.9 TB/s.  V's Dv
// columns, padded to DV, lie in chunks the same way.  The pairs (DP, DV) built: (16, 16),
// (32, 32), (64, 64), (80, 80), (96, 96), (128, 128) for D <= 128 (a Dv < D zero-fills
// V's columns past Dv), and (192, 128) for D > 128: MLA's 192-wide q and k in three chunks
// and its 128-wide v in two.  There a block holds 1 KB + 24 KB of Q + two stages of 24 KB
// of K and 16 KB of V, 107.5 KB, so two blocks fit an SM where D = 128 (81 KB) fits two as
// well and D <= 80 four.  The heaviest row tiles (the latest positions under causal) are
// scheduled first.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90_tiles.cuh"

namespace {

constexpr int kRows = 64;     // query rows a block: one warpgroup's wgmma M
constexpr int kKeys = 64;     // keys a tile: S's wgmma N
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kRows == kBoxRows && kKeys == kBoxRows, "a tile is one TMA box of rows");

struct Params {
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  float* lse;    // null, or [B, Hq, S]: each row's base-2 log-sum-exp (+inf without a key)
  int64_t Hq, Hkv, S, T, D, Dv;
  int64_t L;     // kv_len: the keys that exist, the first L of each head's T rows
  int64_t rep;   // Hq / Hkv
  int64_t rows;  // rep * S query rows per (batch, kv head)
  int64_t row_tiles;
  int32_t causal, has_window;
  int64_t window;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

struct Maps {
  CUtensorMap k[3];  // K's column chunks (a chunk past K's last maps chunk 0 again)
  CUtensorMap v[2];  // V's
};

// the K and V tiles of keys key0 ... key0 + 63 into a stage (K's tile, then V's): one TMA
// box a column chunk and tensor, {chunk width, 64 keys, 1 head} at column 64 c
template <int DP, int DV>
__device__ __forceinline__ void load_tile(uint8_t* stage, uint32_t bar, const Maps& maps,
                                          int key0, int head) {
  constexpr uint32_t kKBytes = kKeys * DP * 2;
  const uint32_t dst = smem_u32(stage);
  mbar_expect_tx(bar, kKBytes + kKeys * DV * 2u);
  load_chunks<DP>(dst, maps.k, bar, key0, head);
  load_chunks<DV>(dst + kKBytes, maps.v, bar, key0, head);
}

// O += P V for key step ks, V's column chunk C and the chunks after it: the chunk's key
// rows 2 w bytes apart, its accumulator elements from 32 C
template <int DV, int C>
__device__ __forceinline__ void pv_chunks(float* o, const uint32_t* p_hi, const uint32_t* p_lo,
                                          uint32_t v_addr, int ks) {
  if constexpr (C < Chunks<DV>::n) {
    constexpr int w = Chunks<DV>::width(C);
    const uint64_t vd = desc(v_addr + Chunks<DV>::offset(C, kKeys) + ks * 16 * w * 2, 16 * w,
                             swizzle_layout(w));
    wgmma_rs<w>(o + 32 * C, p_hi, vd);
    wgmma_rs<w>(o + 32 * C, p_lo, vd);
    pv_chunks<DV, C + 1>(o, p_hi, p_lo, v_addr, ks);
  }
}

// DP: D padded (16, 32, 64, 80, 96, 128 or 192); DV: Dv padded (DP, or 128 beside 192);
// STAGES: K/V tiles in the ring.  Up to D = 80 the registers are held to 128 a thread, so
// that four blocks fit on an SM
template <int DP, int DV, int STAGES>
__global__ void __launch_bounds__(kThreads, DP <= 80 ? 4 : 1)
    flash_attention_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  constexpr int kUnits = DP / 8;                   // 16-byte units a row
  constexpr uint32_t kQBytes = kRows * DP * 2;
  constexpr uint32_t kKBytes = kKeys * DP * 2;     // one K tile
  constexpr uint32_t kStageBytes = kKBytes + kKeys * DV * 2;  // a K tile and a V tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes of the shared address: align the base
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;              // the Q tile; the output tile at the end
  uint8_t* kv_s = smem + kQBytes;   // stage st: the K tile, then the V tile
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + STAGES * kStageBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t b = blockIdx.z, kvh = blockIdx.y;
  const int64_t r0 = (p.row_tiles - 1 - blockIdx.x) * kRows;  // heaviest tiles first
  const int64_t nr = min64(kRows, p.rows - r0);
  const int units = static_cast<int>(p.D / 8), v_units = static_cast<int>(p.Dv / 8);
  const int head = static_cast<int>(b * p.Hkv + kvh);

  // the keys some row of the tile can see, [k_begin, k_end), in whole key tiles
  const int64_t shift = p.L - p.S;
  const int64_t qpos_lo = r0 / p.rep + shift, qpos_hi = (r0 + nr - 1) / p.rep + shift;
  const int64_t k_end = p.causal ? min64(p.L, qpos_hi + 1) : p.L;
  const int64_t k_begin = p.has_window ? max64(0, qpos_lo - p.window + 1) : 0;
  const int64_t kt0 = k_begin / kKeys;
  const int n_tiles =
      k_end > k_begin ? static_cast<int>((k_end + kKeys - 1) / kKeys - kt0) : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query tile, 16 bytes a thread (rows past the block's and columns past D are 0)
  for (int e = tid; e < kRows * kUnits; e += kThreads) {
    const int u = e % kUnits, r = e / kUnits;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nr && u < units) {
      const int64_t R = r0 + r, s = R / p.rep, g = R - s * p.rep;
      val = *reinterpret_cast<const uint4*>(p.q + ((b * p.Hq + kvh * p.rep + g) * p.S + s) * p.D +
                                            8 * u);
    }
    *reinterpret_cast<uint4*>(q_s + unit_offset<DP>(r, u, kRows)) = val;
  }
  // the generic writes above become visible to wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < STAGES && j < n_tiles; ++j)
      load_tile<DP, DV>(kv_s + j * kStageBytes, smem_u32(bars + j), maps,
                        static_cast<int>((kt0 + j) * kKeys), head);

  // this thread's accumulator elements: e = 4 i + 2 h + x is row row0 + 8 h, column
  // 8 i + col0 + x (the wgmma accumulator layout)
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  int64_t qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = (r0 + row0 + 8 * h) / p.rep + shift;
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const uint32_t q_addr = smem_u32(q_s);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    mbar_wait(smem_u32(bars + st), (j / STAGES) & 1);
    const uint32_t k_addr = smem_u32(kv_s + st * kStageBytes), v_addr = k_addr + kKBytes;

    // ---- S = Q K^T
    float s[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.0f;
    pin<kKeys / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      // k-step ks: columns 16 ks ... in chunk c, 32 bytes a step along its rows
      const int c = ks / 4, w = Chunks<DP>::width(c);
      const uint32_t off = (16 * ks - 64 * c) * 2;
      wgmma_ss<kKeys>(s,
                      desc(q_addr + Chunks<DP>::offset(c, kRows) + off, 16 * w, swizzle_layout(w)),
                      desc(k_addr + Chunks<DP>::offset(c, kKeys) + off, 16 * w, swizzle_layout(w)),
                      ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin<kKeys / 2>(s);

    // ---- masks (only on a tile that straddles an edge or L) and the online softmax
    const int64_t key0 = (kt0 + j) * kKeys;
    const bool whole = key0 + kKeys <= p.L && (!p.causal || key0 + kKeys - 1 <= qpos_lo) &&
                       (!p.has_window || key0 > qpos_hi - p.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float v = s[4 * i + 2 * h + x] * p.scale_log2;
          if (!whole) {
            const int64_t t = key0 + 8 * i + col0 + x;
            const bool keep = t < p.L && (!p.causal || t <= qpos[h]) &&
                              (!p.has_window || t > qpos[h] - p.window);
            v = keep ? v : -INFINITY;
          }
          s[4 * i + 2 * h + x] = v;
          mx[h] = fmaxf(mx[h], v);
        }
    float base[2], alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      base[h] = mx[h] == -INFINITY ? 0.0f : mx[h];  // a row with no key yet: p = 0
      alpha[h] = exp2f(m[h] - base[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float pv = exp2f(s[4 * i + 2 * h + x] - base[h]);
          s[4 * i + 2 * h + x] = pv;
          sum[h] += pv;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * i + 2 * h] *= alpha[h];
        o[4 * i + 2 * h + 1] *= alpha[h];
      }
    // P as the A operand of k-step ks (keys 16 ks ...): register jj holds the pair
    // s[8 ks + 2 jj], s[8 ks + 2 jj + 1], split into a bf16 high and low part
    uint32_t p_hi[kKeys / 16][4], p_lo[kKeys / 16][4];
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        split_bf16x2(s[8 * ks + 2 * jj], s[8 * ks + 2 * jj + 1], &p_hi[ks][jj], &p_lo[ks][jj]);

    // ---- O += P V, V MN-major: one instruction per column chunk of V (columns 64 c ...,
    // accumulator elements from 32 c)
    pin<DV / 2>(o);
    pin<kKeys / 4>(&p_hi[0][0]);
    pin<kKeys / 4>(&p_lo[0][0]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) pv_chunks<DV, 0>(o, p_hi[ks], p_lo[ks], v_addr, ks);
    wgmma_commit();
    wgmma_wait_all();
    pin<DV / 2>(o);
    __syncthreads();  // every warp is done with stage st: refill it
    if (tid == 0 && j + STAGES < n_tiles)
      load_tile<DP, DV>(kv_s + st * kStageBytes, smem_u32(bars + st), maps,
                        static_cast<int>((kt0 + j + STAGES) * kKeys), head);
  }

  // ---- epilogue: o / l in bf16 into the Q area (laid out as a DV-wide tile, which fits:
  // DV <= DP), then 16 bytes a thread to out
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] > 0.0f ? 1.0f / l[h] : 0.0f;
  }
  // training keeps each row's base-2 log-sum-exp for the backward: exp2(s - lse) is then
  // P, and 0 on a row with no key
  if (p.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + 8 * h < nr) {
        const int64_t R = r0 + row0 + 8 * h, s = R / p.rep, g = R - s * p.rep;
        p.lse[(b * p.Hq + kvh * p.rep + g) * p.S + s] =
            l[h] > 0.0f ? m[h] + log2f(l[h]) : INFINITY;
      }
  }
  __syncthreads();  // no wgmma reads the Q tile any more
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(q_s + unit_offset<DV>(row0 + 8 * h, i, kRows) +
                                         col0 * 2) =
          __floats2bfloat162_rn(o[4 * i + 2 * h] * inv[h], o[4 * i + 2 * h + 1] * inv[h]);
  __syncthreads();
  for (int e = tid; e < kRows * v_units; e += kThreads) {
    const int u = e % v_units, r = e / v_units;
    if (r < nr) {
      const int64_t R = r0 + r, s = R / p.rep, g = R - s * p.rep;
      *reinterpret_cast<uint4*>(p.out + ((b * p.Hq + kvh * p.rep + g) * p.S + s) * p.Dv +
                                8 * u) =
          *reinterpret_cast<const uint4*>(q_s + unit_offset<DV>(r, u, kRows));
    }
  }
}

template <int DP, int DV>
int launch(const Params& p, const void* k, const void* v, int64_t B, cudaStream_t stream) {
  // two stages: one tile loads while the other is used; the shared memory a deeper ring
  // would take fits a fourth block on an SM, which keeps more bytes in flight and more
  // warps to hide latency
  constexpr int STAGES = 2;
  Maps maps;
  int rc = chunk_maps<DP>(maps.k, 3, k, B * p.Hkv, p.T, p.L, p.D);
  if (rc == 0) rc = chunk_maps<DV>(maps.v, 2, v, B * p.Hkv, p.T, p.L, p.Dv);
  if (rc != 0) return rc;
  const size_t smem = 1024 + static_cast<size_t>(kRows) * DP * 2 +
                      STAGES * static_cast<size_t>(kKeys) * (DP + DV) * 2 + STAGES * 8;
  auto kernel = flash_attention_sm90_kernel<DP, DV, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(p.row_tiles), static_cast<unsigned int>(p.Hkv),
                  static_cast<unsigned int>(B));
  kernel<<<grid, kThreads, smem, stream>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns 0, a CUDA runtime error code, or kTensorMapError plus
// the CUresult of cuTensorMapEncodeTiled when a tensor map cannot be made.  All pointers
// are device pointers to contiguous bfloat16 tensors, 16-byte aligned, but lse: null, or
// float32 [B, Hq, S] (each row's base-2 log-sum-exp, for the backward); the caller has
// checked the shapes (Hq % Hkv == 0, D and Dv multiples of 8, 8 <= Dv <= D <= 192,
// Dv <= 128, B and Hkv at most 65,535, S and T at least 1, 1 <= kv_len <= T).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                           void* out, float* lse, int64_t B, int64_t Hq,
                                           int64_t Hkv, int64_t S, int64_t T, int64_t kv_len,
                                           int64_t D, int64_t Dv, int32_t causal,
                                           int32_t has_window, int64_t window, float scale,
                                           void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (kv_len < 1 || kv_len > T || Dv < 8 || Dv > D || Dv > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = (Hq / Hkv) * S;
  const int64_t row_tiles = (rows + kRows - 1) / kRows;
  if (row_tiles > 0x7fffffff || T > 0x7fffffff || B * Hkv > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Params p{static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), lse,
                 Hq, Hkv, S, T, D, Dv, kv_len, Hq / Hkv, rows, row_tiles, causal, has_window,
                 window, scale * kLog2e};
  const auto s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16, 16>(p, k, v, B, s);
  if (D <= 32) return launch<32, 32>(p, k, v, B, s);
  if (D <= 64) return launch<64, 64>(p, k, v, B, s);
  if (D <= 80) return launch<80, 80>(p, k, v, B, s);
  if (D <= 96) return launch<96, 96>(p, k, v, B, s);
  if (D <= 128) return launch<128, 128>(p, k, v, B, s);
  if (D <= 192) return launch<192, 128>(p, k, v, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
