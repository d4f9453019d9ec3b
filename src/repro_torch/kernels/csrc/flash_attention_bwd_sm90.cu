// K4 flash_attention, backward, bfloat16, on Hopper's tensor cores: the gradients dq, dk
// and dv of online-softmax attention with causal, sliding-window and GQA masks, every
// product issued as wgmma.
//
// Replaces no TPU kernel: src/repro/kernels/flash_attention.py::flash_attention_pallas has
// no backward, and the JAX package's training differentiates its XLA attention
// (src/repro/models/transformer.py::_attention_scores) with jax.grad.  The port's models
// attend through K4, so training needs K4's backward on the card: this is it for
// bfloat16, behind ops.flash_attention's autograd Function (float32 stays on the CUDA
// cores, flash_attention_bwd.cu: on the tensor cores it would run as TF32).
//
// Computes, for q [B, Hq, S, D], k [B, Hkv, T, D], v [B, Hkv, T, Dv], the forward's output
// o and its gradient do [B, Hq, S, Dv] (all bfloat16; Hq a multiple of Hkv; 8 <= Dv <= D <=
// 192, Dv <= 128, multiples of 8) and the forward's lse [B, Hq, S] (float32: each row's
// base-2 log-sum-exp of scale log2(e) q k^T over its kept keys, +inf without one; written
// by flash_attention_sm90.cu), with P = exp2(scale log2(e) q k^T - lse) over the keys the
// masks keep (query positions right-aligned to the T keys, qpos = s + T - S; causal keeps
// t <= qpos, a window keeps t > qpos - window):
//     delta = rowsum(do o o),  dv = P^T do,  ds = P o (do v^T - delta),
//     dq = scale ds k,  dk = scale ds^T q,
// with dk and dv summed over the Hq / Hkv q heads of each kv head.  A row that keeps no key
// has P = 0 and no gradient.  Sums are float32; the gradients are written in bfloat16.
//
// Bound on an H100: five products (q k^T recomputed, do v^T, P^T do, dS^T q, dS k),
// 2 pairs (3 D + 2 Dv) Hq B operations (pairs: the (query, key) pairs the masks keep) at
// the 989 TFLOP/s of the bf16 tensor cores; at training shapes it is bound by operations.
//
// Design: three launches from one launch function, the logits computed once.
//   1. delta, a lane group a row (16-byte loads of o and do, 8 or 16 lanes), into float32
//      [B, Hq, S]; the same lanes zero the row of the float32 dq accumulator [B, Hq, S, D].
//   2. The main kernel, a block (one warpgroup) for each (b, kv head, 64-key tile), looping
//      over the group's q heads and the 64-row query tiles the masks let see its keys; key
//      tile 0 first, the heaviest under causal.  Thread 0 loads the block's K and V tiles
//      once and each step's Q and dO tiles through two stages by TMA, on mbarriers, in the
//      forward's swizzled column chunks (sm90_tiles.cuh); the steps' lse and delta come
//      through registers one step ahead into shared memory.  Query tiles no key of the
//      block can see are never loaded; the masks apply only on tiles that straddle an edge
//      or T.  Per step, with keys as the wgmma M:
//        * S^T = K Q^T and dP^T = V dO^T: m64n64k16, both operands K-major in shared memory;
//        * P^T = exp2(scale_log2 S^T - lse) and dS^T = P^T o (dP^T - delta) in registers;
//        * dV += P^T dO and dK += dS^T Q: P^T and dS^T as the register A operand, dO and Q
//          MN-major, one instruction per 64-column chunk; dK and dV stay in registers for
//          the whole block and are written once (dk times scale), with no atomics;
//        * dQ = dS K with queries as M: dS^T is stored to shared memory as bfloat16 (the
//          accumulator's pairs, conflict-free in the 128B swizzle) and read transposed, as
//          an MN-major A, against K MN-major, a 64-column chunk at a time; each chunk's
//          64 x 64 float32 partial is added to the dq accumulator two columns a
//          reduction (red.global.add.v2.f32: half the reductions of one a column took
//          24-30% off the kernel's device time at granite's, deepseek-7b's and MLA's
//          widths on an H100, tools/kernel_ab.py; dq's last bits vary from run to run
//          with the order of the additions).
//      A bfloat16 P^T or dS^T alone (rounded to 2^-8 of each value) would put up to 2^-8 of
//      each term into sums that can be near 0, above the contract's tolerance, so each is
//      split into a bf16 high part and a bf16 low part (the rest) and both are multiplied,
//      as the forward splits P: 8 units of tensor work against the bound's 5.
//   3. dq = bf16(scale dq_acc), 8 values a thread.
// Widths: the smallest of (64, 64), (128, 128) and (192, 128) that covers (D, Dv), the tiles
// zero-filled past D and Dv by TMA.  Shared memory: K, V, two stages of Q and dO, dS^T's
// two parts (16 KB), lse and delta (1 KB): 67.6 KB at (64, 64), 116.8 KB at (128, 128),
// 141.3 KB at (192, 128).  Registers (ptxas): 228, 254 and 255 a thread, the last with
// 304 bytes of spills, so two blocks fit an SM at (64, 64) and one at the others.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90_tiles.cuh"

namespace {

constexpr int kTile = 64;      // a block's keys and a step's query rows: wgmma M and N
constexpr int kThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile == kBoxRows, "a tile is one TMA box of rows");

struct Params {
  const float* lse;    // [B, Hq, S]
  const float* delta;  // [B, Hq, S]
  float* dq_acc;       // [B, Hq, S, D], zeroed by the delta kernel
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int64_t Hq, Hkv, S, T, D, Dv, rep;
  int32_t causal, has_window;
  int64_t window;
  float scale, scale_log2;
};

struct Maps {
  CUtensorMap k[3];     // K's column chunks over [B * Hkv, T, D]
  CUtensorMap v[2];     // V's over [B * Hkv, T, Dv]
  CUtensorMap q[3];     // Q's over [B * Hq, S, D]
  CUtensorMap dout[2];  // dO's over [B * Hq, S, Dv]
};

// ---------------------------------------------------------------- 1. delta

// delta[row] = sum over Dv of do o o, L lanes a row (L >= Dv / 8, one 16-byte unit of o and
// of do a lane); the lanes also zero the row's D floats of dq_acc
template <int L>
__global__ void __launch_bounds__(256)
    attention_bwd_sm90_delta_kernel(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                                    float* delta, float* dq_acc, int64_t rows, int64_t D,
                                    int64_t Dv) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = gid / L;
  const int u = static_cast<int>(gid % L);
  float sum = 0.0f;
  if (row < rows) {
    if (u < Dv / 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + row * Dv + 8 * u);
      const uint4 c = *reinterpret_cast<const uint4*>(dout + row * Dv + 8 * u);
      const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* ch = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(ah[i]), y = __bfloat1622float2(ch[i]);
        sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
      }
    }
    float4* acc = reinterpret_cast<float4*>(dq_acc + row * D);
    for (int64_t i = u; i < D / 4; i += L) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && u == 0) delta[row] = sum;
}

// ---------------------------------------------------------------- 2. dk, dv and dq's parts

// the Q and dO tiles of query rows s0 ... s0 + 63 of q head hq into a stage (Q's, then dO's)
template <int DP, int DV>
__device__ __forceinline__ void load_step(uint8_t* stage, uint32_t bar, const Maps& maps,
                                          int s0, int hq) {
  constexpr uint32_t kQBytes = kTile * DP * 2;
  const uint32_t dst = smem_u32(stage);
  mbar_expect_tx(bar, kQBytes + kTile * DV * 2u);
  load_chunks<DP>(dst, maps.q, bar, s0, hq);
  load_chunks<DV>(dst + kQBytes, maps.dout, bar, s0, hq);
}

// D += A B for k-step ks of a register A (the accumulator's parts hi and lo) against each
// 64-column chunk of a [64 queries, W] tile at addr, MN-major: chunk C's accumulator
// elements from 32 C
template <int W>
__device__ __forceinline__ void rs_chunks(float* d, const uint32_t* hi, const uint32_t* lo,
                                          uint32_t addr, int ks) {
#pragma unroll
  for (int C = 0; C < W / 64; ++C) {
    const uint64_t bd = desc(addr + Chunks<W>::offset(C, kTile) + ks * 16 * 128, 1024, 1);
    wgmma_rs<64>(d + 32 * C, hi, bd);
    wgmma_rs<64>(d + 32 * C, lo, bd);
  }
}

// at[0] += a, at[1] += b: one float32 reduction of a pair (no value returned)
__device__ __forceinline__ void red_add2(float* at, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(at), "f"(a), "f"(b) : "memory");
}

// DP: D padded (64, 128 or 192); DV: Dv padded (DP, or 128 beside 192)
template <int DP, int DV>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
    attention_bwd_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  static_assert(DP % 64 == 0 && DV % 64 == 0, "whole 64-column chunks");
  constexpr uint32_t kKBytes = kTile * DP * 2, kVBytes = kTile * DV * 2;
  constexpr uint32_t kQBytes = kTile * DP * 2;
  constexpr uint32_t kStageBytes = kQBytes + kTile * DV * 2;  // a Q tile and a dO tile
  constexpr uint32_t kDsBytes = kTile * kTile * 2;            // one part of dS^T
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes of the shared address: align the base
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;
  uint8_t* v_s = k_s + kKBytes;
  uint8_t* st_s = v_s + kVBytes;              // stage st: the Q tile, then the dO tile
  uint8_t* ds_s = st_s + 2 * kStageBytes;     // dS^T [keys, queries]: high part, low part
  float* stats = reinterpret_cast<float*>(ds_s + 2 * kDsBytes);  // stage st: lse, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 4 * kTile);  // K and V, stage 0, 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t bh = blockIdx.x;  // b * Hkv + kv head
  const int64_t b = bh / p.Hkv, kvh = bh - b * p.Hkv;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t t1 = min64(t0 + kTile, p.T) - 1;
  // the query rows that see a key of [t0, t1]: causal needs qpos >= t0, a window
  // qpos < t1 + window; the steps are (q head g, query tile) pairs, g slowest
  const int64_t shift = p.T - p.S;
  int64_t s_lo = 0, s_hi = p.S - 1;
  if (p.causal) s_lo = max64(s_lo, t0 - shift);
  if (p.has_window) s_hi = min64(s_hi, t1 + p.window - 1 - shift);
  const int64_t qt0 = s_lo / kTile;
  const int nq = s_lo <= s_hi ? static_cast<int>(s_hi / kTile - qt0 + 1) : 0;
  const int n_steps = nq * static_cast<int>(p.rep);
  auto head_of = [&](int j) { return static_cast<int>(b * p.Hq + kvh * p.rep + j / nq); };
  auto row_of = [&](int j) { return (qt0 + j % nq) * kTile; };
  // this thread's statistic of step j: lse (threads 0-63) or delta (64-127) of a row
  auto stat_of = [&](int j) -> float {
    if (j >= n_steps) return 0.0f;
    const int64_t s = row_of(j) + (tid & 63), at = head_of(j) * p.S + s;
    if (tid < kTile) return s < p.S ? p.lse[at] : INFINITY;
    return s < p.S ? p.delta[at] : 0.0f;
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(smem_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stats[tid] = stat_of(0);
  float next = stat_of(1);
  __syncthreads();
  if (tid == 0 && n_steps > 0) {
    const uint32_t bar = smem_u32(bars);
    mbar_expect_tx(bar, kKBytes + kVBytes);
    load_chunks<DP>(smem_u32(k_s), maps.k, bar, static_cast<int>(t0), static_cast<int>(bh));
    load_chunks<DV>(smem_u32(v_s), maps.v, bar, static_cast<int>(t0), static_cast<int>(bh));
    for (int j = 0; j < 2 && j < n_steps; ++j)
      load_step<DP, DV>(st_s + j * kStageBytes, smem_u32(bars + 1 + j), maps,
                        static_cast<int>(row_of(j)), head_of(j));
  }

  // this thread's accumulator elements: e = 4 i + 2 h + x is row row0 + 8 h (a key; a
  // query in dQ), column 8 i + col0 + x (a query; a column of d in dK, dV and dQ)
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  float dk[DP / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.0f;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s), ds_addr = smem_u32(ds_s);
  if (n_steps > 0) mbar_wait(smem_u32(bars), 0);

  for (int j = 0; j < n_steps; ++j) {
    const int st = j & 1;
    const int64_t s0 = row_of(j);
    const int64_t hq = head_of(j);
    mbar_wait(smem_u32(bars + 1 + st), (j >> 1) & 1);
    const uint32_t q_addr = smem_u32(st_s + st * kStageBytes), o_addr = q_addr + kQBytes;
    const float* lse_s = stats + st * 2 * kTile;
    const float* delta_s = lse_s + kTile;

    // ---- S^T = K Q^T and dP^T = V dO^T, keys as M
    float s[kTile / 2], dp[kTile / 2];
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) s[i] = dp[i] = 0.0f;
    pin<kTile / 2>(s);
    pin<kTile / 2>(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t off = Chunks<DP>::offset(ks / 4, kTile) + (ks % 4) * 32;
      wgmma_ss<kTile>(s, desc(k_addr + off, 1024, 1), desc(q_addr + off, 1024, 1), ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < DV / 16; ++ks) {
      const uint32_t off = Chunks<DV>::offset(ks / 4, kTile) + (ks % 4) * 32;
      wgmma_ss<kTile>(dp, desc(v_addr + off, 1024, 1), desc(o_addr + off, 1024, 1), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin<kTile / 2>(s);
    pin<kTile / 2>(dp);

    // ---- P^T and dS^T (masks only on a tile that straddles an edge or T)
    const bool whole = t0 + kTile <= p.T && (!p.causal || t0 + kTile - 1 <= s0 + shift) &&
                       (!p.has_window || t0 > s0 + kTile - 1 + shift - p.window);
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const float2 lse = *reinterpret_cast<const float2*>(lse_s + 8 * i + col0);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * i + col0);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float l = x ? lse.y : lse.x, d = x ? dl.y : dl.x;
        const int64_t qpos = s0 + 8 * i + col0 + x + shift;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * i + 2 * h + x;
          float pt = exp2f(s[e] * p.scale_log2 - l);  // 0 on a row without a key (+inf)
          if (!whole) {
            const int64_t t = t0 + row0 + 8 * h;
            const bool keep = t < p.T && (!p.causal || t <= qpos) &&
                              (!p.has_window || t > qpos - p.window);
            pt = keep ? pt : 0.0f;
          }
          s[e] = pt;
          dp[e] = pt * (dp[e] - d);
        }
      }
    }
    // as register A operands of k-step ks (queries 16 ks ...): register jj holds the pair
    // e = 8 ks + 2 jj, + 1, split into bf16 high and low parts; dS^T's parts also into
    // shared memory, for dQ
    uint32_t p_hi[kTile / 16][4], p_lo[kTile / 16][4], ds_hi[kTile / 16][4],
        ds_lo[kTile / 16][4];
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int e = 8 * ks + 2 * jj;
        split_bf16x2(s[e], s[e + 1], &p_hi[ks][jj], &p_lo[ks][jj]);
        split_bf16x2(dp[e], dp[e + 1], &ds_hi[ks][jj], &ds_lo[ks][jj]);
        const uint32_t at =
            unit_offset<kTile>(row0 + 8 * (jj & 1), 2 * ks + (jj >> 1), kTile) + col0 * 2;
        *reinterpret_cast<uint32_t*>(ds_s + at) = ds_hi[ks][jj];
        *reinterpret_cast<uint32_t*>(ds_s + kDsBytes + at) = ds_lo[ks][jj];
      }
    // the generic writes of dS^T become visible to wgmma (the async proxy) of every warp
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // ---- dV += P^T dO, dK += dS^T Q
    pin<DP / 2>(dk);
    pin<DV / 2>(dv);
    pin<kTile / 4>(&p_hi[0][0]);
    pin<kTile / 4>(&p_lo[0][0]);
    pin<kTile / 4>(&ds_hi[0][0]);
    pin<kTile / 4>(&ds_lo[0][0]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      rs_chunks<DV>(dv, p_hi[ks], p_lo[ks], o_addr, ks);
      rs_chunks<DP>(dk, ds_hi[ks], ds_lo[ks], q_addr, ks);
    }
    wgmma_commit();
    if constexpr (DP > 64) {  // wide: free the operand registers before dQ's accumulator
      wgmma_wait_all();
      pin<DP / 2>(dk);
      pin<DV / 2>(dv);
      pin<kTile / 4>(&p_hi[0][0]);
      pin<kTile / 4>(&p_lo[0][0]);
      pin<kTile / 4>(&ds_hi[0][0]);
      pin<kTile / 4>(&ds_lo[0][0]);
    }

    // ---- dQ = dS K, queries as M, a 64-column chunk of d at a time, into dq_acc
    float* dq_row = p.dq_acc + (hq * p.S + s0) * p.D;
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      float dq[kTile / 2];
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) dq[i] = 0.0f;
      pin<kTile / 2>(dq);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        // keys 16 ks ...: 16 rows of dS^T's parts and of K's chunk c, 128 bytes a row
        const uint64_t kd = desc(k_addr + Chunks<DP>::offset(c, kTile) + ks * 2048, 1024, 1);
        wgmma_ss_tt64(dq, desc(ds_addr + ks * 2048, 1024, 1), kd, 1);
        wgmma_ss_tt64(dq, desc(ds_addr + kDsBytes + ks * 2048, 1024, 1), kd, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<kTile / 2>(dq);
      if constexpr (DP == 64) {
        pin<DP / 2>(dk);
        pin<DV / 2>(dv);
        pin<kTile / 4>(&p_hi[0][0]);
        pin<kTile / 4>(&p_lo[0][0]);
        pin<kTile / 4>(&ds_hi[0][0]);
        pin<kTile / 4>(&ds_lo[0][0]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = row0 + 8 * h;
        if (s0 + r >= p.S) continue;
#pragma unroll
        for (int i = 0; i < kTile / 8; ++i) {
          const int64_t col = 64 * c + 8 * i + col0;
          if (col < p.D)
            red_add2(dq_row + r * p.D + col, dq[4 * i + 2 * h], dq[4 * i + 2 * h + 1]);
        }
      }
    }

    // the statistics of step j + 1 into their stage (step j - 1 is done with it); then
    // every warp is done with stage st and dS^T: refill the stage with step j + 2
    stats[(st ^ 1) * 2 * kTile + tid] = next;
    __syncthreads();
    if (tid == 0 && j + 2 < n_steps)
      load_step<DP, DV>(st_s + st * kStageBytes, smem_u32(bars + 1 + st), maps,
                        static_cast<int>(row_of(j + 2)), head_of(j + 2));
    next = stat_of(j + 2);
  }

  // ---- dk (times scale) and dv, each key row's pairs of columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t t = t0 + row0 + 8 * h;
    if (t >= p.T) continue;
    __nv_bfloat16* dk_row = p.dk + (bh * p.T + t) * p.D;
    __nv_bfloat16* dv_row = p.dv + (bh * p.T + t) * p.Dv;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
      if (8 * i + col0 < p.D)
        *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * i + col0) = __floats2bfloat162_rn(
            dk[4 * i + 2 * h] * p.scale, dk[4 * i + 2 * h + 1] * p.scale);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      if (8 * i + col0 < p.Dv)
        *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * i + col0) =
            __floats2bfloat162_rn(dv[4 * i + 2 * h], dv[4 * i + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------- 3. dq

// dq = bf16(scale dq_acc), 8 values a thread
__global__ void __launch_bounds__(256)
    attention_bwd_sm90_dq_kernel(const float* acc, __nv_bfloat16* dq, int64_t n8, float scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(acc)[2 * i];
  const float4 c = reinterpret_cast<const float4*>(acc)[2 * i + 1];
  uint4 out;
  out.x = bf16x2_bits(__floats2bfloat162_rn(a.x * scale, a.y * scale));
  out.y = bf16x2_bits(__floats2bfloat162_rn(a.z * scale, a.w * scale));
  out.z = bf16x2_bits(__floats2bfloat162_rn(c.x * scale, c.y * scale));
  out.w = bf16x2_bits(__floats2bfloat162_rn(c.z * scale, c.w * scale));
  reinterpret_cast<uint4*>(dq)[i] = out;
}

int blocks_of(int64_t threads, unsigned int* blocks) {
  const int64_t n = (threads + 255) / 256;
  if (n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<unsigned int>(n);
  return 0;
}

template <int DP, int DV>
int launch_main(const Params& p, const void* q, const void* k, const void* v,
                const void* dout, int64_t B, cudaStream_t stream) {
  Maps maps;
  int rc = chunk_maps<DP>(maps.k, 3, k, B * p.Hkv, p.T, p.T, p.D);
  if (rc == 0) rc = chunk_maps<DV>(maps.v, 2, v, B * p.Hkv, p.T, p.T, p.Dv);
  if (rc == 0) rc = chunk_maps<DP>(maps.q, 3, q, B * p.Hq, p.S, p.S, p.D);
  if (rc == 0) rc = chunk_maps<DV>(maps.dout, 2, dout, B * p.Hq, p.S, p.S, p.Dv);
  if (rc != 0) return rc;
  const size_t smem = 1024 + static_cast<size_t>(kTile) * (DP + DV) * 2 +
                      2 * static_cast<size_t>(kTile) * (DP + DV) * 2 + 2 * kTile * kTile * 2 +
                      4 * kTile * 4 + 3 * 8;
  auto kernel = attention_bwd_sm90_kernel<DP, DV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(B * p.Hkv),
                  static_cast<unsigned int>((p.T + kTile - 1) / kTile));
  kernel<<<grid, kThreads, smem, stream>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the three kernels on `stream` in order and returns 0, a CUDA runtime error
// code, or kTensorMapError plus the CUresult of cuTensorMapEncodeTiled when a tensor map
// cannot be made.  q, k, v, o, dout, dq, dk, dv are device pointers to contiguous bfloat16
// tensors, 16-byte aligned; lse is the forward's float32 [B, Hq, S], delta float32 scratch
// of B * Hq * S words and dq_acc of B * Hq * S * D (16-byte aligned).  The caller has
// checked the shapes (Hq % Hkv == 0, D and Dv multiples of 8, 8 <= Dv <= D <= 192,
// Dv <= 128, S and T at least 1, B * Hkv and the key tiles within a grid).
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, float* dq_acc, void* dq, void* dk, void* dv, int64_t B,
    int64_t Hq, int64_t Hkv, int64_t S, int64_t T, int64_t D, int64_t Dv, int32_t causal,
    int32_t has_window, int64_t window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0) return 0;
  if (D > 192 || D % 8 || Dv % 8 || Dv < 8 || Dv > D || Dv > 128 || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((T + kTile - 1) / kTile > 65535 || B * Hkv > 0x7fffffff || S > 0x7fffffff ||
      T > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t rows = B * Hq * S;
  unsigned int blocks = 0;
  // 1. delta and the zeroed dq_acc
  int rc = blocks_of(rows * (Dv <= 64 ? 8 : 16), &blocks);
  if (rc != 0) return rc;
  const auto* o_ = static_cast<const __nv_bfloat16*>(o);
  const auto* do_ = static_cast<const __nv_bfloat16*>(dout);
  if (Dv <= 64)
    attention_bwd_sm90_delta_kernel<8><<<blocks, 256, 0, s>>>(o_, do_, delta, dq_acc, rows, D,
                                                               Dv);
  else
    attention_bwd_sm90_delta_kernel<16><<<blocks, 256, 0, s>>>(o_, do_, delta, dq_acc, rows, D,
                                                                Dv);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // 2. dk, dv and dq's parts
  const Params p{lse, delta, dq_acc, static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), Hq, Hkv, S, T, D, Dv, Hq / Hkv, causal,
                 has_window, window, scale, scale * kLog2e};
  if (D <= 64)
    rc = launch_main<64, 64>(p, q, k, v, dout, B, s);
  else if (D <= 128)
    rc = launch_main<128, 128>(p, q, k, v, dout, B, s);
  else
    rc = launch_main<192, 128>(p, q, k, v, dout, B, s);
  if (rc != 0) return rc;
  // 3. dq
  rc = blocks_of(rows * D / 8, &blocks);
  if (rc != 0) return rc;
  attention_bwd_sm90_dq_kernel<<<blocks, 256, 0, s>>>(dq_acc, static_cast<__nv_bfloat16*>(dq),
                                                      rows * D / 8, scale);
  return static_cast<int>(cudaGetLastError());
}
