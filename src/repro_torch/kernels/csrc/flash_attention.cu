// K4 flash_attention, float32: online-softmax attention with causal, sliding-window and GQA
// masks on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_pallas
// for float32 inputs, with the semantics of its wrapper repro.kernels.ops.flash_attention
// (the public kernel API).  bfloat16 inputs go to flash_attention_sm90.cu, on the tensor
// cores; float32 stays here because the tensor cores would run it as TF32, which cannot
// meet the float32 contract's 2e-5.
//
// Computes, for q [B, Hq, S, D], k [B, Hkv, T, D] and v [B, Hkv, T, Dv] in float32 (Hq a
// multiple of Hkv; D and Dv multiples of 8, 8 <= Dv <= D <= 192 and Dv <= 128: MLA's
// prefill is D = 192, Dv = 128), every query row (b, h, s) against kv head h / (Hq / Hkv):
//     out[b, h, s] = sum_t softmax_t(scale * q[b, h, s] . k[b, kvh, t]) v[b, kvh, t]
// over the keys t the masks keep.  Only the first L = kv_len <= T keys of a head exist
// (T is the heads' stride: a decode step passes its preallocated cache and the filled
// length); keys t >= L are never read.  Query positions are right-aligned to them,
// qpos = s + L - S (one kernel for training, chunked prefill and decode); causal keeps
// t <= qpos, a window keeps t > qpos - window (from below only, also without causal).  A
// row that keeps no key gives 0, as the TPU kernel's division by 1 when the sum is 0
// does.  Logits, the softmax and the output are accumulated in float32.  Given an lse
// buffer, each row's base-2 log-sum-exp of scale log2(e) q k^T over its kept keys goes
// there (+inf for a row with none): a decode over a cache split along its sequence
// merges the ranks' rows by it.
//
// Bound on an H100: 2 S T (D + Dv) Hq B operations (two products), halved for causal, against
// the 67 TFLOP/s of float32 outside the tensor cores, or the bytes of q, k, v and out:
// prefill is bound by operations, decode (S = 1) by the bytes of k and v.
//
// Design.  The TPU kernel runs a sequential grid (head, query block, key block) with the
// running max, sum and accumulator in VMEM scratch, carried from one key block to the
// next.  On the card the blocks run in parallel with nothing carried between them, and
// a block owns query rows of one kv head: the rows of the Hq / Hkv q heads that share it,
// packed position-major (row r is position r / rep of q head kvh * rep + r % rep), so one
// K/V tile serves all of them.  Only the kv head index is computed for GQA: k and v are
// not copied per q head.  Key tiles that no row of a block can see (past the causal
// end, before the window) are never loaded.  Two designs, chosen by the rows a (batch,
// kv head) has:
//
// Tiled (rows >= 64: prefill), flash_attention_tiled_kernel, tiled as an SGEMM on the
// CUDA cores is.  A block of 128 threads owns 64 packed rows and walks 64-key tiles;
// the whole block shares each K/V tile, so a value loaded from L2 serves 64 rows.  K and
// V tiles come in by cp.async (16 bytes a lane, rows past kv_len zero-filled) into two
// shared-memory stages, tile j + 1 loading while tile j computes.  Thread (g, c), g =
// tid / 16 and c = tid % 16, owns rows 8g .. 8g + 7: it computes their logits against
// keys c, c + 16, c + 32, c + 48 (a register micro-tile of 8 x 4 from 16-byte loads of
// q rows and K rows, 128 FMAs for 12 loads; K rows padded by 16 bytes so the lanes'
// loads do not collide), then their output columns 4c .. 4c + 3 (and 64 + 4c .. for D
// > 64) from P, written once to shared memory transposed, and V: 32 or 64 FMAs for 3 or
// 4 loads a key.  The template takes the widths DK and DV that shared memory holds; the
// rows in device memory are D and Dv wide, and the columns past them zero-fill.  Where
// they are the same (EXACT), D and Dv are compile-time constants too, so no load and no
// output column carries a runtime bound.  The running max is reduced once a tile over the 16 lanes that share a
// row, by shuffles; each lane keeps its own partial sum, reduced once at the end.
// Masks apply only on tiles that straddle the causal edge, the window edge or kv_len.  Row
// tiles are launched from the last, so under a causal mask the longest run first.
// (DK, DV) are template parameters, so the loops over them unroll whole: (D, D), exact,
// for each multiple of 8 from 8 to 128, and (192, 128) for every other pair (MLA's; a
// Dv < D; D > 128), which zero-fills past D and Dv.  Shared memory: q, two stages of K and V (64 x (DK + 4) and 64 x (DV + 4)
// floats each) and P (64 x 68), 104,448 bytes at D = 64 (two blocks an SM), 186,368 at
// D = 128.  At (192, 128) that would be 235,520 bytes, past the 232,448 a block may have,
// so there P takes the stage of the K tile it was computed from (the block syncs once more,
// after the logits, before P overwrites it): 218,112 bytes, one block an SM.  At granite-3-2b prefill it takes 1.85-1.90 ms on an NVIDIA H100 80GB HBM3 at
// 700 W, 54-55% of its bound; three blocks an SM (P in K's stage, one V stage) measured
// no faster, so what is left is the instruction mix: about 84% FFMA, the rest mostly
// shared-memory loads (PERF.md §6).
//
// Short rows (rows < 64: decode, S = 1 with rep rows, and chunked prefill of a few
// positions): flash_attention_split_kernel, then flash_attention_merge_kernel.  A decode has
// a few rows a kv head, so a block a (batch, kv head) would leave most of the card idle and
// stream each head's keys through one SM (danube's decode over a 4,096-key block: 8 blocks
// on 132 SMs).  Instead the keys some row of a block can see are cut into `splits` pieces of
// whole 32-key chunks (flash-decoding), a block a (row tile, piece, kv head, batch):
// kernels/ops.py's attention_split_plan picks splits so that the grid fills the SMs about
// twice, and 1 where the row tiles of B x Hkv heads already give each SM a block.  A block
// owns R = 1, 2, 4, 8 or 16 rows (the least power of two >= rows, at most 16) and walks its
// piece's chunks through three cp.async stages of K and V (16 bytes a copy, keys past kv_len
// zero-filled), two chunks in flight while one computes.  Its four warps spread a chunk so
// that no lane waits on a row that is not there: for R >= 4 warp w owns rows w, w + 4, ...
// and lane j key j (its logits from 16-byte loads of its K row, rows padded by 16 bytes so
// a quarter-warp's loads do not collide); for R < 4 the 4 / R warps of a row take 8 R keys
// of a chunk each, 4 / R lanes a key, each lane a slice of D, summed by shuffles (a rep-1
// decode: four warps on its one row, 8 keys each, 4 lanes a key).  Each warp keeps a running
// max, sum and accumulator a row (lane + 32 c of Dv), and the warps of a row merge through
// shared memory.  With splits = 1 the block writes out and the lse; else each row's partial
// (m, l, o[Dv]) in base 2 goes to a float32 workspace the wrapper allocates, and the merge
// kernel (a block a row) combines the pieces as dist/split_softmax.py's merge does: M the
// largest m, a piece's weight 2^(m - M), 0 for a piece that kept no key; out = sum w o /
// sum w l and lse = M + log2(sum w l), 0 and +inf for a row that keeps no key.  Decode is
// bound by the bytes of k and v, each key read once: 21 MB at danube's decode over 4,096
// keys (8 kv heads of 80), 6.3 us at 3.35 TB/s; both launches take about 17 us on the device
// of an NVIDIA H100 80GB HBM3 at 700 W with the keys left in L2 by the call before, 19 us
// with L2 flushed.  At (192, 128) a block of 16 rows takes 136,704 bytes of shared memory.
//
// Build.  The 17 tiled instantiations dominate the compile (about 50 s in one nvcc on the
// card's host), so kernels/build.py compiles this file as K4_PARTS translation units at once,
// each with -DK4_PART=i, and links them into one library: part 0 holds the launch function,
// the short-row kernels and their merge, parts 1 .. K4_PARTS - 1 the tiled widths, width i
// in part 1 + i % (K4_PARTS - 1), each exported as flash_attention_tiled_part<i> (it returns
// -1 for a width it does not hold).  Compiled whole (no K4_PARTS), the file holds everything.
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#ifndef K4_PARTS
#define K4_PARTS 1
#endif
#ifndef K4_PART
#define K4_PART 0
#endif
// whether this translation unit holds tiled width i (0 .. 16: D = 8 (i + 1) exact, then 192)
#define K4_MINE(i) (K4_PARTS == 1 || (K4_PART != 0 && (i) % (K4_PARTS - 1) + 1 == K4_PART))
#define K4_CAT(a, b) a##b
#define K4_PART_FN(n) K4_CAT(flash_attention_tiled_part, n)

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;    // null, or [B, Hq, S]: each row's base-2 log-sum-exp (+inf without a key)
  int64_t Hq, Hkv, S, T, D, Dv;
  int64_t L;     // kv_len: the keys that exist, the first L of each head's T rows
  int64_t rep;   // Hq / Hkv
  int64_t rows;  // rep * S query rows per (batch, kv head)
  int32_t causal, has_window;
  int64_t window;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// ---- the tiled kernel (rows >= kTileRows)

constexpr int kTileRows = 64;      // packed query rows a block
constexpr int kTileKeys = 64;      // keys a tile
constexpr int kTiledThreads = 128;
constexpr int kPadP = kTileRows + 4;  // a row of P transposed, padded by 16 bytes
constexpr size_t kMaxSmem = 232448;   // the shared memory a block may have on an H100

// q and two stages of K, each [64][DK + 4], two stages of V, each [64][DV + 4], and P
// transposed, [64][kPadP], in a buffer of its own or (in_k) in the K stage it came from
__host__ __device__ constexpr size_t tiled_smem_bytes(int DK, int DV, bool in_k) {
  return static_cast<size_t>(3 * kTileRows * (DK + 4) + 2 * kTileKeys * (DV + 4) +
                             (in_k ? 0 : kTileKeys * kPadP)) * sizeof(float);
}
__host__ __device__ constexpr bool p_in_k(int DK, int DV) {
  return tiled_smem_bytes(DK, DV, false) > kMaxSmem;
}

// a 16-byte copy from global to shared memory that does not block; zeros if !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// keys t0 .. t0 + 63 of K (D wide) and V (Dv wide) into ks ([64][DK + 4]) and vs
// ([64][DV + 4]), 16 bytes a copy; rows past L (kv_len) and columns past D or Dv are
// zero-filled, not read.  Commits one cp.async group.
template <int DK, int DV>
__device__ __forceinline__ void load_kv_tile(float* ks, float* vs, const float* kb,
                                             const float* vb, int64_t t0, int64_t L,
                                             int64_t D, int64_t Dv) {
  if constexpr (DK == DV) {  // one index computation for both copies
    for (int e = threadIdx.x; e < kTileKeys * (DK / 4); e += kTiledThreads) {
      const int j = e / (DK / 4), d = (e - j * (DK / 4)) * 4;
      const bool row = t0 + j < L, ok_k = row && d < D, ok_v = row && d < Dv;
      cp_async16(ks + j * (DK + 4) + d, kb + (ok_k ? (t0 + j) * D + d : 0), ok_k);
      cp_async16(vs + j * (DV + 4) + d, vb + (ok_v ? (t0 + j) * Dv + d : 0), ok_v);
    }
  } else {
    for (int e = threadIdx.x; e < kTileKeys * (DK / 4); e += kTiledThreads) {
      const int j = e / (DK / 4), d = (e - j * (DK / 4)) * 4;
      const bool ok = t0 + j < L && d < D;
      cp_async16(ks + j * (DK + 4) + d, kb + (ok ? (t0 + j) * D + d : 0), ok);
    }
    for (int e = threadIdx.x; e < kTileKeys * (DV / 4); e += kTiledThreads) {
      const int j = e / (DV / 4), d = (e - j * (DV / 4)) * 4;
      const bool ok = t0 + j < L && d < Dv;
      cp_async16(vs + j * (DV + 4) + d, vb + (ok ? (t0 + j) * Dv + d : 0), ok);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float half_warp_max(float x) {  // over the 16 lanes of a row group
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DK, DV: the widths of q and k, and of v, that shared memory holds (D <= DK, Dv <= DV),
// compile-time constants so the loops over them unroll whole; EXACT: D = DK and Dv = DV.
// The grid is one dimension: block L owns row tile tiles - 1 - L / heads of (batch, kv
// head) L % heads.
template <int DK, int DV, bool EXACT>
__global__ void __launch_bounds__(kTiledThreads)
    flash_attention_tiled_kernel(const Params p, const int64_t tiles, const int64_t heads) {
  constexpr int C4 = (DV + 63) / 64;  // 16-byte column chunks of the output a thread holds
  constexpr int DP = DK + 4, DPV = DV + 4;
  constexpr bool kPInK = p_in_k(DK, DV);
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [64][DP], scaled
  float* k_s = q_s + kTileRows * DP;             // [2][64][DP]
  float* v_s = k_s + 2 * kTileKeys * DP;         // [2][64][DPV]
  float* p_buf = v_s + 2 * kTileKeys * DPV;      // [64 keys][kPadP], unless kPInK

  const int tid = threadIdx.x;
  const int g = tid >> 4;   // row group: rows 8g .. 8g + 7
  const int c = tid & 15;   // keys c + 16 i; output columns 4c + 64 j
  const int64_t bh = static_cast<int64_t>(blockIdx.x) % heads;  // b * Hkv + kvh
  const int64_t r0 = (tiles - 1 - static_cast<int64_t>(blockIdx.x) / heads) * kTileRows;
  const int64_t b = bh / p.Hkv, kvh = bh - b * p.Hkv;
  const int64_t nr = min64(kTileRows, p.rows - r0);
  const float* q = static_cast<const float*>(p.q);
  const int64_t D = EXACT ? DK : p.D, Dv = EXACT ? DV : p.Dv;
  const float* kb = static_cast<const float*>(p.k) + bh * p.T * D;
  const float* vb = static_cast<const float*>(p.v) + bh * p.T * Dv;
  constexpr int vecs = DK / 4;  // 16-byte vectors a row of q

  // the keys some row of the block can see, [k_begin, k_end); the last key the first
  // row sees and the first key the last row sees bound the tiles that need no mask
  const int64_t shift = p.L - p.S;
  const int64_t s_first = r0 / p.rep, s_last = (r0 + nr - 1) / p.rep;
  const int64_t k_end = p.causal ? min64(p.L, s_last + shift + 1) : p.L;
  const int64_t k_begin = p.has_window ? max64(0, s_first + shift - p.window + 1) : 0;
  const int64_t hi_min = p.causal ? min64(p.L - 1, s_first + shift) : p.L - 1;
  const int64_t lo_max = p.has_window ? s_last + shift - p.window + 1 : 0;
  const int64_t t_first = (k_begin / kTileKeys) * kTileKeys;

  if (t_first < k_end) load_kv_tile<DK, DV>(k_s, v_s, kb, vb, t_first, p.L, D, Dv);

  // stage the block's query rows, scaled into the base-2 softmax, while tile 0 loads
  for (int e = tid; e < kTileRows * vecs; e += kTiledThreads) {
    const int r = e / vecs, d = (e - r * vecs) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < nr && d < D) {
      const int64_t s = (r0 + r) / p.rep, gq = (r0 + r) - s * p.rep;
      val = __ldg(reinterpret_cast<const float4*>(
          q + ((b * p.Hq + kvh * p.rep + gq) * p.S + s) * D + d));
      val.x *= p.scale_log2;
      val.y *= p.scale_log2;
      val.z *= p.scale_log2;
      val.w *= p.scale_log2;
    }
    *reinterpret_cast<float4*>(q_s + r * DP + d) = val;
  }

  bool col_ok[C4];
#pragma unroll
  for (int j = 0; j < C4; ++j) col_ok[j] = 4 * c + 64 * j < Dv;
  float m[8], l[8], o[8][4 * C4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * C4; ++j) o[i][j] = 0.0f;
  }
  const float* q_g = q_s + 8 * g * DP;

  int stage = 0;
  for (int64_t t0 = t_first; t0 < k_end; t0 += kTileKeys, stage ^= 1) {
    if (t0 + kTileKeys < k_end) {  // block-uniform
      load_kv_tile<DK, DV>(k_s + (stage ^ 1) * kTileKeys * DP,
                           v_s + (stage ^ 1) * kTileKeys * DPV, kb, vb, t0 + kTileKeys, p.L, D,
                           Dv);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t0 (and, the first time, q) is in shared memory
    const float* ks = k_s + stage * kTileKeys * DP;
    const float* vs = v_s + stage * kTileKeys * DPV;

    // logits of rows 8g + i against keys c + 16 k, base 2, already scaled
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[i][k] = 0.0f;
#pragma unroll
    for (int d = 0; d < DK; d += 4) {
      float4 kf[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        kf[k] = *reinterpret_cast<const float4*>(ks + (c + 16 * k) * DP + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(q_g + i * DP + d);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sc[i][k] = fmaf(qf.x, kf[k].x, sc[i][k]);
          sc[i][k] = fmaf(qf.y, kf[k].y, sc[i][k]);
          sc[i][k] = fmaf(qf.z, kf[k].z, sc[i][k]);
          sc[i][k] = fmaf(qf.w, kf[k].w, sc[i][k]);
        }
      }
    }
    if (t0 < lo_max || t0 + kTileKeys - 1 > hi_min) {  // a tile on an edge (block-uniform)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t qpos = (r0 + 8 * g + i) / p.rep + shift;
        const int64_t hi = p.causal ? min64(p.L - 1, qpos) : p.L - 1;
        const int64_t lo = p.has_window ? qpos - p.window + 1 : 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t key = t0 + c + 16 * k;
          if (key < lo || key > hi) sc[i][k] = -INFINITY;
        }
      }
    }
    // online softmax, once a tile: probabilities into sc, rescale of o and l
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float mx = half_warp_max(fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3])));
      const float mn = fmaxf(m[i], mx);
      const float base = mn == -INFINITY ? 0.0f : mn;  // a row that sees nothing yet
      const float alpha = exp2f(m[i] - base);
      m[i] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sc[i][k] = exp2f(sc[i][k] - base);
        sum += sc[i][k];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < 4 * C4; ++j) o[i][j] *= alpha;
    }
    // P transposed: key c + 16 k, rows 8g .. 8g + 7 as two 16-byte stores; in the K stage
    // of this tile once every thread is done with its logits
    float* p_s = p_buf;
    if constexpr (kPInK) {
      p_s = k_s + stage * kTileKeys * DP;
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float4* dst = reinterpret_cast<float4*>(p_s + (c + 16 * k) * kPadP + 8 * g);
      dst[0] = make_float4(sc[0][k], sc[1][k], sc[2][k], sc[3][k]);
      dst[1] = make_float4(sc[4][k], sc[5][k], sc[6][k], sc[7][k]);
    }
    __syncthreads();  // P is whole
    // o[i] += sum_key P[i, key] v[key], columns 4c + 64 j
#pragma unroll 16
    for (int key = 0; key < kTileKeys; ++key) {
      const float4* pp = reinterpret_cast<const float4*>(p_s + key * kPadP + 8 * g);
      const float4 p0 = pp[0], p1 = pp[1];
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int j = 0; j < C4; ++j) {
        if (!col_ok[j]) continue;
        const float4 vv = *reinterpret_cast<const float4*>(vs + key * DPV + 4 * c + 64 * j);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[i][4 * j] = fmaf(pr[i], vv.x, o[i][4 * j]);
          o[i][4 * j + 1] = fmaf(pr[i], vv.y, o[i][4 * j + 1]);
          o[i][4 * j + 2] = fmaf(pr[i], vv.z, o[i][4 * j + 2]);
          o[i][4 * j + 3] = fmaf(pr[i], vv.w, o[i][4 * j + 3]);
        }
      }
    }
    __syncthreads();  // this stage and P are free for the next tile
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float den = half_warp_sum(l[i]);
    const int64_t r = 8 * g + i;
    if (r >= nr) continue;
    const int64_t s = (r0 + r) / p.rep, gq = (r0 + r) - s * p.rep;
    float* orow = out + ((b * p.Hq + kvh * p.rep + gq) * p.S + s) * Dv;
    if (p.lse != nullptr && c == 0)
      p.lse[(b * p.Hq + kvh * p.rep + gq) * p.S + s] = den > 0.0f ? m[i] + log2f(den) : INFINITY;
#pragma unroll
    for (int j = 0; j < C4; ++j) {
      if (!col_ok[j]) continue;
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (den > 0.0f) {
        val = make_float4(o[i][4 * j] / den, o[i][4 * j + 1] / den, o[i][4 * j + 2] / den,
                          o[i][4 * j + 3] / den);
      }
      *reinterpret_cast<float4*>(orow + 4 * c + 64 * j) = val;
    }
  }
}

template <int DK, int DV, bool EXACT>
int launch_tiled(const Params& p, int64_t B, cudaStream_t stream) {
  constexpr size_t smem = tiled_smem_bytes(DK, DV, p_in_k(DK, DV));
  static_assert(smem <= kMaxSmem, "the tiled kernel's shared memory");
  auto kernel = flash_attention_tiled_kernel<DK, DV, EXACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (p.rows + kTileRows - 1) / kTileRows;
  const int64_t heads = B * p.Hkv;
  if (tiles * heads > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned int>(tiles * heads), kTiledThreads, smem, stream>>>(
      p, tiles, heads);
  return static_cast<int>(cudaGetLastError());
}

// (D, D) exact where Dv = D <= 128, (192, 128) for every other pair; -1 where this
// translation unit does not hold the instantiation
int launch_tiled_mine(const Params& p, int64_t B, cudaStream_t stream) {
  if (p.Dv != p.D || p.D > 128) {
#if K4_MINE(16)
    return launch_tiled<192, 128, false>(p, B, stream);
#else
    return -1;
#endif
  }
  switch (p.D) {
#if K4_MINE(0)
    case 8: return launch_tiled<8, 8, true>(p, B, stream);
#endif
#if K4_MINE(1)
    case 16: return launch_tiled<16, 16, true>(p, B, stream);
#endif
#if K4_MINE(2)
    case 24: return launch_tiled<24, 24, true>(p, B, stream);
#endif
#if K4_MINE(3)
    case 32: return launch_tiled<32, 32, true>(p, B, stream);
#endif
#if K4_MINE(4)
    case 40: return launch_tiled<40, 40, true>(p, B, stream);
#endif
#if K4_MINE(5)
    case 48: return launch_tiled<48, 48, true>(p, B, stream);
#endif
#if K4_MINE(6)
    case 56: return launch_tiled<56, 56, true>(p, B, stream);
#endif
#if K4_MINE(7)
    case 64: return launch_tiled<64, 64, true>(p, B, stream);
#endif
#if K4_MINE(8)
    case 72: return launch_tiled<72, 72, true>(p, B, stream);
#endif
#if K4_MINE(9)
    case 80: return launch_tiled<80, 80, true>(p, B, stream);
#endif
#if K4_MINE(10)
    case 88: return launch_tiled<88, 88, true>(p, B, stream);
#endif
#if K4_MINE(11)
    case 96: return launch_tiled<96, 96, true>(p, B, stream);
#endif
#if K4_MINE(12)
    case 104: return launch_tiled<104, 104, true>(p, B, stream);
#endif
#if K4_MINE(13)
    case 112: return launch_tiled<112, 112, true>(p, B, stream);
#endif
#if K4_MINE(14)
    case 120: return launch_tiled<120, 120, true>(p, B, stream);
#endif
#if K4_MINE(15)
    case 128: return launch_tiled<128, 128, true>(p, B, stream);
#endif
    default: return -1;
  }
}

}  // namespace

#if K4_PART != 0
// a part's tiled widths, called from part 0's launch function
extern "C" int K4_PART_FN(K4_PART)(const void* p, int64_t B, void* stream) {
  return launch_tiled_mine(*static_cast<const Params*>(p), B, static_cast<cudaStream_t>(stream));
}
#else
#if K4_PARTS > 1
extern "C" int flash_attention_tiled_part1(const void* p, int64_t B, void* stream);
#endif
#if K4_PARTS > 2
extern "C" int flash_attention_tiled_part2(const void* p, int64_t B, void* stream);
#endif
#if K4_PARTS > 3
extern "C" int flash_attention_tiled_part3(const void* p, int64_t B, void* stream);
#endif
#if K4_PARTS > 4
extern "C" int flash_attention_tiled_part4(const void* p, int64_t B, void* stream);
#endif
#if K4_PARTS > 5
#error "K4_PARTS is at most 5"
#endif

namespace {

// ---- the short-row kernel (rows < kTileRows) and its merge

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;        // keys a tile, the unit a piece is cut in
constexpr int kStages = 3;        // cp.async stages of K and V tiles
constexpr int kMaxSplits = 128;   // pieces a head's keys may be cut into

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the rows a short-row block owns: the least power of two >= rows, at most 16 (the
// rule of kernels/ops.py's attention_rows_a_block)
int rows_a_block(int64_t rows) {
  return rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : rows <= 8 ? 8 : 16;
}

// how a block of R rows spreads a 32-key tile over its four warps: R >= 4, warp w owns
// rows w, w + 4, ... (RW of them) and lane j key j of every tile; R < 4, WR = 4 / R warps
// share a row, each KW = 32 / WR keys of a tile, LK = WR lanes a key, each a slice of D
template <int R>
struct RowMap {
  static constexpr int WR = R >= 4 ? 1 : 4 / R;  // warps a row
  static constexpr int RW = R >= 4 ? R / 4 : 1;  // rows a warp
  static constexpr int LK = WR;                  // lanes a key
  static constexpr int KW = kChunk / WR;         // keys of a tile a warp takes
};

// the dynamic shared memory of flash_attention_split_kernel<R>: q, then kStages stages of
// a K tile (rows padded by 4 LK floats, so the lanes' 16-byte loads do not collide) and
// a V tile
template <int R>
size_t split_smem_bytes(int64_t D, int64_t Dv) {
  return static_cast<size_t>(R * D + kStages * kChunk * (D + 4 * RowMap<R>::LK + Dv)) * 4;
}

// keys t0 .. t0 + 31 of K (D wide) and V (Dv wide) into a stage, 16 bytes a copy, keys
// past L zero-filled and not read; commits nothing
__device__ __forceinline__ void load_chunk(float* ks, float* vs, const float* kb,
                                           const float* vb, int64_t t0, int64_t L, int D,
                                           int Dv, int dpk) {
  const int k4 = D / 4, v4 = Dv / 4;
  for (int e = threadIdx.x; e < kChunk * k4; e += kThreads) {
    const int j = e / k4, d = (e - j * k4) * 4;
    const bool ok = t0 + j < L;
    cp_async16(ks + j * dpk + d, kb + (ok ? (t0 + j) * D + d : 0), ok);
  }
  for (int e = threadIdx.x; e < kChunk * v4; e += kThreads) {
    const int j = e / v4, d = (e - j * v4) * 4;
    const bool ok = t0 + j < L;
    cp_async16(vs + j * Dv + d, vb + (ok ? (t0 + j) * Dv + d : 0), ok);
  }
}

// Block (tile * splits + piece, kvh, b): rows r0 .. r0 + R - 1 (r0 = tile R) of (b, kvh)
// over piece `piece` of the keys they can see.  With splits = 1 it writes out (and lse);
// else each row's partial (m, l, o[Dv]) to work: o at work[(row * splits + piece) * Dv],
// (m, l) at work[total * Dv + 2 (row * splits + piece)], row = (b Hkv + kvh) rows + r0 + r.
template <int R>
__global__ void __launch_bounds__(kThreads)
    flash_attention_split_kernel(const Params p, const int splits, float* __restrict__ work) {
  using Map = RowMap<R>;
  constexpr int WR = Map::WR, RW = Map::RW, LK = Map::LK, KW = Map::KW;
  constexpr int C = 4;  // value columns a lane holds: lane + 32 c (Dv <= 128)
  extern __shared__ float4 smem4[];
  const int D = static_cast<int>(p.D), Dv = static_cast<int>(p.Dv), D4 = D / 4;
  const int dpk = D + 4 * LK;                  // a K row in shared memory
  const int stage = kChunk * (dpk + Dv);       // floats a stage
  float* q_s = reinterpret_cast<float*>(smem4);  // [R][D], scaled
  float* kv_s = q_s + R * D;                     // [kStages][K tile, V tile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tile = blockIdx.x / splits, piece = blockIdx.x - tile * splits;
  const int64_t b = blockIdx.z, kvh = blockIdx.y, bh = b * p.Hkv + kvh;
  const int64_t r0 = tile * R;
  const int64_t nr = min64(R, p.rows - r0);
  const float* q = static_cast<const float*>(p.q);
  const float* kb = static_cast<const float*>(p.k) + bh * p.T * D;
  const float* vb = static_cast<const float*>(p.v) + bh * p.T * Dv;

  // the keys some row of the block can see, [k_begin, k_end), as n_chunks 32-key chunks
  // from chunk c_lo; this block's piece is chunks piece * per .. of them (none past the end)
  const int64_t shift = p.L - p.S;
  const int64_t s_first = r0 / p.rep, s_last = (r0 + nr - 1) / p.rep;
  const int64_t k_end = p.causal ? min64(p.L, s_last + shift + 1) : p.L;
  const int64_t k_begin = p.has_window ? max64(0, s_first + shift - p.window + 1) : 0;
  const int64_t c_lo = k_begin / kChunk;
  const int64_t n_chunks = k_end > k_begin ? (k_end + kChunk - 1) / kChunk - c_lo : 0;
  const int64_t per = (n_chunks + splits - 1) / splits;
  const int64_t t_first = (c_lo + min64(piece * per, n_chunks)) * kChunk;
  const int64_t n_tiles = max64(0, min64(per, n_chunks - piece * per));

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      float* st = kv_s + s * stage;
      load_chunk(st, st + kChunk * dpk, kb, vb, t_first + s * kChunk, p.L, D, Dv, dpk);
    }
    cp_async_commit();  // empty groups too, so the wait below counts tiles
  }
  // the block's query rows, scaled into the base-2 softmax, while the first tiles load;
  // row r is position (r0 + r) / rep of q head kvh * rep + (r0 + r) % rep
  for (int e = tid; e < R * D4; e += kThreads) {
    const int r = e / D4, d = (e - r * D4) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < nr) {
      const int64_t s = (r0 + r) / p.rep, g = (r0 + r) - s * p.rep;
      val = __ldg(reinterpret_cast<const float4*>(
          q + ((b * p.Hq + kvh * p.rep + g) * p.S + s) * D + d));
      val.x *= p.scale_log2;
      val.y *= p.scale_log2;
      val.z *= p.scale_log2;
      val.w *= p.scale_log2;
    }
    *reinterpret_cast<float4*>(q_s + r * D + d) = val;
  }

  // this warp's rows and keys: row(i) of the block, keys key0 .. key0 + KW - 1 of a tile;
  // this lane's key kt and its slice sl of D
  int row[RW];
  int64_t lo[RW], hi[RW];  // the keys row i keeps, [lo, hi] (empty for a row past nr)
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    row[i] = R >= 4 ? warp + 4 * i : warp / WR;
    const int64_t qpos = (r0 + row[i]) / p.rep + shift;
    hi[i] = p.causal ? min64(p.L - 1, qpos) : p.L - 1;
    lo[i] = p.has_window ? qpos - p.window + 1 : 0;
    if (row[i] >= nr) lo[i] = hi[i] + 1;
  }
  const int key0 = R >= 4 ? 0 : (warp % WR) * KW;
  const int sl = lane % LK, kt = key0 + lane / LK;

  float m[RW], l[RW], o[RW][C];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;  // this lane's share: the probabilities of its key when sl == 0
#pragma unroll
    for (int c = 0; c < C; ++c) o[i][c] = 0.0f;
  }

  for (int64_t t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t (and q) is in shared memory; tile t - 1's stage is free
    if (t + kStages - 1 < n_tiles) {
      float* st = kv_s + ((t + kStages - 1) % kStages) * stage;
      load_chunk(st, st + kChunk * dpk, kb, vb, t_first + (t + kStages - 1) * kChunk, p.L,
                 D, Dv, dpk);
    }
    cp_async_commit();
    const float* ks = kv_s + (t % kStages) * stage;
    const float* vs = ks + kChunk * dpk;
    const int64_t key = t_first + t * kChunk + kt;

    // logits of key kt for the warp's rows (base 2, already scaled), LK lanes a key
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.0f;
    const float4* krow = reinterpret_cast<const float4*>(ks + kt * dpk);
    for (int j = sl; j < D4; j += LK) {
      const float4 kk = krow[j];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qq = reinterpret_cast<const float4*>(q_s + row[i] * D)[j];
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }
    // online softmax, per row (warp-uniform branches)
    float pr[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
#pragma unroll
      for (int x = 1; x < LK; x <<= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], x);
      const float si = key >= lo[i] && key <= hi[i] ? s[i] : -INFINITY;
      const float mn = fmaxf(m[i], warp_max(si));
      float alpha = 1.0f;
      pr[i] = 0.0f;
      if (mn != -INFINITY) {
        pr[i] = exp2f(si - mn);
        alpha = exp2f(m[i] - mn);
      }
      m[i] = mn;
      l[i] = l[i] * alpha + (sl == 0 ? pr[i] : 0.0f);
#pragma unroll
      for (int c = 0; c < C; ++c) o[i][c] *= alpha;
    }
    // o[i] += sum_j p[i, j] v[j] over the warp's keys; lane holds columns lane + 32 c
#pragma unroll 8
    for (int j = 0; j < KW; ++j) {
      const float* vrow = vs + (key0 + j) * Dv;
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = lane + 32 * c < Dv ? vrow[lane + 32 * c] : 0.0f;
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, pr[i], j * LK);
#pragma unroll
        for (int c = 0; c < C; ++c) o[i][c] = fmaf(pj, vv[c], o[i][c]);
      }
    }
  }

  // the warps' parts of each row, merged through the stage memory
#pragma unroll
  for (int i = 0; i < RW; ++i) l[i] = warp_sum(l[i]);
  cp_async_wait<0>();
  __syncthreads();
  float* o_part = kv_s;                          // [kWarps][RW][Dv]
  float* m_part = o_part + kWarps * RW * Dv;     // [kWarps][RW]
  float* l_part = m_part + kWarps * RW;          // [kWarps][RW]
#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (lane + 32 * c < Dv) o_part[(warp * RW + i) * Dv + lane + 32 * c] = o[i][c];
    if (lane == 0) {
      m_part[warp * RW + i] = m[i];
      l_part[warp * RW + i] = l[i];
    }
  }
  __syncthreads();
  const int64_t total = static_cast<int64_t>(gridDim.z) * p.Hkv * p.rows * splits;
  for (int e = tid; e < nr * Dv; e += kThreads) {
    const int r = e / Dv, d = e - r * Dv;
    // row r's warps: r % 4 (its row r / 4) for R >= 4, else r WR .. r WR + WR - 1
    const int w0 = R >= 4 ? r % 4 : r * WR, i = R >= 4 ? r / 4 : 0;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WR; ++w) mx = fmaxf(mx, m_part[(w0 + w) * RW + i]);
    float num = 0.0f, den = 0.0f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WR; ++w) {
        const float mw = m_part[(w0 + w) * RW + i];
        if (mw == -INFINITY) continue;
        const float sc = exp2f(mw - mx);
        den += sc * l_part[(w0 + w) * RW + i];
        num += sc * o_part[((w0 + w) * RW + i) * Dv + d];
      }
    }
    const int64_t rr = r0 + r;
    if (splits == 1) {
      const int64_t s = rr / p.rep, g = rr - s * p.rep;
      const int64_t orow = (b * p.Hq + kvh * p.rep + g) * p.S + s;
      static_cast<float*>(p.out)[orow * Dv + d] = den > 0.0f ? num / den : 0.0f;
      if (p.lse != nullptr && d == 0) p.lse[orow] = den > 0.0f ? mx + log2f(den) : INFINITY;
    } else {
      const int64_t idx = (bh * p.rows + rr) * splits + piece;
      work[idx * Dv + d] = num;
      if (d == 0) {
        work[total * Dv + 2 * idx] = den > 0.0f ? mx : -INFINITY;
        work[total * Dv + 2 * idx + 1] = den;
      }
    }
  }
}

// over the 128 threads of a block; every thread gets the result
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();  // red is free again
  return x;
}
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = (red[0] + red[1]) + (red[2] + red[3]);
  __syncthreads();
  return x;
}

// Block `row` = (b Hkv + kvh) rows + rr: the row's `splits` partials merged as
// dist/split_softmax.py's merge does, M = the largest m over the pieces that kept a key,
// a piece's weight 2^(m - M) (0 for a piece without one):
//     out = sum w o / sum w l,  lse = M + log2(sum w l);  0 and +inf without a key
__global__ void __launch_bounds__(kThreads)
    flash_attention_merge_kernel(const Params p, const int splits, const float* __restrict__ work,
                                 const int64_t total) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float red[kWarps];
  __shared__ float4 acc_s[kThreads];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int64_t bh = row / p.rows, rr = row - bh * p.rows;
  const int64_t b = bh / p.Hkv, kvh = bh - b * p.Hkv;
  const int64_t s = rr / p.rep, g = rr - s * p.rep;
  const int Dv = static_cast<int>(p.Dv);
  const float* o_w = work + row * splits * Dv;
  const float* ml = work + total * Dv + row * splits * 2;

  float mx = -INFINITY;
  for (int j = tid; j < splits; j += kThreads) mx = fmaxf(mx, ml[2 * j]);
  mx = block_max(mx, red);
  float den = 0.0f;
  for (int j = tid; j < splits; j += kThreads) {
    const float mj = ml[2 * j];
    const float w = mj == -INFINITY ? 0.0f : exp2f(mj - mx);
    w_s[j] = w;
    den += w * ml[2 * j + 1];
  }
  den = block_sum(den, red);  // its syncs also publish w_s
  // thread (gi, c) sums the pieces gi, gi + P, ... of 16-byte column c
  const int v4 = Dv / 4, P = kThreads / v4;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid < P * v4) {
    const int c = tid % v4, gi = tid / v4;
    for (int j = gi; j < splits; j += P) {
      const float w = w_s[j];
      if (w == 0.0f) continue;
      const float4 x = reinterpret_cast<const float4*>(o_w + j * Dv)[c];
      acc.x = fmaf(w, x.x, acc.x);
      acc.y = fmaf(w, x.y, acc.y);
      acc.z = fmaf(w, x.z, acc.z);
      acc.w = fmaf(w, x.w, acc.w);
    }
  }
  acc_s[tid] = acc;
  __syncthreads();
  const int64_t orow = (b * p.Hq + kvh * p.rep + g) * p.S + s;
  if (tid < v4) {
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int gi = 0; gi < P; ++gi) {
      const float4 x = acc_s[gi * v4 + tid];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (den > 0.0f) val = make_float4(sum.x / den, sum.y / den, sum.z / den, sum.w / den);
    reinterpret_cast<float4*>(static_cast<float*>(p.out) + orow * Dv)[tid] = val;
  }
  if (p.lse != nullptr && tid == 0) p.lse[orow] = den > 0.0f ? mx + log2f(den) : INFINITY;
}

template <int R>
int launch_split(const Params& p, int64_t B, int splits, float* work, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<R>(p.D, p.Dv);
  auto kernel = flash_attention_split_kernel<R>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (p.rows + R - 1) / R;
  const int64_t rows_all = B * p.Hkv * p.rows;
  if (tiles * splits > 0x7fffffff || rows_all > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned int>(tiles * splits), static_cast<unsigned int>(p.Hkv),
                  static_cast<unsigned int>(B));
  kernel<<<grid, kThreads, smem, stream>>>(p, splits, work);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  flash_attention_merge_kernel<<<static_cast<unsigned int>(rows_all), kThreads, 0, stream>>>(
      p, splits, work, rows_all * splits);
  return static_cast<int>(cudaGetLastError());
}

int launch_short(const Params& p, int64_t B, int splits, float* work, cudaStream_t stream) {
  switch (rows_a_block(p.rows)) {
    case 1: return launch_split<1>(p, B, splits, work, stream);
    case 2: return launch_split<2>(p, B, splits, work, stream);
    case 4: return launch_split<4>(p, B, splits, work, stream);
    case 8: return launch_split<8>(p, B, splits, work, stream);
    default: return launch_split<16>(p, B, splits, work, stream);
  }
}

// the tiled kernel of (D, Dv), from whichever translation unit holds it
int launch_tiled_d(const Params& p, int64_t B, cudaStream_t stream) {
  int rc = launch_tiled_mine(p, B, stream);
#if K4_PARTS > 1
  if (rc == -1) rc = flash_attention_tiled_part1(&p, B, stream);
#endif
#if K4_PARTS > 2
  if (rc == -1) rc = flash_attention_tiled_part2(&p, B, stream);
#endif
#if K4_PARTS > 3
  if (rc == -1) rc = flash_attention_tiled_part3(&p, B, stream);
#endif
#if K4_PARTS > 4
  if (rc == -1) rc = flash_attention_tiled_part4(&p, B, stream);
#endif
  return rc == -1 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

}  // namespace

// Launches on `stream` and returns a CUDA error code as an int (0 = success).  All
// pointers are device pointers to contiguous float32 tensors; the caller has checked the
// shapes (Hq % Hkv == 0, D and Dv multiples of 8, 8 <= Dv <= D <= 192, Dv <= 128, B and
// Hkv at most 65,535, S and T at least 1, 1 <= kv_len <= T); lse is null or a float32
// [B, Hq, S] that every kernel fills with each row's base-2 log-sum-exp (+inf for a row
// that keeps no key), the convention of flash_attention_sm90.cu.  splits: the pieces a
// head's keys are cut into on the short-row kernel (kernels/ops.py's
// attention_split_plan), 1 on the tiled one; with splits > 1, work is a float32 workspace
// of B Hkv rows splits (Dv + 2) values that the call overwrites.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      float* lse, int64_t B, int64_t Hq, int64_t Hkv,
                                      int64_t S, int64_t T, int64_t kv_len, int64_t D,
                                      int64_t Dv, int32_t causal, int32_t has_window,
                                      int64_t window, float scale, float* work, int64_t splits,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (kv_len < 1 || kv_len > T || D > 192 || Dv < 8 || Dv > D || Dv > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, lse, Hq, Hkv, S, T, D, Dv, kv_len, Hq / Hkv, (Hq / Hkv) * S,
           causal, has_window, window, scale * kLog2e};
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.rows >= kTileRows)
    return splits == 1 ? launch_tiled_d(p, B, s) : static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_short(p, B, static_cast<int>(splits), work, s);
}
#endif  // K4_PART
