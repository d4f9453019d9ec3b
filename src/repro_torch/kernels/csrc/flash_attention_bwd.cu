// K4 flash_attention, backward, float32: the gradients dq, dk and dv of online-softmax
// attention with causal, sliding-window and GQA masks, on the CUDA cores.
//
// Replaces no TPU kernel: src/repro/kernels/flash_attention.py::flash_attention_pallas has
// no backward, and the JAX package's training differentiates its XLA attention
// (src/repro/models/transformer.py::_attention_scores) with jax.grad.  The port's models
// attend through K4 (flash_attention_sm90.cu, flash_attention.cu), so training needs K4's
// backward on the card: this is it for float32, behind ops.flash_attention's autograd
// Function.  bfloat16 runs on the tensor cores (flash_attention_bwd_sm90.cu); float32
// stays here, as its forward stays on the CUDA cores: the tensor cores would run it as
// TF32, far outside float32's tolerance.
//
// Computes, for q [B, Hq, S, D], k [B, Hkv, T, D], v [B, Hkv, T, Dv], the forward's output
// o [B, Hq, S, Dv], its gradient do (all float32; Hq a multiple of Hkv; 8 <= Dv <= D <= 192,
// Dv <= 128, multiples of 8) and the forward's lse [B, Hq, S] (each row's base-2
// log-sum-exp of scale log2(e) q k^T over its kept keys, +inf without one; written by
// flash_attention.cu), with P = exp2(scale log2(e) q k^T - lse) over the keys the masks keep
// (query positions right-aligned to the T keys, qpos = s + T - S; causal keeps t <= qpos, a
// window keeps t > qpos - window):
//     delta = rowsum(do o o),  dv = P^T do,  ds = P o (do v^T - delta),
//     dq = scale ds k,  dk = scale ds^T q,
// with dk and dv summed over the Hq / Hkv q heads of each kv head.  A row that keeps no key
// has P = 0 and no gradient.  Everything accumulates in float32; dq's parts are added in
// the order the blocks reach them, so its last bits vary from run to run.  Every key
// exists (kv_len = T): the wrapper refuses a backward through a call over a prefix.
//
// Bound on an H100: five products (q k^T recomputed, do v^T, P^T do, dS^T q, dS k),
// 2 pairs (3 D + 2 Dv) Hq B operations (pairs: the (query, key) pairs the masks keep) at the
// 67 TFLOP/s of float32 outside the tensor cores; at training shapes it is bound by
// operations (granite-3-2b's training call, 4 x 1,024, 32/8 heads of 64, causal: 0.642 ms).
//
// Design: two launches from one launch function, the logits computed once, every product
// on the CUDA cores (FFMA).
//   1. delta, 16 lanes a row (16-byte loads of o and do), into float32 scratch [B, Hq, S];
//      the same lanes zero the row of dq, which launch 2 adds into.
//   2. The main kernel, a block of 256 threads for each (b, kv head, 64-key tile), key
//      tile 0 first (under causal it has the most query tiles).  The block loads its K and
//      V tiles once, rows padded by 16 bytes, and walks the group's q heads and the 64-row
//      query tiles the masks let see its keys; each step's q, do, lse and delta tiles come
//      in by cp.async (16 bytes a copy; lse and delta 4, their rows need not be 16-byte
//      aligned), into two stages where a block has an SM to itself, step n + 1 loading
//      while step n computes, else into one that two blocks an SM overlap.  A step:
//        * S = q k^T on warps 0-3 and dP = do v^T on warps 4-7 at once, thread (g, c)
//          holding the 8 x 4 register micro-tile of rows 8g .. 8g + 7 and keys c, c + 16,
//          c + 32, c + 48 (16-byte loads of q or do rows and of K or V rows: 128 FMAs for
//          12 loads, as the forward's);
//        * P = exp2(scale log2(e) S - lse) on warps 0-3 into shared memory (0 where
//          masked: the masks apply only on tiles that straddle an edge, S or T), then
//          dS = P o (dP - delta) on warps 4-7 into shared memory;
//        * dv += P^T do and dk += dS^T q, all 256 threads, thread (r, c) holding keys 4r ..
//          4r + 3 and columns 4c + 64 m in registers for the whole block: dk and dv are
//          written once (dk times scale), with no atomics;
//        * dq's part dS k (keys 4 at a time, 16-byte loads of dS rows and K rows), rows
//          4r .. 4r + 3 and columns 4c + 64 m, times scale, added into dq four columns a
//          reduction (red.global.add.v4.f32).
//      Five products, where this file's first design did eight (the logits in each of
//      its three launches, with the lse recomputed in the first).
// The widths are template parameters, the smallest of (64, 64), (128, 128) and (192, 128)
// that covers (D, Dv), zero-filled past D and Dv.  Shared memory (float32): K and V
// (64 x (DK + 4), 64 x (DV + 4)), STAGES stages of q, do (64 x DK, 64 x DV), lse and delta,
// P and dS (64 x 64 each).  At (64, 64) one stage, 100,864 bytes, and two blocks an SM (at
// most 128 registers a thread): on an NVIDIA H100 80GB HBM3 at 700.00 W it took 1.464 ms
// at granite-3-2b's training call against 1.690 with two stages (134,144 bytes, one block
// an SM; tools/kernel_ab.py, PERF.md §6).  At (128, 128) two stages, 232,448 bytes
// (the most a block may have), one block an SM.  At (192, 128) two stages would take
// 281,600 bytes: one stage, 199,168, one block an SM.  With one stage the next step's
// tiles load after this one's products.
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and keys of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;    // a block's most
constexpr size_t kSmemPerSm = 233472;  // an SM's

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // [B, Hq, S]: the forward's base-2 log-sum-exp, +inf without a key
  const float* delta;  // [B, Hq, S]: rowsum(do o o), from launch 1
  float* dq;           // zeroed by launch 1, dq's parts added into it
  float* dk;
  float* dv;
  int64_t Hq, Hkv, S, T, D, Dv, rep;
  int32_t causal, has_window;
  int64_t window;
  float scale, scale_log2;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// whether query row s (qpos = s + T - S) sees key t
__device__ __forceinline__ bool visible(const Params& p, int64_t s, int64_t t) {
  const int64_t qpos = s + p.T - p.S;
  return s < p.S && t < p.T && (!p.causal || t <= qpos) &&
         (!p.has_window || t > qpos - p.window);
}

// a copy from global to shared memory that does not block; zeros if !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// at[0 .. 3] += v: one float32 reduction of four values (no value returned)
__device__ __forceinline__ void red_add4(float* at, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(at), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float at4(const float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// rows row0 .. row0 + 63 of a head's [rows, width] matrix into dst ([64][W + pad]), 16
// bytes a copy; rows past `rows` and columns past `width` zero-filled, not read
template <int W, int STRIDE>
__device__ __forceinline__ void load_rows(float* dst, const float* head, int64_t row0,
                                          int64_t rows, int64_t width) {
  for (int e = threadIdx.x; e < kTile * (W / 4); e += kThreads) {
    const int r = e / (W / 4), c = (e - r * (W / 4)) * 4;
    const bool ok = row0 + r < rows && c < width;
    cp_async16(dst + r * STRIDE + c, head + (ok ? (row0 + r) * width + c : 0), ok);
  }
}

// acc[i][j] += sum over d < W of A[i][d] B[c + 16 j][d]: the 8 x 4 micro-tile of A B^T,
// A's 8 rows RA apart, B's rows RB apart
template <int W, int RA, int RB>
__device__ __forceinline__ void micro_abt(float (&acc)[8][4], const float* A, const float* Bm,
                                          int c) {
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    float4 bf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bf[j] = *reinterpret_cast<const float4*>(Bm + (c + 16 * j) * RB + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 af = *reinterpret_cast<const float4*>(A + i * RA + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(af.x, bf[j].x, acc[i][j]);
        acc[i][j] = fmaf(af.y, bf[j].y, acc[i][j]);
        acc[i][j] = fmaf(af.z, bf[j].z, acc[i][j]);
        acc[i][j] = fmaf(af.w, bf[j].w, acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------- 1. delta

// delta[row] = sum over Dv of do o o, 16 lanes a row, a 16-byte unit of o and of do a lane
// at a time; the lanes also zero the row's D floats of dq
__global__ void __launch_bounds__(256)
    attention_bwd_f32_delta_kernel(const float* o, const float* dout, float* delta, float* dq,
                                   int64_t rows, int64_t D, int64_t Dv) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = gid / 16;
  const int u = static_cast<int>(gid % 16);
  float sum = 0.0f;
  if (row < rows) {
    const float4* o4 = reinterpret_cast<const float4*>(o + row * Dv);
    const float4* d4 = reinterpret_cast<const float4*>(dout + row * Dv);
    for (int64_t i = u; i < Dv / 4; i += 16) {
      const float4 a = o4[i], c = d4[i];
      sum = fmaf(a.x, c.x, fmaf(a.y, c.y, fmaf(a.z, c.z, fmaf(a.w, c.w, sum))));
    }
    float4* q4 = reinterpret_cast<float4*>(dq + row * D);
    for (int64_t i = u; i < D / 4; i += 16) q4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && u == 0) delta[row] = sum;
}

// ---------------------------------------------------------------- 2. dk, dv and dq's parts

template <int DK, int DV, int STAGES>
constexpr size_t main_smem() {
  return static_cast<size_t>(kTile * (DK + 4) + kTile * (DV + 4) + STAGES * kTile * (DK + DV) +
                             2 * kTile * kTile + 2 * STAGES * kTile) * sizeof(float);
}

// DK, DV: D and Dv padded (64, 128 or 192; 64 or 128); STAGES: stages of the step tiles;
// BLOCKS: blocks an SM (it caps the registers).  The grid is one dimension: block x owns
// key tile x / heads of (batch, kv head) x % heads.
template <int DK, int DV, int STAGES, int BLOCKS>
__global__ void __launch_bounds__(kThreads, BLOCKS)
    attention_bwd_f32_kernel(const Params p, const int64_t heads) {
  constexpr int KP = DK + 4, VP = DV + 4;  // K and V rows, padded: 16 lanes read 16 rows
  constexpr int MK = DK / 64, MV = DV / 64;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [64][KP] this block's keys
  float* vs = ks + kTile * KP;                  // [64][VP]
  float* qs = vs + kTile * VP;                  // [STAGES][64][DK] a step's queries
  float* dos = qs + STAGES * kTile * DK;        // [STAGES][64][DV]
  float* ps = dos + STAGES * kTile * DV;        // [64 rows][64 keys] P
  float* dss = ps + kTile * kTile;              // [64 rows][64 keys] dS
  float* lse_s = dss + kTile * kTile;           // [STAGES][64]
  float* delta_s = lse_s + STAGES * kTile;      // [STAGES][64]

  const int tid = threadIdx.x;
  const int64_t bh = static_cast<int64_t>(blockIdx.x) % heads;  // b * Hkv + kvh
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) / heads * kTile;
  const int64_t b = bh / p.Hkv, kvh = bh - b * p.Hkv;
  const int64_t shift = p.T - p.S;  // qpos = s + shift
  // the query rows that see a key of [t0, t1]: causal needs qpos >= t0, a window
  // qpos < t1 + window
  const int64_t t1 = min64(t0 + kTile, p.T) - 1;
  int64_t s_lo = 0, s_hi = p.S - 1;
  if (p.causal) s_lo = max64(s_lo, t0 - shift);
  if (p.has_window) s_hi = min64(s_hi, t1 + p.window - 1 - shift);
  const int64_t qt_lo = s_lo / kTile;
  const int64_t nq = s_lo <= s_hi ? s_hi / kTile - qt_lo + 1 : 0;
  const int64_t steps = nq * p.rep;  // (q head of the group, query tile) pairs

  const float* kh = p.k + bh * p.T * p.D;
  const float* vh = p.v + bh * p.T * p.Dv;
  // step n: q head b * Hq + kvh * rep + n / nq, query tile qt_lo + n % nq
  auto load_step = [&](int64_t n, int st) {
    const int64_t hq = b * p.Hq + kvh * p.rep + n / nq, s0 = (qt_lo + n % nq) * kTile;
    load_rows<DK, DK>(qs + st * kTile * DK, p.q + hq * p.S * p.D, s0, p.S, p.D);
    load_rows<DV, DV>(dos + st * kTile * DV, p.dout + hq * p.S * p.Dv, s0, p.S, p.Dv);
    if (tid < 2 * kTile) {   // lse, then delta: a word a thread
      const int r = tid & (kTile - 1);
      const bool ok = s0 + r < p.S;
      const float* src = tid < kTile ? p.lse : p.delta;
      cp_async4((tid < kTile ? lse_s : delta_s) + st * kTile + r,
                src + (ok ? hq * p.S + s0 + r : 0), ok);
    }
    cp_async_commit();
  };

  float dka[4][4 * MK], dva[4][4 * MV];  // keys 4r + a, columns 4c + 64 m + e at [a][4 m + e]
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int e = 0; e < 4 * MK; ++e) dka[a][e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4 * MV; ++e) dva[a][e] = 0.0f;
  }
  const int r4 = tid >> 4;        // products: keys (dk, dv) or rows (dq) 4 r4 .. 4 r4 + 3
  const int c4 = tid & 15;        // products: columns 4 c4 + 64 m
  const int half = tid >> 7;      // S (0) or dP (1): warp-uniform
  const int g = (tid >> 4) & 7;   // S and dP: rows 8g .. 8g + 7
  const int c = tid & 15;         // S and dP: keys c + 16 j

  if (steps > 0) {
    load_rows<DK, KP>(ks, kh, t0, p.T, p.D);
    load_rows<DV, VP>(vs, vh, t0, p.T, p.Dv);
    load_step(0, 0);
  }
  for (int64_t n = 0; n < steps; ++n) {
    const int st = STAGES == 2 ? static_cast<int>(n & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // step n's tiles (the first time K and V too) are in shared memory,
                      // and every thread is done with step n - 1's
    if (STAGES == 2 && n + 1 < steps) load_step(n + 1, st ^ 1);
    const int64_t hq = b * p.Hq + kvh * p.rep + n / nq, s0 = (qt_lo + n % nq) * kTile;
    const float* qt = qs + st * kTile * DK;
    const float* dot = dos + st * kTile * DV;
    const float* lse_t = lse_s + st * kTile;
    const float* delta_t = delta_s + st * kTile;
    // whether some pair of the tile is masked (block-uniform)
    const bool edge = s0 + kTile > p.S || t0 + kTile > p.T ||
                      (p.causal && t0 + kTile - 1 > s0 + shift) ||
                      (p.has_window && t0 <= s0 + kTile - 1 + shift - p.window);

    // ---- S = q k^T (warps 0-3) and dP = do v^T (warps 4-7)
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    if (half == 0)
      micro_abt<DK, DK, KP>(acc, qt + 8 * g * DK, ks, c);
    else
      micro_abt<DV, DV, VP>(acc, dot + 8 * g * DV, vs, c);
    if (half == 0) {  // P, 0 where masked
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = 8 * g + i;
        const float l = lse_t[row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = c + 16 * j;
          float sv = acc[i][j] * p.scale_log2;
          if (edge && !visible(p, s0 + row, t0 + key)) sv = -INFINITY;
          ps[row * kTile + key] = exp2f(sv - l);  // exp2(-inf) = 0; a keyless row's lse is +inf
        }
      }
    }
    __syncthreads();  // P is whole
    if (half == 1) {  // dS = P o (dP - delta)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = 8 * g + i;
        const float dl = delta_t[row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = row * kTile + c + 16 * j;
          dss[at] = ps[at] * (acc[i][j] - dl);
        }
      }
    }
    __syncthreads();  // dS is whole

    // ---- dv += P^T do, dk += dS^T q: keys 4 r4 + a, columns 4 c4 + 64 m
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + i * kTile + 4 * r4);
      const float4 da = *reinterpret_cast<const float4*>(dss + i * kTile + 4 * r4);
#pragma unroll
      for (int m = 0; m < MV; ++m) {
        const float4 x = *reinterpret_cast<const float4*>(dot + i * DV + 4 * c4 + 64 * m);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float w = at4(pa, a);
          dva[a][4 * m] = fmaf(w, x.x, dva[a][4 * m]);
          dva[a][4 * m + 1] = fmaf(w, x.y, dva[a][4 * m + 1]);
          dva[a][4 * m + 2] = fmaf(w, x.z, dva[a][4 * m + 2]);
          dva[a][4 * m + 3] = fmaf(w, x.w, dva[a][4 * m + 3]);
        }
      }
#pragma unroll
      for (int m = 0; m < MK; ++m) {
        const float4 x = *reinterpret_cast<const float4*>(qt + i * DK + 4 * c4 + 64 * m);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float w = at4(da, a);
          dka[a][4 * m] = fmaf(w, x.x, dka[a][4 * m]);
          dka[a][4 * m + 1] = fmaf(w, x.y, dka[a][4 * m + 1]);
          dka[a][4 * m + 2] = fmaf(w, x.z, dka[a][4 * m + 2]);
          dka[a][4 * m + 3] = fmaf(w, x.w, dka[a][4 * m + 3]);
        }
      }
    }

    // ---- dq's part dS k: rows 4 r4 + a, columns 4 c4 + 64 m, four keys at a time
    float dqa[4][4 * MK];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4 * MK; ++e) dqa[a][e] = 0.0f;
#pragma unroll 2
    for (int j0 = 0; j0 < kTile; j0 += 4) {
      float4 dsr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        dsr[a] = *reinterpret_cast<const float4*>(dss + (4 * r4 + a) * kTile + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int m = 0; m < MK; ++m) {
          const float4 x = *reinterpret_cast<const float4*>(ks + (j0 + jj) * KP + 4 * c4 + 64 * m);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float w = at4(dsr[a], jj);
            dqa[a][4 * m] = fmaf(w, x.x, dqa[a][4 * m]);
            dqa[a][4 * m + 1] = fmaf(w, x.y, dqa[a][4 * m + 1]);
            dqa[a][4 * m + 2] = fmaf(w, x.z, dqa[a][4 * m + 2]);
            dqa[a][4 * m + 3] = fmaf(w, x.w, dqa[a][4 * m + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int64_t row = s0 + 4 * r4 + a;
      if (row >= p.S) continue;
      float* dst = p.dq + (hq * p.S + row) * p.D;
#pragma unroll
      for (int m = 0; m < MK; ++m) {
        const int col = 4 * c4 + 64 * m;
        if (col < p.D)
          red_add4(dst + col, make_float4(dqa[a][4 * m] * p.scale, dqa[a][4 * m + 1] * p.scale,
                                          dqa[a][4 * m + 2] * p.scale,
                                          dqa[a][4 * m + 3] * p.scale));
      }
    }
    if (STAGES == 1 && n + 1 < steps) {
      __syncthreads();  // every thread is done with this step's tiles
      load_step(n + 1, 0);
    }
  }

  // ---- dk (times scale) and dv, written once
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t t = t0 + 4 * r4 + a;
    if (t >= p.T) continue;
#pragma unroll
    for (int m = 0; m < MK; ++m) {
      const int col = 4 * c4 + 64 * m;
      if (col < p.D)
        *reinterpret_cast<float4*>(p.dk + (bh * p.T + t) * p.D + col) =
            make_float4(dka[a][4 * m] * p.scale, dka[a][4 * m + 1] * p.scale,
                        dka[a][4 * m + 2] * p.scale, dka[a][4 * m + 3] * p.scale);
    }
#pragma unroll
    for (int m = 0; m < MV; ++m) {
      const int col = 4 * c4 + 64 * m;
      if (col < p.Dv)
        *reinterpret_cast<float4*>(p.dv + (bh * p.T + t) * p.Dv + col) =
            make_float4(dva[a][4 * m], dva[a][4 * m + 1], dva[a][4 * m + 2], dva[a][4 * m + 3]);
    }
  }
}

template <int DK, int DV, int STAGES, int BLOCKS>
int launch_main(const Params& p, int64_t B, cudaStream_t s) {
  constexpr size_t smem = main_smem<DK, DV, STAGES>();
  // an SM's 228 KB hold BLOCKS blocks, each with 1 KB the system keeps
  static_assert(smem <= kMaxSmem && BLOCKS * (smem + 1024) <= kSmemPerSm,
                "the backward's shared memory");
  auto kernel = attention_bwd_f32_kernel<DK, DV, STAGES, BLOCKS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t heads = B * p.Hkv, blocks = heads * ((p.T + kTile - 1) / kTile);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, s>>>(p, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the two kernels on `stream` in order and returns a CUDA error code as an int
// (0 = success).  q, k, v, o, dout, dq, dk, dv are device pointers to contiguous float32
// tensors, 16-byte aligned; lse is the forward's float32 [B, Hq, S] and delta float32
// scratch of B * Hq * S words.  The caller has checked the shapes (Hq % Hkv == 0, D and Dv
// multiples of 8, 8 <= Dv <= D <= 192, Dv <= 128, S and T at least 1).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, void* dq, void* dk,
                                          void* dv, const float* lse, float* delta, int64_t B,
                                          int64_t Hq, int64_t Hkv, int64_t S, int64_t T,
                                          int64_t D, int64_t Dv, int32_t causal,
                                          int32_t has_window, int64_t window, float scale,
                                          void* stream) {
  if (B <= 0 || S <= 0 || T <= 0) return 0;
  if (D > 192 || D % 8 || Dv % 8 || Dv < 8 || Dv > D || Dv > 128 || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  // 1. delta and the zeroed dq
  const int64_t rows = B * Hq * S, blocks = (rows * 16 + 255) / 256;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  attention_bwd_f32_delta_kernel<<<static_cast<unsigned int>(blocks), 256, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta,
      static_cast<float*>(dq), rows, D, Dv);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // 2. dk, dv and dq's parts
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
                 static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                 Hq, Hkv, S, T, D, Dv, Hq / Hkv, causal, has_window, window, scale,
                 scale * kLog2e};
  if (D <= 64) return launch_main<64, 64, 1, 2>(p, B, s);
  if (D <= 128) return launch_main<128, 128, 2, 1>(p, B, s);
  return launch_main<192, 128, 1, 1>(p, B, s);
}
