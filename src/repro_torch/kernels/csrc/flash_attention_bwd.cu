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
// o [B, Hq, S, Dv] and its gradient do (all float32; Hq a multiple of Hkv; 8 <= Dv <= D <=
// 192, Dv <= 128), with P the softmax of scale q k^T over the keys the masks keep (query
// positions right-aligned to the T keys, qpos = s + T - S; causal keeps t <= qpos, a window
// keeps t > qpos - window):
//     delta = rowsum(do o o),  dv = P^T do,  ds = P o (do v^T - delta),
//     dq = scale ds k,  dk = scale ds^T q,
// with dk and dv summed over the Hq / Hkv q heads of each kv head.  A row that keeps no key
// has P = 0 and no gradient.  Everything accumulates in float32.  Every key exists
// (kv_len = T): the wrapper refuses a backward through a call over a prefix.
//
// Bound on an H100: five products (q k^T recomputed, do v^T, P^T do, dS k, dS^T q), 2 pairs
// (3 D + 2 Dv) Hq B operations (pairs: the (query, key) pairs the masks keep) at the 67
// TFLOP/s of float32 outside the tensor cores; at training shapes it is bound by
// operations.  This design does eight products (the logits three times: in each launch).
//
// Design: FlashAttention-2's first backward, with no atomics, in three launches from one
// launch function.  All three tile 64 query rows by 64 keys and hold their tiles in shared
// memory as float32, rows padded by one float so that 16 lanes reading 16 rows at one column
// hit 16 banks; 256 threads, thread (r, c) = (t / 16, t % 16) owning the 4 x 4 micro-tile of
// rows 4r .. 4r + 3 and columns c, c + 16, c + 32, c + 48 of a 64 x 64 product.
//   1. preprocess, a block for each (b, q head, query tile): the rows' log-sum-exp in base 2
//      (lse, recomputed over the visible key tiles with a running max: the float32 forward
//      keeps none, and the serving paths' kernels stay as they are) and delta, into float32
//      scratch [B, Hq, S]; +inf for a row with no key, so that its P is exp2(-inf) = 0.
//   2. dk/dv, a block for each (b, kv head, key tile), looping over the group's q heads and
//      the query tiles the masks let see the tile: S = q k^T and dP = do v^T as 4 x 4
//      micro-tiles, P and dS into shared memory, then dv += P^T do and dk += dS^T q into
//      register accumulators, each thread 4 key rows by the columns c + 16 m.  The block
//      owns its key tile's dk and dv, so each is written once, with no atomics.
//   3. dq, a block for each (b, q head, query tile), looping over the key tiles the masks
//      let it see: S, dP and dS as in 2, dq += dS k in registers.
// The widths are template parameters, the smallest of (64, 64), (128, 128) and (192, 128)
// that covers (D, Dv), zero-filled past D and Dv.  Shared memory (float32): 2 x 64 x (DK + 1)
// + 2 x 64 x (DV + 1) + 2 x 64 x 65 + 128 words: 100,352 bytes at (64, 64) (two blocks an
// SM), 165,888 at (128, 128), 198,656 at (192, 128) (one block an SM).  It serves the
// float32 checks of training (phase 4k's gradients at 2 layers, the card tests).
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // query rows and keys of a tile
constexpr int kPadS = kTile + 1;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // [B, Hq, S]: base-2 log-sum-exp of scale_log2 * q k^T, +inf without a key
  float* delta;  // [B, Hq, S]: rowsum(do o o)
  int64_t Hq, Hkv, S, T, D, Dv, rep;
  int32_t causal, has_window;
  int64_t window;
  float scale, scale_log2;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// whether query position qpos sees key t
__device__ __forceinline__ bool visible(const Params& p, int64_t qpos, int64_t t) {
  return t < p.T && (!p.causal || t <= qpos) && (!p.has_window || t > qpos - p.window);
}

// dst[r * P + c] = the row (row0 + r) of a head's [rows, width] matrix, zero past its rows
// and past width (c < W)
template <int W, int P>
__device__ __forceinline__ void load_tile(float* dst, const float* head, int64_t row0,
                                          int64_t rows, int64_t width) {
  for (int i = threadIdx.x; i < kTile * W; i += kThreads) {
    const int r = i / W, c = i - r * W;
    const int64_t row = row0 + r;
    dst[r * P + c] = row < rows && c < width ? head[row * width + c] : 0.0f;
  }
}

// acc[a][j] += sum_c A[4 r + a][c] B[cb + 16 j][c] over c < W: the 4 x 4 micro-tile of A B^T
template <int W, int P>
__device__ __forceinline__ void micro_abt(float (&acc)[4][4], const float* A, const float* Bm,
                                          int r, int cb) {
#pragma unroll 4
  for (int c = 0; c < W; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * r + i) * P + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(cb + 16 * j) * P + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The key tiles [k_lo, k_hi) some row of the query tile at s0 can see
__device__ __forceinline__ void key_tiles(const Params& p, int64_t s0, int64_t* k_lo,
                                          int64_t* k_hi) {
  const int64_t s1 = min64(s0 + kTile, p.S) - 1;
  const int64_t qlo = s0 + p.T - p.S, qhi = s1 + p.T - p.S;
  int64_t lo = 0, hi = p.T;                       // keys [lo, hi)
  if (p.causal) hi = min64(hi, qhi + 1);
  if (p.has_window) lo = max64(lo, qlo - p.window + 1);
  *k_lo = lo < hi ? lo / kTile : 0;
  *k_hi = lo < hi ? (hi + kTile - 1) / kTile : 0;
}

// The logits of the (query tile s0 of head h, key tile t0) micro-tile in base 2, -inf where
// masked: s[a][j] for row 4r + a and key cb + 16 j
__device__ __forceinline__ void mask_logits(const Params& p, float (&s)[4][4], int64_t s0,
                                            int64_t t0, int r, int cb) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t row = s0 + 4 * r + a;
    const int64_t qpos = row + p.T - p.S;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = row < p.S && visible(p, qpos, t0 + cb + 16 * j);
      s[a][j] = ok ? s[a][j] * p.scale_log2 : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------- 1. lse and delta

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_pre_kernel(const Params p, int64_t q_tiles) {
  constexpr int PK = DK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                   // [64][PK]
  float* ks = qs + kTile * PK;        // [64][PK]
  const int64_t tile = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int64_t b = bh / p.Hq, h = bh % p.Hq, kvh = h / p.rep;
  const int64_t s0 = tile * kTile;
  const int r = threadIdx.x / 16, cb = threadIdx.x % 16;
  const float* qh = static_cast<const float*>(p.q) + bh * p.S * p.D;
  const float* kh = static_cast<const float*>(p.k) + (b * p.Hkv + kvh) * p.T * p.D;
  load_tile<DK, PK>(qs, qh, s0, p.S, p.D);
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) m[a] = -INFINITY, l[a] = 0.0f;
  int64_t k_lo, k_hi;
  key_tiles(p, s0, &k_lo, &k_hi);
  for (int64_t kt = k_lo; kt < k_hi; ++kt) {
    __syncthreads();  // the last tile's keys are read
    load_tile<DK, PK>(ks, kh, kt * kTile, p.T, p.D);
    __syncthreads();
    float s[4][4] = {};
    micro_abt<DK, PK>(s, qs, ks, r, cb);
    mask_logits(p, s, s0, kt * kTile, r, cb);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mt = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float mn = fmaxf(m[a], mt);
      if (mn == -INFINITY) continue;  // the row has seen no key yet (the lanes agree)
      const float alpha = m[a] == -INFINITY ? 0.0f : exp2f(m[a] - mn);
      float add = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) add += exp2f(s[a][j] - mn);  // exp2(-inf) = 0
      l[a] = l[a] * alpha + add;
      m[a] = mn;
    }
  }
  const float* oh = static_cast<const float*>(p.o) + bh * p.S * p.Dv;
  const float* dh = static_cast<const float*>(p.dout) + bh * p.S * p.Dv;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float sum = l[a], dl = 0.0f;
    const int64_t row = s0 + 4 * r + a;
    if (row < p.S) {
      for (int64_t c = cb; c < p.Dv; c += 16)
        dl += oh[row * p.Dv + c] * dh[row * p.Dv + c];
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      dl += __shfl_xor_sync(0xffffffffu, dl, o);
    }
    if (cb == 0 && row < p.S) {
      p.lse[bh * p.S + row] = sum > 0.0f ? m[a] + log2f(sum) : INFINITY;
      p.delta[bh * p.S + row] = dl;
    }
  }
}

// ---------------------------------------------------------------- 2. dk and dv

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_kernel(const Params p, int64_t k_tiles) {
  constexpr int PK = DK + 1, PV = DV + 1, MK = DK / 16, MV = DV / 16;
  extern __shared__ float smem[];
  float* ks = smem;                    // [64][PK] this block's keys
  float* vs = ks + kTile * PK;         // [64][PV]
  float* qs = vs + kTile * PV;         // [64][PK] a query tile
  float* dos = qs + kTile * PK;        // [64][PV]
  float* ps = dos + kTile * PV;        // [64 rows][65] P
  float* dss = ps + kTile * kPadS;     // [64 rows][65] dS
  float* lse_s = dss + kTile * kPadS;  // [64]
  float* delta_s = lse_s + kTile;      // [64]
  const int64_t tile = blockIdx.x % k_tiles, bh = blockIdx.x / k_tiles;
  const int64_t b = bh / p.Hkv, kvh = bh % p.Hkv;
  const int64_t t0 = tile * kTile;
  const int r = threadIdx.x / 16, cb = threadIdx.x % 16;
  const float* kh = static_cast<const float*>(p.k) + bh * p.T * p.D;
  const float* vh = static_cast<const float*>(p.v) + bh * p.T * p.Dv;
  load_tile<DK, PK>(ks, kh, t0, p.T, p.D);
  load_tile<DV, PV>(vs, vh, t0, p.T, p.Dv);
  float dk[4][MK] = {}, dv[4][MV] = {};
  // the query rows that see a key of [t0, t1]: causal needs qpos >= t0, a window qpos < t1 + window
  const int64_t t1 = min64(t0 + kTile, p.T) - 1;
  int64_t s_lo = 0, s_hi = p.S - 1;
  if (p.causal) s_lo = max64(s_lo, t0 - (p.T - p.S));
  if (p.has_window) s_hi = min64(s_hi, t1 + p.window - 1 - (p.T - p.S));
  for (int64_t g = 0; g < p.rep && s_lo <= s_hi; ++g) {
    const int64_t hq = b * p.Hq + kvh * p.rep + g;
    const float* qh = static_cast<const float*>(p.q) + hq * p.S * p.D;
    const float* dh = static_cast<const float*>(p.dout) + hq * p.S * p.Dv;
    for (int64_t qt = s_lo / kTile; qt <= s_hi / kTile; ++qt) {
      const int64_t s0 = qt * kTile;
      __syncthreads();  // the last tile's q, do, P and dS are read
      load_tile<DK, PK>(qs, qh, s0, p.S, p.D);
      load_tile<DV, PV>(dos, dh, s0, p.S, p.Dv);
      if (threadIdx.x < kTile) {
        const int64_t row = s0 + threadIdx.x;
        lse_s[threadIdx.x] = row < p.S ? p.lse[hq * p.S + row] : INFINITY;
        delta_s[threadIdx.x] = row < p.S ? p.delta[hq * p.S + row] : 0.0f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      micro_abt<DK, PK>(s, qs, ks, r, cb);
      micro_abt<DV, PV>(dp, dos, vs, r, cb);
      mask_logits(p, s, s0, t0, r, cb);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * r + a;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pr = exp2f(s[a][j] - lse_s[i]);  // 0 where masked or keyless
          ps[i * kPadS + cb + 16 * j] = pr;
          dss[i * kPadS + cb + 16 * j] = pr * (dp[a][j] - delta_s[i]);
        }
      }
      __syncthreads();
      // dv[key 4r + a][cb + 16 m] += sum_i P[i][key] do[i][cb + 16 m]; dk likewise with dS, q
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        float pa[4], da[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = ps[i * kPadS + 4 * r + a];
          da[a] = dss[i * kPadS + 4 * r + a];
        }
#pragma unroll
        for (int mm = 0; mm < MV; ++mm) {
          const float x = dos[i * PV + cb + 16 * mm];
#pragma unroll
          for (int a = 0; a < 4; ++a) dv[a][mm] = fmaf(pa[a], x, dv[a][mm]);
        }
#pragma unroll
        for (int mm = 0; mm < MK; ++mm) {
          const float x = qs[i * PK + cb + 16 * mm];
#pragma unroll
          for (int a = 0; a < 4; ++a) dk[a][mm] = fmaf(da[a], x, dk[a][mm]);
        }
      }
    }
  }
  float* dkh = static_cast<float*>(p.dk) + bh * p.T * p.D;
  float* dvh = static_cast<float*>(p.dv) + bh * p.T * p.Dv;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t t = t0 + 4 * r + a;
    if (t >= p.T) continue;
#pragma unroll
    for (int mm = 0; mm < MK; ++mm) {
      const int64_t c = cb + 16 * mm;
      if (c < p.D) dkh[t * p.D + c] = dk[a][mm] * p.scale;
    }
#pragma unroll
    for (int mm = 0; mm < MV; ++mm) {
      const int64_t c = cb + 16 * mm;
      if (c < p.Dv) dvh[t * p.Dv + c] = dv[a][mm];
    }
  }
}

// ---------------------------------------------------------------- 3. dq

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const Params p, int64_t q_tiles) {
  constexpr int PK = DK + 1, PV = DV + 1, MK = DK / 16;
  extern __shared__ float smem[];
  float* qs = smem;                    // [64][PK] this block's queries
  float* dos = qs + kTile * PK;        // [64][PV]
  float* ks = dos + kTile * PV;        // [64][PK] a key tile
  float* vs = ks + kTile * PK;         // [64][PV]
  float* dss = vs + kTile * PV;        // [64 rows][65] dS
  float* lse_s = dss + kTile * kPadS;  // [64]
  float* delta_s = lse_s + kTile;      // [64]
  const int64_t tile = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int64_t b = bh / p.Hq, h = bh % p.Hq, kvh = h / p.rep;
  const int64_t s0 = tile * kTile;
  const int r = threadIdx.x / 16, cb = threadIdx.x % 16;
  const float* qh = static_cast<const float*>(p.q) + bh * p.S * p.D;
  const float* dh = static_cast<const float*>(p.dout) + bh * p.S * p.Dv;
  const float* kh = static_cast<const float*>(p.k) + (b * p.Hkv + kvh) * p.T * p.D;
  const float* vh = static_cast<const float*>(p.v) + (b * p.Hkv + kvh) * p.T * p.Dv;
  load_tile<DK, PK>(qs, qh, s0, p.S, p.D);
  load_tile<DV, PV>(dos, dh, s0, p.S, p.Dv);
  if (threadIdx.x < kTile) {
    const int64_t row = s0 + threadIdx.x;
    lse_s[threadIdx.x] = row < p.S ? p.lse[bh * p.S + row] : INFINITY;
    delta_s[threadIdx.x] = row < p.S ? p.delta[bh * p.S + row] : 0.0f;
  }
  float dq[4][MK] = {};
  int64_t k_lo, k_hi;
  key_tiles(p, s0, &k_lo, &k_hi);
  for (int64_t kt = k_lo; kt < k_hi; ++kt) {
    const int64_t t0 = kt * kTile;
    __syncthreads();  // the last tile's k, v and dS are read
    load_tile<DK, PK>(ks, kh, t0, p.T, p.D);
    load_tile<DV, PV>(vs, vh, t0, p.T, p.Dv);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    micro_abt<DK, PK>(s, qs, ks, r, cb);
    micro_abt<DV, PV>(dp, dos, vs, r, cb);
    mask_logits(p, s, s0, t0, r, cb);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * r + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = exp2f(s[a][j] - lse_s[i]);
        dss[i * kPadS + cb + 16 * j] = pr * (dp[a][j] - delta_s[i]);
      }
    }
    __syncthreads();
    // dq[row 4r + a][cb + 16 m] += sum_key dS[row][key] k[key][cb + 16 m]
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      float da[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = dss[(4 * r + a) * kPadS + key];
#pragma unroll
      for (int mm = 0; mm < MK; ++mm) {
        const float x = ks[key * PK + cb + 16 * mm];
#pragma unroll
        for (int a = 0; a < 4; ++a) dq[a][mm] = fmaf(da[a], x, dq[a][mm]);
      }
    }
  }
  float* dqh = static_cast<float*>(p.dq) + bh * p.S * p.D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t row = s0 + 4 * r + a;
    if (row >= p.S) continue;
#pragma unroll
    for (int mm = 0; mm < MK; ++mm) {
      const int64_t c = cb + 16 * mm;
      if (c < p.D) dqh[row * p.D + c] = dq[a][mm] * p.scale;
    }
  }
}

constexpr size_t pre_smem(int DK) { return static_cast<size_t>(2 * kTile * (DK + 1)) * 4; }
constexpr size_t main_smem(int DK, int DV) {
  return static_cast<size_t>(2 * kTile * (DK + 1) + 2 * kTile * (DV + 1) + 2 * kTile * kPadS +
                             2 * kTile) * 4;
}

template <typename K>
int launch_one(K kernel, int64_t blocks, size_t smem, const Params& p, int64_t tiles,
               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, s>>>(p, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int launch_all(const Params& p, int64_t B, cudaStream_t s) {
  static_assert(main_smem(DK, DV) <= kMaxSmem, "the backward's shared memory");
  const int64_t q_tiles = (p.S + kTile - 1) / kTile, k_tiles = (p.T + kTile - 1) / kTile;
  int rc = launch_one(attention_bwd_pre_kernel<DK, DV>, B * p.Hq * q_tiles, pre_smem(DK), p,
                      q_tiles, s);
  if (rc) return rc;
  rc = launch_one(attention_bwd_dkdv_kernel<DK, DV>, B * p.Hkv * k_tiles, main_smem(DK, DV),
                  p, k_tiles, s);
  if (rc) return rc;
  return launch_one(attention_bwd_dq_kernel<DK, DV>, B * p.Hq * q_tiles, main_smem(DK, DV), p,
                    q_tiles, s);
}

int launch_widths(const Params& p, int64_t B, cudaStream_t s) {
  if (p.D <= 64) return launch_all<64, 64>(p, B, s);
  if (p.D <= 128) return launch_all<128, 128>(p, B, s);
  return launch_all<192, 128>(p, B, s);
}

}  // namespace

// Launches the three kernels on `stream` in order and returns a CUDA error code as an int
// (0 = success).  q, k, v, o, dout, dq, dk, dv are device pointers to contiguous float32
// tensors; lse and delta are float32 scratch of B * Hq * S words.  The caller has checked
// the shapes (Hq % Hkv == 0, D and Dv multiples of 8, 8 <= Dv <= D <= 192, Dv <= 128, S and
// T at least 1).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, void* dq, void* dk,
                                          void* dv, float* lse, float* delta, int64_t B,
                                          int64_t Hq, int64_t Hkv, int64_t S, int64_t T,
                                          int64_t D, int64_t Dv, int32_t causal,
                                          int32_t has_window, int64_t window, float scale,
                                          void* stream) {
  if (B <= 0 || S <= 0 || T <= 0) return 0;
  if (D > 192 || Dv < 8 || Dv > D || Dv > 128 || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, dout, dq, dk, dv, lse, delta, Hq, Hkv, S, T, D, Dv, Hq / Hkv,
           causal, has_window, window, scale, scale * kLog2e};
  const auto s = static_cast<cudaStream_t>(stream);
  return launch_widths(p, B, s);
}
