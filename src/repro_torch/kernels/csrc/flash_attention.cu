// K4 flash_attention, float32: online-softmax attention with causal, sliding-window and GQA
// masks on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_pallas
// for float32 inputs, with the semantics of its wrapper repro.kernels.ops.flash_attention
// (the public kernel API).  bfloat16 inputs go to flash_attention_sm90.cu, on the tensor
// cores; float32 stays here because the tensor cores would run it as TF32, which cannot
// meet the float32 contract's 2e-5.
//
// Computes, for q [B, Hq, S, D] and k, v [B, Hkv, T, D] in float32 (Hq a multiple of
// Hkv), every query row (b, h, s) against kv head h / (Hq / Hkv):
//     out[b, h, s] = sum_t softmax_t(scale * q[b, h, s] . k[b, kvh, t]) v[b, kvh, t]
// over the keys t the masks keep.  Query positions are right-aligned to the keys,
// qpos = s + T - S (one kernel for training, chunked prefill and decode); causal keeps
// t <= qpos, a window keeps t > qpos - window (from below only, also without causal).  A
// row that keeps no key gives 0, as the TPU kernel's division by 1 when the sum is 0
// does.  Logits, the softmax and the output are accumulated in float32.
//
// Bound on an H100: 4 S T D Hq B operations (two products), halved for causal, against
// the 67 TFLOP/s of float32 outside the tensor cores, or the bytes of q, k, v and out:
// prefill is bound by operations, decode (S = 1) by the bytes of k and v.
//
// Design.  The TPU kernel runs a sequential grid (head, query block, key block) with the
// running max, sum and accumulator in VMEM scratch, carried from one key block to the
// next.  On the card the blocks run in parallel with nothing carried between them, so a
// block owns R query rows of one kv head (the rows of the Hq / Hkv q heads that share it,
// position-major, so one K/V tile serves all of them) and splits the keys across its
// four warps: warp w takes the 32-key chunks w, w + 4, ...; each warp keeps its own
// running max, sum and accumulator and the block merges the four at the end.  Inside a
// warp, lane j computes the R logits of key j (its K row staged in shared memory with
// one 16-byte pad per row, so the lanes' 16-byte reads do not collide), the warp takes
// the max, rescales, and then walks the 32 keys with each lane accumulating the columns
// lane, lane + 32, ... of every row (V staged beside K).  Decode (S = 1) has only Hq/Hkv
// rows a block, but still 128 threads that share its keys, not one.  Key chunks that no
// row of the block can see (past the causal end, before the window) are never loaded.
// Only the kv head index is computed for GQA: k and v are not copied per q head.
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;  // keys per warp chunk, one per lane
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t Hq, Hkv, S, T, D;
  int64_t rep;   // Hq / Hkv
  int64_t rows;  // rep * S query rows per (batch, kv head)
  int32_t causal, has_window;
  int64_t window;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// 16 bytes of elements -> float
__device__ __forceinline__ void unpack(const uint4 raw, float* f, float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

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

template <typename T, int R>
constexpr size_t smem_bytes(int64_t D) {
  // q rows (float) + probabilities (float) + K and V chunks of every warp (T, padded)
  return static_cast<size_t>(R * D) * 4 + static_cast<size_t>(kWarps * kKeys * R) * 4 +
         static_cast<size_t>(kWarps * 2 * kKeys) * (D + 16 / sizeof(T)) * sizeof(T);
}

// T: element type; R: query rows a block (a multiple of 4); C: head-dim columns a lane
// holds in the output accumulator (D <= 32 C)
template <typename T, int R, int C>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  constexpr int E = 16 / sizeof(T);  // elements in 16 bytes
  extern __shared__ float4 smem4[];
  const int64_t D = p.D;
  const int64_t DP = D + E;  // padded row of a K/V chunk
  float* q_s = reinterpret_cast<float*>(smem4);   // [R][D]
  float* p_s = q_s + R * D;                       // [kWarps][kKeys][R]
  T* kv_s = reinterpret_cast<T*>(p_s + kWarps * kKeys * R);  // [kWarps][2][kKeys][DP]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.z;
  const int64_t kvh = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
  const int64_t nr = min64(R, p.rows - r0);
  const T* q = static_cast<const T*>(p.q);
  const T* kb = static_cast<const T*>(p.k) + (b * p.Hkv + kvh) * p.T * D;
  const T* vb = static_cast<const T*>(p.v) + (b * p.Hkv + kvh) * p.T * D;

  // stage the block's query rows, scaled into the base-2 softmax; row r is position
  // (r0 + r) / rep of q head kvh * rep + (r0 + r) % rep
  for (int64_t e = threadIdx.x; e < R * D; e += kThreads) {
    const int64_t r = e / D, d = e - r * D;
    float val = 0.0f;
    if (r < nr) {
      const int64_t s = (r0 + r) / p.rep, g = (r0 + r) - s * p.rep;
      val = as_float(q[((b * p.Hq + kvh * p.rep + g) * p.S + s) * D + d]) * p.scale_log2;
    }
    q_s[e] = val;
  }

  // the keys some row of the block can see: [k_begin, k_end)
  const int64_t shift = p.T - p.S;
  const int64_t s_first = r0 / p.rep, s_last = (r0 + nr - 1) / p.rep;
  const int64_t k_end = p.causal ? min64(p.T, s_last + shift + 1) : p.T;
  const int64_t k_begin = p.has_window ? max64(0, s_first + shift - p.window + 1) : 0;
  int64_t qpos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) qpos[r] = (r0 + r) / p.rep + shift;
  __syncthreads();

  float m[R], l[R], o[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) o[r][c] = 0.0f;
  }
  T* ks = kv_s + warp * 2 * kKeys * DP;
  T* vs = ks + kKeys * DP;
  float* pw = p_s + warp * kKeys * R;
  const int64_t vecs = D / E;  // 16-byte vectors a row

  for (int64_t c0 = (k_begin / kKeys) * kKeys + warp * kKeys; c0 < k_end;
       c0 += kWarps * kKeys) {
    const int nk = static_cast<int>(min64(kKeys, k_end - c0));
    __syncwarp();  // the warp is done with the previous chunk
    // the chunk's K and V rows are contiguous in memory: 16 bytes a lane, coalesced;
    // rows past the end are zero, so no garbage reaches a product
    for (int64_t e = lane; e < kKeys * vecs; e += 32) {
      const int64_t j = e / vecs, dv = e - j * vecs;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (j < nk) {
        const int64_t off = (c0 + j) * D + dv * E;
        kk = __ldg(reinterpret_cast<const uint4*>(kb + off));
        vv = __ldg(reinterpret_cast<const uint4*>(vb + off));
      }
      *reinterpret_cast<uint4*>(ks + j * DP + dv * E) = kk;
      *reinterpret_cast<uint4*>(vs + j * DP + dv * E) = vv;
    }
    __syncwarp();

    // logits of key c0 + lane for every row (base 2, already scaled)
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    const T* krow = ks + lane * DP;
    for (int64_t d = 0; d < D; d += E) {
      float kf[E];
      unpack(*reinterpret_cast<const uint4*>(krow + d), kf, T());
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + r * D + d);
#pragma unroll
        for (int h = 0; h < E / 4; ++h) {
          const float4 qq = qv[h];
          s[r] += qq.x * kf[4 * h] + qq.y * kf[4 * h + 1] + qq.z * kf[4 * h + 2] +
                  qq.w * kf[4 * h + 3];
        }
      }
    }
    // online softmax, per row (warp-uniform branches)
    const int64_t key = c0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = r < nr && lane < nk && (!p.causal || key <= qpos[r]) &&
                      (!p.has_window || key > qpos[r] - p.window);
      const float sr = ok ? s[r] : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(sr));
      float pr = 0.0f, alpha = 1.0f;
      if (mn != -INFINITY) {
        pr = exp2f(sr - mn);
        alpha = exp2f(m[r] - mn);
      }
      m[r] = mn;
      l[r] = l[r] * alpha + pr;
#pragma unroll
      for (int c = 0; c < C; ++c) o[r][c] *= alpha;
      pw[lane * R + r] = pr;
    }
    __syncwarp();
    // o[r] += sum_j p[j, r] v[j]; lane holds columns lane + 32 c
    for (int j = 0; j < nk; ++j) {
      float pj[R];
#pragma unroll
      for (int r4 = 0; r4 < R / 4; ++r4) {
        const float4 pp = reinterpret_cast<const float4*>(pw + j * R)[r4];
        pj[4 * r4] = pp.x;
        pj[4 * r4 + 1] = pp.y;
        pj[4 * r4 + 2] = pp.z;
        pj[4 * r4 + 3] = pp.w;
      }
      const T* vrow = vs + j * DP;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int64_t d = lane + 32 * c;
        const float vf = d < D ? as_float(vrow[d]) : 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) o[r][c] += pj[r] * vf;
      }
    }
  }

  // merge the warps' partial results; the K/V area is reused for them
#pragma unroll
  for (int r = 0; r < R; ++r) l[r] = warp_sum(l[r]);
  __syncthreads();
  float* o_part = reinterpret_cast<float*>(kv_s);  // [kWarps][R][D]
  float* m_part = o_part + kWarps * R * D;         // [kWarps][R]
  float* l_part = m_part + kWarps * R;             // [kWarps][R]
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t d = lane + 32 * c;
      if (d < D) o_part[(warp * R + r) * D + d] = o[r][c];
    }
    if (lane == 0) {
      m_part[warp * R + r] = m[r];
      l_part[warp * R + r] = l[r];
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  for (int64_t e = threadIdx.x; e < nr * D; e += kThreads) {
    const int64_t r = e / D, d = e - r * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_part[w * R + r]);
    float val = 0.0f;
    if (mx != -INFINITY) {
      float num = 0.0f, den = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = m_part[w * R + r];
        if (mw == -INFINITY) continue;
        const float sc = exp2f(mw - mx);
        den += sc * l_part[w * R + r];
        num += sc * o_part[(w * R + r) * D + d];
      }
      val = den > 0.0f ? num / den : 0.0f;
    }
    const int64_t s = (r0 + r) / p.rep, g = (r0 + r) - s * p.rep;
    store(out + ((b * p.Hq + kvh * p.rep + g) * p.S + s) * D + d, val);
  }
}

template <typename T, int R, int C>
int launch(const Params& p, int64_t B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, R>(p.D);
  auto kernel = flash_attention_kernel<T, R, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (p.rows + R - 1) / R;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned int>(blocks), static_cast<unsigned int>(p.Hkv),
                  static_cast<unsigned int>(B));
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R>
int launch_r(const Params& p, int64_t B, cudaStream_t stream) {
  switch ((p.D + 31) / 32) {
    case 1: return launch<T, R, 1>(p, B, stream);
    case 2: return launch<T, R, 2>(p, B, stream);
    case 3: return launch<T, R, 3>(p, B, stream);
    case 4: return launch<T, R, 4>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_t(const Params& p, int64_t B, cudaStream_t stream) {
  // decode and other short rows: 4 rows a block, so little of the block is idle
  return p.rows <= 4 ? launch_r<T, 4>(p, B, stream) : launch_r<T, 8>(p, B, stream);
}

}  // namespace

// Launches on `stream` and returns a CUDA error code as an int (0 = success).  All
// pointers are device pointers to contiguous float32 tensors; the caller has checked the shapes (Hq % Hkv == 0,
// D % 8 == 0, 8 <= D <= 128, B and Hkv at most 65,535, S and T at least 1).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int64_t B, int64_t Hq, int64_t Hkv,
                                      int64_t S, int64_t T, int64_t D, int32_t causal,
                                      int32_t has_window, int64_t window, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  Params p{q, k, v, out, Hq, Hkv, S, T, D, Hq / Hkv, (Hq / Hkv) * S,
           causal, has_window, window, scale * kLog2e};
  const auto s = static_cast<cudaStream_t>(stream);
  return launch_t<float>(p, B, s);
}
