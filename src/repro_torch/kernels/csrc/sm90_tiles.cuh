// Hopper tile helpers of K4's two bfloat16 kernels: flash_attention_sm90.cu (the forward)
// and flash_attention_bwd_sm90.cu (the backward) include this header, so both lay out
// their tiles, describe them to wgmma and load them by TMA through one tested code path.
//
// Layout.  A tile of `rows` rows and DP padded columns lies in column chunks of 64 columns
// and a last one of 64, 32 or 16; each chunk holds the tile's rows at 128, 64 or 32 bytes a
// row with the matching TMA and wgmma swizzle (128B, 64B or 32B), so a TMA box row is a
// whole chunk row.  A chunk is 1024-byte aligned: the swizzle pattern repeats every 1024
// bytes of the shared address.
//
// wgmma.  wgmma_ss: D (+)= A B with both operands K-major in shared memory (A a tile's
// rows, B another tile's rows); wgmma_ss_tt: both MN-major (A's M and B's N contiguous: a
// tile read transposed); wgmma_rs: D += A B with A from registers (4 x bf16x2 a thread)
// and B MN-major.  The accumulator of an m64nN product holds N / 2 floats a thread:
// element e = 4 i + 2 h + x is row 16 warp + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + x.
#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types; the function itself is
                   // found through the runtime, so the library needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBoxRows = 64;             // the rows of a TMA box: a tile's rows or keys
constexpr int kTensorMapError = 100000;  // + CUresult: the launch code of a failed tensor map

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading- and stride-dimension
// byte offsets (in 16-byte units) and the swizzle (1: 128B, 2: 64B, 3: 32B).  The stride
// offset is the distance between 8-row (K-major) or 8-key (MN-major) groups; the leading
// offset is not read while an operand's K (K-major) or M / N (MN-major) extent stays inside
// one swizzled row, as it does here
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((sbo & 0x3ffff) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// the column chunks of a tile with DP padded columns: every chunk but the last holds 64
// columns, the last the rest (64, 32 or 16); a chunk of w columns has rows of 2 w bytes
template <int DP>
struct Chunks {
  static constexpr int n = (DP + 63) / 64;
  __host__ __device__ static constexpr int width(int c) { return c < n - 1 ? 64 : DP - 64 * c; }
  // byte offset of chunk c in a tile of `rows` rows (1024-byte aligned)
  __host__ __device__ static constexpr uint32_t offset(int c, int rows) {
    return static_cast<uint32_t>(c) * rows * 128u;
  }
};
__host__ __device__ constexpr int swizzle_layout(int w) { return w == 64 ? 1 : w == 32 ? 2 : 3; }
// the TMA / wgmma swizzle of a chunk with rows of 2 w bytes: 16-byte unit bits [4, 7)
// XOR address bits [7, 10), as many bits as the row has units
__device__ __forceinline__ uint32_t swizzle(uint32_t a, int w) {
  const uint32_t mask = w == 64 ? 7u : w == 32 ? 3u : 1u;
  return a ^ (((a >> 7) & mask) << 4);
}
// byte offset of the 16-byte unit u (columns 8 u ... 8 u + 7) of row r in a tile
template <int DP>
__device__ __forceinline__ uint32_t unit_offset(int r, int u, int rows) {
  const int c = u / 8;
  const int w = Chunks<DP>::width(c);
  return Chunks<DP>::offset(c, rows) + swizzle(r * w * 2 + (u - 8 * c) * 16, w);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of wgmma operands across the fence and
// the wait: every access of d before this point happens before it
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the rows row0 ... row0 + 63 of head `head` into a tile at dst, one TMA box a column
// chunk ({chunk width, 64 rows, 1 head} at column 64 c); maps[c] is chunk c's map
template <int DP>
__device__ __forceinline__ void load_chunks(uint32_t dst, const CUtensorMap* maps, uint32_t bar,
                                            int row0, int head) {
#pragma unroll
  for (int c = 0; c < Chunks<DP>::n; ++c)
    tma_load_3d(dst + Chunks<DP>::offset(c, kBoxRows), &maps[c], bar, 64 * c, row0, head);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, c) as the bf16 pair hi and the bf16 pair of what hi leaves, lo = (a, c) - hi: the
// two halves of a float operand of a bfloat16 product, hi + lo within 2^-16 of it
__device__ __forceinline__ void split_bf16x2(float a, float c, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
  const float2 hf = __bfloat1622float2(h);
  *hi = bf16x2_bits(h);
  *lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
}

// Inline PTX names every accumulator register, so each shape is written out.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_tt64(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a 3-D tensor map over the first L rows of each head of a contiguous [heads, T, D]
// bfloat16 tensor: boxes of {w columns, kBoxRows rows, 1 head} with the swizzle of a
// 2 w-byte row; zero fill past L and past D, so no row r >= L is read
int tensor_map(CUtensorMap* map, const void* base, int64_t heads, int64_t T, int64_t L,
               int64_t D, int w) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D * 2),
                                 static_cast<cuuint64_t>(T * D * 2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(w), kBoxRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// the n maps of a tensor's column chunks of DP padded columns (a map past the tensor's
// last chunk, never read, maps chunk 0 again)
template <int DP>
int chunk_maps(CUtensorMap* maps, int n, const void* base, int64_t heads, int64_t T, int64_t L,
               int64_t D) {
  for (int c = 0; c < n; ++c) {
    const int rc = tensor_map(&maps[c], base, heads, T, L, D,
                              Chunks<DP>::width(c < Chunks<DP>::n ? c : 0));
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace
