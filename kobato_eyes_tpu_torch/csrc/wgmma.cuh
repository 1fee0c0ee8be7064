// Hopper building blocks shared by the tensor-core attention kernels
// (head_resident_attention.cu, flash_attention.cu): cp.async copies,
// swizzled bf16 tiles in shared memory, their wgmma descriptors and the
// wgmma instructions themselves (sm_90a).
//
// A tile holds ROWS rows of D16 bf16 columns (D16 a multiple of 16, up to
// 128), split into column blocks W columns wide, W the widest of 64, 32 and
// 16 that divides D16: each block is ROWS rows of 2W bytes in the 128-, 64-
// or 32-byte swizzle, one swizzle atom wide, so a descriptor needs no
// leading byte offset. The same bytes serve as a K-major operand (the row is
// the reduction axis: Q, K, V, dO in S = Q K^T and dP = dO V^T) and as an
// MN-major one (rows are the reduction axis: V in O += P V, dO, Q and K in
// the gradient products), a block of W output columns an instruction.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy of which the first `bytes` (0 .. 16) are read;
// the rest of the 16 is zero-filled
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// make this thread's shared-memory writes visible to wgmma's operand reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Byte offset of 16-byte chunk `chunk` of row `row` in rows ROW_BYTES long
// (128, 64 or 32: one swizzle span) stored in that swizzle; the base is
// 1024-byte aligned.
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  const int x = ROW_BYTES == 128 ? (row & 7) : ROW_BYTES == 64 ? ((row >> 1) & 3) : ((row >> 2) & 1);
  return (uint32_t)(row * ROW_BYTES + ((chunk ^ x) << 4));
}

// Shared-memory matrix descriptor of rows ROW_BYTES long: eight rows make a
// swizzle atom, atoms follow each other every 8 * ROW_BYTES (the stride byte
// offset). One atom wide, so the leading byte offset is not used.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)((8 * ROW_BYTES) >> 4) << 32;
  d |= (uint64_t)(ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3) << 62;
  return d;
}

template <int D16, int ROWS>
struct SwTile {
  static_assert(D16 % 16 == 0 && D16 >= 16 && D16 <= 128, "D16: a multiple of 16 up to 128");
  static constexpr int W = D16 % 64 == 0 ? 64 : D16 % 32 == 0 ? 32 : 16;  // columns a block
  static constexpr int kRowBytes = 2 * W;
  static constexpr int kBlocks = D16 / W;
  static constexpr int kBlockBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kBlocks * kBlockBytes;
  static constexpr int kChunks = D16 / 8;  // 16-byte chunks of a row

  // byte offset of 16-byte chunk `chunk` (0 .. kChunks - 1) of row `row`
  __device__ __forceinline__ static uint32_t offset(int row, int chunk) {
    return (uint32_t)((chunk / (W / 8)) * kBlockBytes) + swizzled<kRowBytes>(row, chunk % (W / 8));
  }
  // The descriptor of the tile at `base` (1024-byte aligned), and what to add
  // to it (the address field counts 16-byte units) for an operand: K-major,
  // reduction columns 16 kk .. 16 kk + 15; MN-major, reduction rows 16 kk ..
  // 16 kk + 15 of column block nb. Constants once kk and nb are.
  __device__ __forceinline__ static uint64_t desc(uint32_t base) { return make_desc<kRowBytes>(base); }
  __host__ __device__ static constexpr uint64_t kmajor(int kk) {
    return (uint64_t)(((16 * kk / W) * kBlockBytes + (16 * kk) % W * 2) >> 4);
  }
  __host__ __device__ static constexpr uint64_t mnmajor(int nb, int kk) {
    return (uint64_t)((nb * kBlockBytes + 16 * kk * kRowBytes) >> 4);
  }
};

// Rows r0 .. r0 + ROWS - 1 of a (len, d) bf16 view with row stride `st`
// (16-byte aligned rows) into a tile, by cp.async: rows past len and columns
// past d are zero-filled. FULL: d == D16, so every chunk of a row is whole
// and no column is tested (a test at run time costs kernel 1 about 2% at
// D = 64 on an H100). `tid` of `n_threads` copy. With a second source and tile (the same rows of a view
// with the same strides), both. Mind the loop's form: with a branch in it,
// or with the source offset zeroed for a row past len, ptxas serialised every
// wgmma of kernel 1 (its C7520 advisory; 13% slower on an H100).
template <int D16, int ROWS, bool FULL, int N>
__device__ __forceinline__ void load_tiles_async(const uint32_t (&dst)[N], const bf16* const (&src)[N], int r0,
                                                 int len, int d, long long st, int tid, int n_threads) {
  using L = SwTile<D16, ROWS>;
  for (int i = tid; i < ROWS * L::kChunks; i += n_threads) {
    const int r = i / L::kChunks, c = i % L::kChunks;
    const bool ok = r0 + r < len && (FULL || 8 * c < d);
    const int bytes = ok ? (FULL ? 16 : min(16, 2 * (d - 8 * c))) : 0;
    const long long off = (long long)(ok ? r0 + r : 0) * st + 8 * c;
    const uint32_t o = L::offset(r, c);
#pragma unroll
    for (int t = 0; t < N; ++t) cp_async_16(dst[t] + o, src[t] + off, bytes);
  }
}

template <int D16, int ROWS, bool FULL>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src, int r0, int len, int d,
                                                long long st, int tid, int n_threads) {
  const uint32_t dsts[1] = {dst};
  const bf16* const srcs[1] = {src};
  load_tiles_async<D16, ROWS, FULL>(dsts, srcs, r0, len, d, st, tid, n_threads);
}

#define KET_D32(x) "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3]), "+f"(x[4]), "+f"(x[5]), "+f"(x[6]), \
    "+f"(x[7]), "+f"(x[8]), "+f"(x[9]), "+f"(x[10]), "+f"(x[11]), "+f"(x[12]), "+f"(x[13]),            \
    "+f"(x[14]), "+f"(x[15]), "+f"(x[16]), "+f"(x[17]), "+f"(x[18]), "+f"(x[19]), "+f"(x[20]),         \
    "+f"(x[21]), "+f"(x[22]), "+f"(x[23]), "+f"(x[24]), "+f"(x[25]), "+f"(x[26]), "+f"(x[27]),         \
    "+f"(x[28]), "+f"(x[29]), "+f"(x[30]), "+f"(x[31])
#define KET_D16(x) "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3]), "+f"(x[4]), "+f"(x[5]), "+f"(x[6]), \
    "+f"(x[7]), "+f"(x[8]), "+f"(x[9]), "+f"(x[10]), "+f"(x[11]), "+f"(x[12]), "+f"(x[13]),            \
    "+f"(x[14]), "+f"(x[15])
#define KET_D8(x) "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3]), "+f"(x[4]), "+f"(x[5]), "+f"(x[6]), \
    "+f"(x[7])

// D (64 x 64, f32) = or += A (64 x 16, shared, K-major) * B^T (64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : KET_D32(d)
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// D (64 x N, f32) += A (64 x 16, registers) * B (16 x N, shared, MN-major);
// N = 64, 32 or 16 by the 32, 16 or 8 accumulator registers of d
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : KET_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : KET_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : KET_D8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

#undef KET_D32
#undef KET_D16
#undef KET_D8

// D (64 x D16, f32) += A (64 x 16, registers) * B (16 rows 16 kk .. of the
// tile whose descriptor is `desc`, MN-major): a wgmma a column block. d holds
// the whole accumulator fragment, block nb's registers from d[nb * W / 2].
template <int D16, int ROWS>
__device__ __forceinline__ void wgmma_rs_tile(float (&d)[D16 / 2], const uint32_t (&a)[4], uint64_t desc, int kk) {
  using L = SwTile<D16, ROWS>;
  typedef float Block[L::W / 2];
#pragma unroll
  for (int nb = 0; nb < L::kBlocks; ++nb)
    wgmma_rs(*reinterpret_cast<Block*>(&d[nb * (L::W / 2)]), a, desc + L::mnmajor(nb, kk));
}

// Accumulator fragment of a 64-row wgmma tile, per thread: warp w of the
// warpgroup owns rows 16w .. 16w + 15; lane owns rows g = lane / 4 and g + 8;
// register 4j + e holds row g + 8 * (e / 2), column 8j + 2 * (lane % 4) + e % 2.
// Packed as bf16, registers 8s .. 8s + 7 (columns 16s .. 16s + 15) are the A
// fragment of the s-th k16 step of a product whose reduction axis is those
// columns.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

}  // namespace
