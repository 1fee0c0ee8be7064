// Exact softmax attention per (batch, head) for ViT-class sequence lengths.
//
// Replaces the JAX package's head-resident Pallas kernel
// (kobato_eyes_tpu/ops/pallas_attention.py: _attn_body via _attn_call_packed
// and _attn_call). It computes what _attn_body computes:
//   q is scaled in its own dtype (the scale rounded to that dtype first),
//   logits = q k^T accumulated in f32,
//   w = exp(logits - rowmax) rounded to v's dtype,
//   rowsum = sum(w) in f32, out = (w v accumulated in f32) / rowsum.
//
// The TPU design holds one head's whole (T, T) f32 logits in VMEM; at the
// ViT-B/448 shape (T = 785) that is 2.46 MB, ten times the 227 KB of shared
// memory a Hopper block can have. So both kernels here tile the keys with an
// online softmax (a running row max, a running f32 row sum, an f32 output
// accumulator) and never write the logits to device memory. q, k and v are
// read through strides straight from the packed (B, T, 3, H, D) projection
// and the output is written as (B, T, H, D), so the two whole-tensor
// transposes around the TPU call are gone.
//
// Bound on the card: 4*T^2*D*B*H operations (60.6 GFLOP per call at
// B=32, T=785, H=12, D=64) against 154 MB of qkv read and output written;
// at the bf16 tensor-core rate that is operation-bound, so the products
// have to run on the tensor cores.
//
// Two kernels, picked by dtype:
//
//  * bfloat16 (the main path): attn_wgmma_kernel. A block takes a q tile of
//    128 rows of one (batch, head): two warpgroups of 64 rows that share
//    every K/V tile (64-row blocks of one warpgroup read K and V twice as
//    often and were slower at the ViT-B/448 shape); a second warpgroup whose
//    rows all lie past T leaves at once. K and V
//    come in 64-key tiles through a three-stage ring in shared memory,
//    filled by 16-byte cp.async (rows past T zero-filled) in the 128-byte
//    (D = 64) or 64-byte (D = 32) swizzle that wgmma descriptors read.
//    S = Q K^T is wgmma m64n64k16 with both operands from shared memory;
//    the online softmax runs on the accumulator fragment in registers; P is
//    rounded to bf16 in registers and is the register A operand of the
//    second wgmma, whose B operand is the V tile read through a transposed
//    (MN-major) descriptor, so neither P nor a transposed V ever touches
//    shared memory. bf16 products are exact in f32 and the sums are f32.
//    One barrier a tile: behind it the copies of the tile after next start,
//    and S of the next tile is started together with O += P V of this one,
//    so the tensor cores run both back to back while the copies fly; two
//    or three blocks per SM overlap one block's softmax with another's
//    products. The output tile goes through shared memory so that it is
//    stored 16 bytes a thread.
//
//  * float32: attn_fma_kernel, f32 FMAs out of shared memory. Tensor cores
//    would mean TF32 operands, which the port does not use. One block per
//    64-row q tile, four threads a row.
//
// Plain C entry for ctypes: returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int kRows = 64;          // q rows per block
constexpr int kCols = 64;          // k/v rows per shared-memory tile
constexpr int kThreads = 256;      // 4 threads per q row
constexpr int kColsPerThread = kCols / 4;

template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (kCols * (D + 1) + kCols * D + kRows * (kCols + 1));
}

// Thread layout: row r = tid / 4 of the q tile belongs to a quad of threads;
// thread lane4 = tid % 4 of the quad owns key columns lane4 + 4j of each
// tile and output dims lane4 + 4j. The quad's q row lives in registers.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int t_len,
                long long in_sb, long long in_st, long long in_sh,
                long long out_sb, long long out_st, long long out_sh,
                float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                      // [kCols][D + 1]
  float* vs = ks + kCols * (D + 1);      // [kCols][D]
  float* ps = vs + kCols * D;            // [kRows][kCols + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int lane4 = tid & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kRows + r;
  const bool row_ok = row < t_len;

  const long long in_base = (long long)b * in_sb + (long long)h * in_sh;
  const float* qb = q + in_base;
  const float* kb = k + in_base;
  const float* vb = v + in_base;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = row_ok ? qb[(long long)row * in_st + d] : 0.f;
    qr[d] = x * scale;
  }

  constexpr int kDimsPerThread = D / 4;
  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc[j] = 0.f;
  float m = -INFINITY;  // running row max
  float l = 0.f;        // this thread's share of the running row sum

  for (int c0 = 0; c0 < t_len; c0 += kCols) {
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int i = tid; i < kCols * D; i += kThreads) {
      const int c = i / D;
      const int d = i - c * D;
      float kx = 0.f, vx = 0.f;
      if (c0 + c < t_len) {
        const long long off = (long long)(c0 + c) * in_st + d;
        kx = kb[off];
        vx = vb[off];
      }
      ks[c * (D + 1) + d] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[kColsPerThread];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = lane4 + 4 * j;
      const float* kr = ks + c * (D + 1);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      s[j] = (c0 + c < t_len) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // every tile holds at least one unmasked column, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float p = expf(s[j] - m_new);  // masked: exp(-inf) = 0
      psum += p;
      ps[r * (kCols + 1) + lane4 + 4 * j] = p;
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) acc[j] *= alpha;
    const float* pr = ps + r * (kCols + 1);
    for (int c = 0; c < kCols; ++c) {
      const float p = pr[c];
      const float* vr = vs + c * D + lane4;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j) acc[j] = fmaf(p, vr[4 * j], acc[j]);
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (row_ok) {
    float* orow = o + (long long)b * out_sb + (long long)h * out_sh + (long long)row * out_st;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) orow[lane4 + 4 * j] = acc[j] / l;
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int batch, int t_len, int heads,
                       long long in_sb, long long in_st, long long in_sh,
                       long long out_sb, long long out_st, long long out_sh,
                       float scale, cudaStream_t stream) {
  constexpr size_t bytes = fma_smem_bytes<D>();
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((t_len + kRows - 1) / kRows, heads, batch);
  attn_fma_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), t_len, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma kernel
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kTileKeys = 64;  // keys per shared-memory tile
constexpr int kStages = 3;     // K/V ring depth
constexpr int kWarpgroups = 2;                // 64 q rows each
constexpr int kQRows = 64 * kWarpgroups;      // q rows a block takes
constexpr int kNumThreads = 128 * kWarpgroups;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; with !valid nothing is read and the 16 bytes
// are zero-filled
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
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

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile whose rows are
// ROW_BYTES long (128 or 64: one swizzle span), stored in the swizzle the
// descriptor names. The tile's base is 1024-byte aligned.
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  const int x = ROW_BYTES == 128 ? (row & 7) : ((row >> 1) & 3);
  return (uint32_t)(row * ROW_BYTES + ((chunk ^ x) << 4));
}

// Shared-memory matrix descriptor of a tile with ROW_BYTES-long rows: eight
// rows make one swizzle atom, atoms follow each other every 8 * ROW_BYTES
// (the stride byte offset). The tile is one atom wide, so the leading byte
// offset is not used. The same fields describe the tile as a K-major
// operand (Q, K: the row is the reduction axis) and as an MN-major one (V:
// rows are keys, the reduction axis).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)((8 * ROW_BYTES) >> 4) << 32;
  d |= (uint64_t)(ROW_BYTES == 128 ? 1 : 2) << 62;
  return d;
}

// S (64 x 64, f32) = or += A (64 x 16, shared) * B^T (64 x 16, shared)
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// O (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// O (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // q tile + ring of K and V tiles, and room to align the base to 1024
  return (size_t)(kQRows + 2 * kStages * kTileKeys) * D * sizeof(bf16) + 1024;
}

// Accumulator fragment of a 64-row wgmma tile, per thread: warp w of the
// warpgroup owns rows 16w .. 16w+15; lane owns rows g = lane / 4 and g + 8;
// register 4j + e holds row g + 8 * (e / 2), column 8j + 2 * (lane % 4) + e % 2.
template <int D>
__global__ void __launch_bounds__(kNumThreads)
attn_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int t_len,
                  long long in_sb, long long in_st, long long in_sh,
                  long long out_sb, long long out_st, long long out_sh,
                  float scale) {
  constexpr int kRowBytes = D * (int)sizeof(bf16);
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kTileBytes = kTileKeys * kRowBytes;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  uint8_t* qs = smem_raw + pad;               // [kQRows][D]
  const uint32_t qs_addr = raw_addr + pad;
  const uint32_t ks_addr = qs_addr + kQRows * kRowBytes;   // [kStages][kTileKeys][D]
  const uint32_t vs_addr = ks_addr + kStages * kTileBytes;  // [kStages][kTileKeys][D]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;       // within the block: its rows are 16 * warp ..
  const int wg = tid >> 7;
  const int g = lane >> 2;
  const int quad = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kQRows;

  // a warpgroup whose 64 rows all lie past T (the second one of the last
  // block) leaves; the other one copies and meets at the barrier alone
  const int n_threads = q0 + 64 >= t_len ? 128 : kNumThreads;
  if (tid >= n_threads) return;
  auto block_barrier = [&]() {
    asm volatile("bar.sync 1, %0;\n" :: "r"(n_threads) : "memory");
  };

  const long long in_base = (long long)b * in_sb + (long long)h * in_sh;
  const bf16* qb = q + in_base;
  const bf16* kb = k + in_base;
  const bf16* vb = v + in_base;

  // q tile and key tile 0
  for (int i = tid; i < kQRows * kChunks; i += n_threads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = q0 + r < t_len;
    cp_async_16(qs_addr + swizzled<kRowBytes>(r, c),
                qb + (long long)(ok ? q0 + r : 0) * in_st + c * 8, ok);
  }
  auto load_kv = [&](int tile, int stage) {
    const int c0 = tile * kTileKeys;
    for (int i = tid; i < kTileKeys * kChunks; i += n_threads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = c0 + r < t_len;
      const long long off = (long long)(ok ? c0 + r : 0) * in_st + c * 8;
      const uint32_t dst = stage * kTileBytes + swizzled<kRowBytes>(r, c);
      cp_async_16(ks_addr + dst, kb + off, ok);
      cp_async_16(vs_addr + dst, vb + off, ok);
    }
  };
  const int n_tiles = (t_len + kTileKeys - 1) / kTileKeys;
  load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  // the scale is rounded to bf16 first and the product once more, as
  // q * scale in q's dtype is
  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  cp_async_wait<1>();  // q and key tile 0
  block_barrier();
  for (int i = tid; i < kQRows * kChunks; i += n_threads) {
    uint4* p = reinterpret_cast<uint4*>(qs + i * 16);
    uint4 x = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(*reinterpret_cast<bf162*>(&w[e]));
      bf162 y = __floats2bfloat162_rn(f.x * scale_t, f.y * scale_t);
      w[e] = *reinterpret_cast<uint32_t*>(&y);
    }
    *p = x;
  }
  fence_proxy_async();
  block_barrier();

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums

  const uint64_t q_desc = make_desc<kRowBytes>(qs_addr + wg * 64 * kRowBytes);

  // S = Q K^T of key tile `stage`'s keys into s
  float s[32];
  auto start_s = [&](int stage) {
    const uint64_t k_desc = make_desc<kRowBytes>(ks_addr + stage * kTileBytes);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
  };
  wgmma_fence();
  start_s(0);
  wgmma_commit();
  wgmma_wait_all();

  // Tile `it`: softmax of S(it) in registers; then, behind one barrier, the
  // copies of tile it + 2 start, and S(it + 1) and O += P(it) V(it) go to the
  // tensor cores together.
  int stage = 0;  // it % kStages
  for (int it = 0; it < n_tiles; ++it) {
    const int stage_next = stage + 1 == kStages ? 0 : stage + 1;
    const int c0 = it * kTileKeys;
    if (c0 + kTileKeys > t_len) {  // ragged last tile: keys past T to -inf
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c0 + 8 * j + 2 * quad + (e & 1) >= t_len) s[4 * j + e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one unmasked key, so the new max is finite
    const float m0n = fmaxf(m0, mx0), m1n = fmaxf(m1, mx1);
    const float a0 = expf(m0 - m0n), a1 = expf(m1 - m1n);  // 0 on the first tile
    m0 = m0n;
    m1 = m1n;

    // P = exp(S - max) rounded to bf16, packed as the A fragments of the
    // four k16 steps over this tile's keys; row sums of the rounded values
    uint32_t pa[4][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bf162 p0 = __floats2bfloat162_rn(expf(s[4 * j] - m0n), expf(s[4 * j + 1] - m0n));
      bf162 p1 = __floats2bfloat162_rn(expf(s[4 * j + 2] - m1n), expf(s[4 * j + 3] - m1n));
      const float2 f0 = __bfloat1622float2(p0), f1 = __bfloat1622float2(p1);
      sum0 += f0.x + f0.y;
      sum1 += f1.x + f1.y;
      pa[j >> 1][(j & 1) * 2 + 0] = *reinterpret_cast<uint32_t*>(&p0);
      pa[j >> 1][(j & 1) * 2 + 1] = *reinterpret_cast<uint32_t*>(&p1);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    // after the first tiles the max seldom moves: skip the rescale where no
    // lane of the warp needs it
    if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[4 * j] *= a0;
        o_acc[4 * j + 1] *= a0;
        o_acc[4 * j + 2] *= a1;
        o_acc[4 * j + 3] *= a1;
      }
    }

    // tile it + 1 has landed; past the barrier every warp is also done with
    // tile it - 1, whose stage the copies of tile it + 2 refill
    cp_async_wait<0>();
    fence_proxy_async();
    block_barrier();
    if (it + 2 < n_tiles) load_kv(it + 2, stage_next + 1 == kStages ? 0 : stage_next + 1);
    cp_async_commit();

    // S(it + 1), and O += P V: 16 keys a step, V rows are the reduction axis
    const uint64_t v_desc = make_desc<kRowBytes>(vs_addr + stage * kTileBytes);
    wgmma_fence();
    if (it + 1 < n_tiles) start_s(stage_next);
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk)
      wgmma_rs(o_acc, pa[kk], v_desc + kk * ((16 * kRowBytes) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    stage = stage_next;
  }
  block_barrier();  // every warp is past the last product: the q tile is free

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // this warp's 16 output rows go through its rows of the q tile (no longer
  // read: every warp is past the last product) and leave 16 bytes a thread
  const int wrow = 16 * warp;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    bf162 y0 = __floats2bfloat162_rn(o_acc[4 * j] / l0, o_acc[4 * j + 1] / l0);
    bf162 y1 = __floats2bfloat162_rn(o_acc[4 * j + 2] / l1, o_acc[4 * j + 3] / l1);
    *reinterpret_cast<bf162*>(qs + swizzled<kRowBytes>(wrow + g, j) + 4 * quad) = y0;
    *reinterpret_cast<bf162*>(qs + swizzled<kRowBytes>(wrow + g + 8, j) + 4 * quad) = y1;
  }
  __syncwarp();
  bf16* ob = o + (long long)b * out_sb + (long long)h * out_sh;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = wrow + i / kChunks, c = i % kChunks;
    if (q0 + r < t_len) {
      *reinterpret_cast<uint4*>(ob + (long long)(q0 + r) * out_st + c * 8) =
          *reinterpret_cast<const uint4*>(qs + swizzled<kRowBytes>(r, c));
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int batch, int t_len, int heads,
                         long long in_sb, long long in_st, long long in_sh,
                         long long out_sb, long long out_st, long long out_sh,
                         float scale, cudaStream_t stream) {
  constexpr size_t bytes = wgmma_smem_bytes<D>();
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((t_len + kQRows - 1) / kQRows, heads, batch);
  attn_wgmma_kernel<D><<<grid, kNumThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), t_len, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel).
// Strides are in elements; the last (head_dim) stride is 1 for every tensor.
// q, k and v share their strides. bfloat16 tensors are read and written 16
// bytes at a time: pointers 16-byte aligned, strides multiples of 8.
extern "C" int head_resident_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int batch, int t_len, int heads, int head_dim, int dtype_code,
    long long in_sb, long long in_st, long long in_sh,
    long long out_sb, long long out_st, long long out_sh,
    float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KET_ATTN_ARGS \
  q, k, v, o, batch, t_len, heads, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale, s
  if (dtype_code == 0 && head_dim == 64) return (int)launch_fma<64>(KET_ATTN_ARGS);
  if (dtype_code == 0 && head_dim == 32) return (int)launch_fma<32>(KET_ATTN_ARGS);
  if (dtype_code == 1) {
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
    const long long strides = in_sb | in_st | in_sh | out_sb | out_st | out_sh;
    if ((ptrs & 15) || (strides & 7)) return (int)cudaErrorMisalignedAddress;
    if (head_dim == 64) return (int)launch_wgmma<64>(KET_ATTN_ARGS);
    if (head_dim == 32) return (int)launch_wgmma<32>(KET_ATTN_ARGS);
  }
#undef KET_ATTN_ARGS
  return (int)cudaErrorInvalidValue;
}
