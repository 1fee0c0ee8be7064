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
//  * bfloat16 (the main path): attn_wgmma_kernel, at every head width: the
//    width rounded up to 16 (the wgmma depth) is a template instance, the
//    columns past d zero-filled in shared memory (wgmma.cuh lays the tiles
//    out in 64-, 32- or 16-column swizzled blocks). A block takes a q tile of
//    128 rows of one (batch, head): two warpgroups of 64 rows that share
//    every K/V tile (64-row blocks of one warpgroup read K and V twice as
//    often and were slower at the ViT-B/448 shape); a second warpgroup whose
//    rows all lie past T leaves at once. K and V
//    come in 64-key tiles through a three-stage ring in shared memory,
//    filled by 16-byte cp.async (rows past T zero-filled) in the 128-, 64-
//    or 32-byte swizzle that wgmma descriptors read.
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
//    64-row q tile, four threads a row; the head width padded to 32, 64 or
//    128 with zeros.
//
// Plain C entry for ctypes: returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

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
// tile and output dims lane4 + 4j. The quad's q row lives in registers. D is
// the head width d padded to 32, 64 or 128 with zero columns.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int t_len, int head_dim,
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
    const float x = row_ok && d < head_dim ? qb[(long long)row * in_st + d] : 0.f;
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
      if (c0 + c < t_len && d < head_dim) {
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
    for (int j = 0; j < kDimsPerThread; ++j) {
      if (lane4 + 4 * j < head_dim) orow[lane4 + 4 * j] = acc[j] / l;
    }
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int batch, int t_len, int heads, int head_dim,
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
      static_cast<float*>(o), t_len, head_dim, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kTileKeys = 64;  // keys per shared-memory tile
constexpr int kStages = 3;     // K/V ring depth
constexpr int kWarpgroups = 2;                // 64 q rows each
constexpr int kQRows = 64 * kWarpgroups;      // q rows a block takes
constexpr int kNumThreads = 128 * kWarpgroups;

template <int D16>
constexpr size_t wgmma_smem_bytes() {
  // q tile + ring of K and V tiles, and room to align the base to 1024
  return (size_t)SwTile<D16, kQRows>::kBytes + 2 * kStages * SwTile<D16, kTileKeys>::kBytes + 1024;
}

// D16: the head width rounded up to 16 (columns d .. D16 - 1 are zeros in
// shared memory; zero columns of q and k leave q k^T as it is, and zero
// columns of v give output columns that are not written). Fragments as
// wgmma.cuh says. FULL: d == D16 (no column is padded).
template <int D16, bool FULL>
__global__ void __launch_bounds__(kNumThreads)
attn_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int t_len, int d,
                  long long in_sb, long long in_st, long long in_sh,
                  long long out_sb, long long out_st, long long out_sh,
                  float scale) {
  using QL = SwTile<D16, kQRows>;
  using KL = SwTile<D16, kTileKeys>;
  constexpr int kChunks = QL::kChunks;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  uint8_t* qs = smem_raw + pad;               // [kQRows][D16]
  const uint32_t qs_addr = raw_addr + pad;
  const uint32_t ks_addr = qs_addr + QL::kBytes;              // [kStages][kTileKeys][D16]
  const uint32_t vs_addr = ks_addr + kStages * KL::kBytes;    // [kStages][kTileKeys][D16]

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
  load_tile_async<D16, kQRows, FULL>(qs_addr, qb, q0, t_len, d, in_st, tid, n_threads);
  auto load_kv = [&](int tile, int stage) {
    const uint32_t dsts[2] = {ks_addr + stage * KL::kBytes, vs_addr + stage * KL::kBytes};
    const bf16* const srcs[2] = {kb, vb};
    load_tiles_async<D16, kTileKeys, FULL>(dsts, srcs, tile * kTileKeys, t_len, d, in_st, tid, n_threads);
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
      w[e] = pack_bf16(f.x * scale_t, f.y * scale_t);
    }
    *p = x;
  }
  fence_proxy_async();
  block_barrier();

  float o_acc[D16 / 2];
#pragma unroll
  for (int i = 0; i < D16 / 2; ++i) o_acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums

  const uint64_t q_desc = QL::desc(qs_addr + wg * 64 * QL::kRowBytes);

  // S = Q K^T of key tile `stage`'s keys into s
  float s[32];
  auto start_s = [&](int stage) {
    const uint64_t k_desc = KL::desc(ks_addr + stage * KL::kBytes);
#pragma unroll
    for (int kk = 0; kk < D16 / 16; ++kk)
      wgmma_ss_n64(s, q_desc + QL::kmajor(kk), k_desc + KL::kmajor(kk), kk > 0);
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
      for (int j = 0; j < D16 / 8; ++j) {
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
    const uint64_t v_desc = KL::desc(vs_addr + stage * KL::kBytes);
    wgmma_fence();
    if (it + 1 < n_tiles) start_s(stage_next);
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk) wgmma_rs_tile<D16, kTileKeys>(o_acc, pa[kk], v_desc, kk);
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
  for (int j = 0; j < D16 / 8; ++j) {
    const uint32_t y0 = pack_bf16(o_acc[4 * j] / l0, o_acc[4 * j + 1] / l0);
    const uint32_t y1 = pack_bf16(o_acc[4 * j + 2] / l1, o_acc[4 * j + 3] / l1);
    *reinterpret_cast<uint32_t*>(qs + QL::offset(wrow + g, j) + 4 * quad) = y0;
    *reinterpret_cast<uint32_t*>(qs + QL::offset(wrow + g + 8, j) + 4 * quad) = y1;
  }
  __syncwarp();
  bf16* ob = o + (long long)b * out_sb + (long long)h * out_sh;
  // 16-byte stores where the output view allows them (a head width that is
  // not a multiple of 8 gives rows that are not 16-byte aligned)
  const bool vec_ok = ((uintptr_t)o & 15) == 0 && ((out_sb | out_st | out_sh) & 7) == 0;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = wrow + i / kChunks, c = i % kChunks;
    if (q0 + r >= t_len || (!FULL && 8 * c >= d)) continue;
    bf16* dst = ob + (long long)(q0 + r) * out_st + c * 8;
    const uint8_t* src = qs + QL::offset(r, c);
    if (vec_ok && d - 8 * c >= 8) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const int n = d - 8 * c < 8 ? d - 8 * c : 8;
      for (int e = 0; e < n; ++e) dst[e] = reinterpret_cast<const bf16*>(src)[e];
    }
  }
}

template <int D16, bool FULL>
cudaError_t launch_wgmma_body(const void* q, const void* k, const void* v, void* o,
                              int batch, int t_len, int heads, int d,
                              long long in_sb, long long in_st, long long in_sh,
                              long long out_sb, long long out_st, long long out_sh,
                              float scale, cudaStream_t stream) {
  constexpr size_t bytes = wgmma_smem_bytes<D16>();
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_wgmma_kernel<D16, FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((t_len + kQRows - 1) / kQRows, heads, batch);
  attn_wgmma_kernel<D16, FULL><<<grid, kNumThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), t_len, d, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale);
  return cudaGetLastError();
}

template <int D16>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int batch, int t_len, int heads, int d,
                         long long in_sb, long long in_st, long long in_sh,
                         long long out_sb, long long out_st, long long out_sh,
                         float scale, cudaStream_t stream) {
  auto launch = d == D16 ? launch_wgmma_body<D16, true> : launch_wgmma_body<D16, false>;
  return launch(q, k, v, o, batch, t_len, heads, d, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale, stream);
}

}  // namespace

// dtype_code: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel); head_dim
// 1 .. 128. Strides are in elements; the last (head_dim) stride is 1 for
// every tensor. q, k and v share their strides. bfloat16 q, k and v are read
// 16 bytes at a time: pointers 16-byte aligned, strides multiples of 8; the
// output is written so where its view allows it.
extern "C" int head_resident_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int batch, int t_len, int heads, int head_dim, int dtype_code,
    long long in_sb, long long in_st, long long in_sh,
    long long out_sb, long long out_st, long long out_sh,
    float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || head_dim <= 0 ||
      head_dim > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KET_ATTN_ARGS \
  q, k, v, o, batch, t_len, heads, head_dim, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale, s
  if (dtype_code == 0) {
    if (head_dim <= 32) return (int)launch_fma<32>(KET_ATTN_ARGS);
    if (head_dim <= 64) return (int)launch_fma<64>(KET_ATTN_ARGS);
    return (int)launch_fma<128>(KET_ATTN_ARGS);
  }
  if (dtype_code == 1) {
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
    if ((ptrs & 15) || ((in_sb | in_st | in_sh) & 7)) return (int)cudaErrorMisalignedAddress;
    switch ((head_dim + 15) / 16) {
      case 1: return (int)launch_wgmma<16>(KET_ATTN_ARGS);
      case 2: return (int)launch_wgmma<32>(KET_ATTN_ARGS);
      case 3: return (int)launch_wgmma<48>(KET_ATTN_ARGS);
      case 4: return (int)launch_wgmma<64>(KET_ATTN_ARGS);
      case 5: return (int)launch_wgmma<80>(KET_ATTN_ARGS);
      case 6: return (int)launch_wgmma<96>(KET_ATTN_ARGS);
      case 7: return (int)launch_wgmma<112>(KET_ATTN_ARGS);
      default: return (int)launch_wgmma<128>(KET_ATTN_ARGS);
    }
  }
#undef KET_ATTN_ARGS
  return (int)cudaErrorInvalidValue;
}
