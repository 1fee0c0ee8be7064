// The tensor-core attention body shared by head_resident_attention.cu
// (kernel 1, the head-resident attention) and flash_attention.cu (the flash
// forward): softmax(S) V of one (batch, head) for bfloat16 q, k, v with
// 16-byte aligned rows and strides that are multiples of 8, at every head
// width 1 .. 128 (rounded up to 16 in shared memory).
//
// A block takes a q tile of 128 rows: two warpgroups of 64 rows that share
// every K/V tile (64-row blocks of one warpgroup read K and V twice as
// often and were slower at the ViT-B/448 shape); a second warpgroup whose
// rows all lie past T leaves at once. K and V come in 64-key tiles through
// a three-stage ring in shared memory, filled by 16-byte cp.async (rows past
// T zero-filled) in the swizzles that wgmma descriptors read (wgmma.cuh).
// S = Q K^T is wgmma m64n64k16 with both operands from shared memory; the
// online softmax runs on the accumulator fragment in registers; P is
// rounded to bf16 in registers and is the register A operand of the second
// wgmma, whose B operand is the V tile read through a transposed (MN-major)
// descriptor, so neither P nor a transposed V ever touches shared memory.
// bf16 products are exact in f32 and the sums are f32. One barrier a tile:
// behind it the copies of the tile after next start, and S of the next tile
// is started together with O += P V of this one, so the tensor cores run
// both back to back while the copies fly; two or three blocks per SM
// overlap one block's softmax with another's products. The output tile
// goes through shared memory so that it is stored 16 bytes a thread.
//
// The two kernels differ at four points, each an `if constexpr (FLASH)`:
//   kernel 1 (the JAX head-resident kernel's _attn_body): q scaled in bf16
//     (the scale rounded to bf16 first) before the product; l sums the
//     rounded p;
//   flash (the JAX flash forward): each f32 S entry scaled by __fmul_rn
//     after the product, before the ragged tile's mask and the max; l sums
//     the f32 p before it is rounded for P V; the row max m and sum l of
//     every real row written, (B, H, T) f32, for the backward.
// Both write o = o_acc / l rounded once to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

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
// wgmma.cuh says. FULL: d == D16 (no column is padded). FLASH: the flash
// forward's arithmetic (the file's head comment); m_out, l_out and heads
// are read only then.
template <int D16, bool FULL, bool FLASH>
__global__ void __launch_bounds__(kNumThreads)
attn_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out, int t_len, int heads, int d,
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

  cp_async_wait<1>();  // q and key tile 0
  if constexpr (!FLASH) {
    // the scale is rounded to bf16 first and the product once more, as
    // q * scale in q's dtype is
    const float scale_t = __bfloat162float(__float2bfloat16(scale));
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
    if constexpr (FLASH) {  // scaled in f32 after the product, rounded before the max
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], scale);
    }
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
    // (FLASH: of the f32 ones)
    uint32_t pa[4][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e00 = expf(s[4 * j] - m0n), e01 = expf(s[4 * j + 1] - m0n);
      const float e10 = expf(s[4 * j + 2] - m1n), e11 = expf(s[4 * j + 3] - m1n);
      bf162 p0 = __floats2bfloat162_rn(e00, e01);
      bf162 p1 = __floats2bfloat162_rn(e10, e11);
      if constexpr (FLASH) {
        sum0 += e00 + e01;
        sum1 += e10 + e11;
      } else {
        const float2 f0 = __bfloat1622float2(p0), f1 = __bfloat1622float2(p1);
        sum0 += f0.x + f0.y;
        sum1 += f1.x + f1.y;
      }
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
  if constexpr (FLASH) {  // m and l of this thread's rows, by the quad's first lane
    const int row = q0 + 16 * warp + g;
    const long long ml = ((long long)b * heads + h) * t_len;
    if (quad == 0 && row < t_len) {
      m_out[ml + row] = m0;
      l_out[ml + row] = l0;
    }
    if (quad == 0 && row + 8 < t_len) {
      m_out[ml + row + 8] = m1;
      l_out[ml + row + 8] = l1;
    }
  }

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

}  // namespace
