// SwinV2 window cosine attention for every (batch, window, head).
//
// Replaces the JAX package's window-resident Pallas kernel
// (kobato_eyes_tpu/ops/pallas_window_attention.py: _win_attn_kernel via
// _win_attn_call / windowed_cosine_attention_packed). It computes what
// _win_attn_kernel computes, per window and head:
//   qn = q * rsqrt(max(sum(q^2), 1e-12)), kn likewise, both in f32, with
//     XLA's CPU rsqrt (xla_rsqrt.cuh: the host's estimate table, two Newton
//     steps), which the JAX kernel's jax.lax.rsqrt is on the CPU
//     (qk_bf16: qn and kn rounded to bf16, as qk_precision="bf16" does);
//   logits = (qn kn^T) * scale[h] + bias[h] (+ mask[w]), all f32;
//   w = exp(logits - rowmax) rounded to v's dtype, rowsum = sum(w) in f32;
//   out = (w v accumulated in f32) / rowsum, written in qkv's dtype.
// The products take f32 operands: that is what the JAX function computes on
// the CPU for qk_precision "default" and "highest". On the TPU, "default"
// rounds the operands to bf16 on its matrix unit; here only "bf16" does.
//
// The TPU program holds all of one (batch, head)'s windows in VMEM (9.8 MB
// of logits at SwinV2-B/448 stage 0), far over a Hopper block's 227 KB, so a
// block here works on one or two (batch, window)s at a time. q, k and v are read
// through strides straight from the packed (B, nW, n, 3, H, hd) projection
// (the TPU call transposes the whole tensor first), and the output is
// written as (B, nW, n, H, hd), which the model's output projection reads as
// (B*nW, n, C) with no copy.
//
// The row-max shift stays: q and k are different projections, so no row has
// a guaranteed-large logit, and with the clamped scale of 100, the CPB bias
// of up to 16 and the -100 shift mask a static shift underflows whole rows
// (test_static_shift_safe_at_production_bounds in the JAX package).
//
// Bound on the card: bytes. At SwinV2-B/448 stage 0 (B=32, nW=256, n=49,
// H=4, hd=32, bf16) the call reads 308 MB of qkv and writes 103 MB, 0.12 ms
// at 3.35 TB/s. Of its 10.1 GFLOP, the q k^T half takes f32 operands under
// "default" and "highest" and so runs on the FMA units (0.075 ms at their
// 67 TFLOP/s); the P V half has bf16 operands by definition and runs on the
// tensor cores. The design keeps the FMA units fed and the loads wide.
//
// Two kernels, picked by the wrapper (window_attention.kernel_variant):
//
//  * "mma": bf16 qkv; hd 16 or 32 with n <= 64, hd 64 with n <= 56 (every
//    SwinV2 stage at window 7 or 8). win_attn_mma_kernel: one block an SM,
//    each bound to a group of four neighbouring heads for its whole life,
//    walking over (batch, window)s: the four heads' bias tables sit in
//    shared memory once a block (fetched per window they would be as many
//    bytes as the qkv). Four warps, a warp a head, make a team that works on
//    one window; a block has two teams where shared memory holds them. A
//    warp's loads cover its head's hd contiguous columns of each token row,
//    the team's 4 * hd, 16 bytes a thread, by cp.async started a window
//    ahead, so that the trip to device memory hides behind the arithmetic
//    of the window before. The warp normalises its q and k rows in f32 into
//    shared memory (row stride hd + 4 floats: conflict-free 16-byte reads).
//    The (n, n) logits never leave registers: each lane accumulates them
//    with f32 FMAs in the layout of the mma accumulator fragment (rows g,
//    g + 8, ... and columns 2t, 2t + 1, 8 + 2t, ...: a register tile of up
//    to 8 x 16 fed by 16-byte shared loads, 4.7 FMAs a loaded float at
//    n = 49), n padded to a multiple of 8 (56 at n = 49, not 64: every lane
//    works). Scale, bias, mask (a table a team, fetched during the window
//    before), row max (quad shuffles), exp and the bf16 rounding follow in
//    registers; the rounded weights are already the A fragments of
//    mma.sync.m16n8k16, V (copied while the softmax runs) comes from shared
//    memory by ldmatrix.trans as the B fragments, and P V accumulates in f32
//    on the tensor cores, keys padded to 64 with zero weights. The output
//    goes through the warp's shared memory and leaves 16 bytes a thread.
//
//  * "rows": everything else the wrapper takes (float32 qkv, n up to 256,
//    hd any multiple of 8 up to 64). win_attn_rows_kernel: one block per
//    (batch, window, head); the window's normalised keys and its values sit
//    in shared memory as f32, each of four warps takes query rows in turn
//    and computes one row's logits into its own shared row buffer, so the
//    (n, n) tile is never held whole and n = 196 (window 14) fits. All
//    products are f32 FMAs.
//
// Plain C entry for ctypes: returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "xla_rsqrt.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTokens = 256;  // n = window^2 the kernel takes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded through T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Shared memory, in floats:
//   ks [n][HD + 1]    normalised keys (lane j reads row j: the pad keeps
//                     the 32 lanes on 32 banks)
//   vs [n][HD]        values
//   qs [kWarps][HD]   each warp's normalised query row
//   ws [kWarps][n]    each warp's logits row, then its rounded weights
template <int HD>
size_t smem_bytes(int n) {
  return sizeof(float) * ((size_t)n * (HD + 1) + (size_t)n * HD + kWarps * HD + (size_t)kWarps * n);
}

// One warp normalises the HD-vector at src (unit stride) into dst:
// x * rsqrt(max(sum(x^2), 1e-12)), rounded to bf16 when round_bf16.
template <typename T, int HD>
__device__ __forceinline__ void load_normalised(const T* __restrict__ src, float* dst,
                                                int lane, bool round_bf16) {
  constexpr int kPer = (HD + 31) / 32;
  float x[kPer];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int d = lane + 32 * k;
    x[k] = d < HD ? to_f(src[d]) : 0.f;
    ss = fmaf(x[k], x[k], ss);
  }
  ss = warp_sum(ss);
  const float inv = xla_rsqrt_floored(fmaxf(ss, 1e-12f));
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int d = lane + 32 * k;
    if (d < HD) {
      float y = x[k] * inv;
      if (round_bf16) y = round_to<__nv_bfloat16>(y);
      dst[d] = y;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
win_attn_rows_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const float* __restrict__ mask, int n_windows, int n, int heads,
                long long s_b, long long s_w, long long s_n, long long s_three, long long s_h,
                long long o_b, long long o_w, long long o_n, long long o_h, int qk_bf16) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + n * (HD + 1);
  float* qs = vs + n * HD;
  float* ws = qs + kWarps * HD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // blockIdx.x enumerates (b, w, h) with h fastest: the heads of one window
  // read neighbouring bytes of the packed projection
  const int h = (int)(blockIdx.x % (unsigned)heads);
  const unsigned bw = blockIdx.x / (unsigned)heads;
  const int w = (int)(bw % (unsigned)n_windows);
  const long long b = bw / (unsigned)n_windows;

  const T* qb = qkv + b * s_b + (long long)w * s_w + (long long)h * s_h;
  const T* kb = qb + s_three;
  const T* vb = qb + 2 * s_three;

  for (int j = warp; j < n; j += kWarps) {
    load_normalised<T, HD>(kb + j * s_n, ks + j * (HD + 1), lane, qk_bf16 != 0);
    for (int d = lane; d < HD; d += 32) vs[j * HD + d] = to_f(vb[j * s_n + d]);
  }
  __syncthreads();

  const float sc = scale[h];
  const float* bias_h = bias + (long long)h * n * n;
  const float* mask_w = mask != nullptr ? mask + (long long)w * n * n : nullptr;
  float* qrow = qs + warp * HD;
  float* wrow = ws + warp * n;
  T* ob = out + b * o_b + (long long)w * o_w + (long long)h * o_h;

  for (int i = warp; i < n; i += kWarps) {
    load_normalised<T, HD>(qb + i * s_n, qrow, lane, qk_bf16 != 0);
    __syncwarp();
    float qr[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = qrow[d];

    // row i's logits: lane takes keys j = lane, lane + 32, ...
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * (HD + 1);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      // (dot * scale + bias) + mask, each step rounded as the JAX kernel does
      float l = __fadd_rn(__fmul_rn(dot, sc), bias_h[i * n + j]);
      if (mask_w != nullptr) l = __fadd_rn(l, mask_w[i * n + j]);
      wrow[j] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    float s = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = round_to<T>(expf(wrow[j] - mx));
      wrow[j] = p;
      s += p;
    }
    s = warp_sum(s);
    __syncwarp();

    // PV: lane takes output dims d = lane, lane + 32
    T* orow = ob + (long long)i * o_n;
    for (int d = lane; d < HD; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(wrow[j], vs[j * HD + d], acc);
      orow[d] = from_f<T>(acc / s);
    }
    __syncwarp();  // qrow and wrow are rewritten for the warp's next row
  }
}

template <typename T, int HD>
cudaError_t launch_rows(const void* qkv, void* out, const float* scale, const float* bias,
                   const float* mask, int batch, int n_windows, int n, int heads,
                   long long s_b, long long s_w, long long s_n, long long s_three, long long s_h,
                   long long o_b, long long o_w, long long o_n, long long o_h, int qk_bf16,
                   cudaStream_t stream) {
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(win_attn_rows_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes<HD>(kMaxTokens));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long blocks = (long long)batch * n_windows * heads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  win_attn_rows_kernel<T, HD><<<(unsigned)blocks, kThreads, smem_bytes<HD>(n), stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), scale, bias, mask, n_windows, n, heads,
      s_b, s_w, s_n, s_three, s_h, o_b, o_w, o_n, o_h, qk_bf16);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "mma": bf16 qkv, n <= 64, hd in {16, 32, 64}; a warp a head
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kHeadsPerBlock = 4;
constexpr int kKeyPad = 64;       // keys of the P V product: four k16 steps
constexpr int kTableStride = 72;  // floats a staged bias or mask row takes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// An (n, n) f32 table goes into shared memory as [n][kTableStride]:
// `workers` warps (this one is `worker`) take rows in turn, a lane a float,
// so a warp load reads up to 128 consecutive bytes (rows start at any 4-byte
// address: n is odd at window 7). The stride puts the fragment reads of a
// half warp (rows g, g + 8 .. and 8 bytes at column 2t) on 32 different
// banks. Loads and stores are apart so that a caller can put work between
// them: kTableRegs floats a lane hold up to 64 columns of
// kTableRegs / 2 rows.
constexpr int kTableRegs = 32;

__device__ __forceinline__ void table_load(float (&regs)[kTableRegs], const float* __restrict__ src,
                                           int n, int first_row, int row_step, int lane) {
#pragma unroll
  for (int k = 0; k < kTableRegs / 2; ++k) {
    const int i = first_row + k * row_step;
    regs[2 * k] = (i < n && lane < n) ? __ldg(src + i * n + lane) : 0.f;
    regs[2 * k + 1] = (i < n && lane + 32 < n) ? __ldg(src + i * n + lane + 32) : 0.f;
  }
}

__device__ __forceinline__ void table_store(float* dst, const float (&regs)[kTableRegs], int n,
                                            int first_row, int row_step, int lane) {
#pragma unroll
  for (int k = 0; k < kTableRegs / 2; ++k) {
    const int i = first_row + k * row_step;
    if (i < n) {
      dst[i * kTableStride + lane] = regs[2 * k];
      dst[i * kTableStride + lane + 32] = regs[2 * k + 1];
    }
  }
}

// the four warps of one window (a "team") meet at their own barrier
__device__ __forceinline__ void team_barrier(int team) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(team + 1), "n"(32 * kHeadsPerBlock) : "memory");
}

// Shared memory of a block, in bytes: the bias of the block's four heads as
// f32 [4][8 * NR][kTableStride], resident for the block's life; then per team
// the window's mask, one such table; then per warp an area that holds qn and
// kn as f32 [8 * NR][HD + 4] during the q k^T phase and, after it, v as bf16
// [kKeyPad][HD + 8], the output tile [8 * NR][HD] and the next window's raw q
// and k rows [2][8 * NR][HD] (the pads keep 16-byte reads and ldmatrix off
// shared banks another lane of the same access uses). After all of it, the
// block's 4 KB copy of the rsqrt estimate table (xla_rsqrt.cuh).
template <int NR>
__host__ __device__ constexpr size_t mma_table_bytes() {
  return sizeof(float) * (8 * NR) * kTableStride;
}
template <int HD>
__host__ __device__ constexpr size_t mma_v_bytes() {
  return sizeof(bf16) * kKeyPad * (HD + 8);
}
template <int HD, int NR>
__host__ __device__ constexpr size_t mma_area_bytes() {
  return 2 * sizeof(float) * (8 * NR) * (HD + 4) > mma_v_bytes<HD>() + 3 * sizeof(bf16) * (8 * NR) * HD
             ? 2 * sizeof(float) * (8 * NR) * (HD + 4)
             : mma_v_bytes<HD>() + 3 * sizeof(bf16) * (8 * NR) * HD;
}
template <int HD, int NR, int TEAMS>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return kHeadsPerBlock * mma_table_bytes<NR>() +
         TEAMS * (mma_table_bytes<NR>() + kHeadsPerBlock * mma_area_bytes<HD, NR>());
}

// NR: 8-row groups that cover n (7 for n <= 56, 8 for n <= 64). TEAMS: the
// windows a block works on at a time, four warps each (two where shared
// memory allows).
//
// Fragment coordinates of a lane, g = lane / 4 and t = lane % 4: logit rows
// 8r + g (r < NR), logit columns 8c + 2t + e (c < NR, e < 2). Rows 16m + g
// and 16m + 8 + g of the m-th m16 tile are r = 2m and 2m + 1, and columns
// 16s .. 16s + 15 of the s-th k16 step are c = 2s and 2s + 1: the weights a
// lane holds are the A fragment it owes to mma.m16n8k16.
template <int HD, int NR, int TEAMS>
__global__ void __launch_bounds__(32 * kHeadsPerBlock * TEAMS, 1)
win_attn_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const float* __restrict__ mask, int batch, int n_windows, int n, int heads,
                    long long s_b, long long s_w, long long s_n, long long s_three, long long s_h,
                    long long o_b, long long o_w, long long o_n, long long o_h, int qk_bf16) {
  constexpr int kRows = 8 * NR;
  constexpr int kChunks = HD / 8;           // 16-byte chunks of a head's row
  constexpr int kQStride = HD + 4;          // floats
  constexpr int kVStride = HD + 8;          // bf16
  constexpr int kLoadIters = (kRows * kChunks + 31) / 32;
  constexpr int kMTiles = (NR + 1) / 2;
  constexpr int kKSteps = kKeyPad / 16;
  constexpr int kNTiles = HD / 8;

  extern __shared__ __align__(16) uint8_t smem_mma[];
  const int team = threadIdx.x / (32 * kHeadsPerBlock);
  const int warp = (threadIdx.x >> 5) % kHeadsPerBlock;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // blockIdx.y is the group of four heads, the same for the block's life;
  // blockIdx.x and the team pick the (batch, window)s it walks over
  const int h = (int)blockIdx.y * kHeadsPerBlock + warp;
  const bool active = h < heads;  // a warp without a head only meets the barriers
  const bool masked = mask != nullptr;

  float* bias_s = reinterpret_cast<float*>(smem_mma) + warp * (kRows * kTableStride);
  uint8_t* team_base = smem_mma + kHeadsPerBlock * mma_table_bytes<NR>() +
                       team * (mma_table_bytes<NR>() + kHeadsPerBlock * mma_area_bytes<HD, NR>());
  float* mask_s = reinterpret_cast<float*>(team_base);
  uint8_t* area = team_base + mma_table_bytes<NR>() + warp * mma_area_bytes<HD, NR>();
  float* qn = reinterpret_cast<float*>(area);
  float* kn = qn + kRows * kQStride;
  // after the q k^T phase:
  bf16* vs = reinterpret_cast<bf16*>(area);                                // [kKeyPad][kVStride]
  bf16* stage = reinterpret_cast<bf16*>(area + mma_v_bytes<HD>());         // [kRows][HD]
  const uint4* raw_s = reinterpret_cast<const uint4*>(stage + kRows * HD);  // [2][kRows][kChunks]

  // Asynchronous copies of a window's raw q and k rows into raw_s: started
  // a window ahead, so that the trip to device memory is over when the rows
  // are wanted.
  auto prefetch_qk = [&](int u) {
    const bf16* qb = qkv + (long long)(u / n_windows) * s_b + (long long)(u % n_windows) * s_w +
                     (long long)h * s_h;
    const uint32_t raw_addr = smem_u32(raw_s);
#pragma unroll
    for (int it = 0; it < kLoadIters; ++it) {
      const int idx = it * 32 + lane;
      const int row = idx / kChunks, ch = idx % kChunks;
      if (row < n) {
        const bf16* src = qb + (long long)row * s_n + ch * 8;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(raw_addr + 16u * idx), "l"(src) : "memory");
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(raw_addr + 16u * (kRows * kChunks + idx)), "l"(src + s_three) : "memory");
      }
    }
  };

  const int total = batch * n_windows;
  const int u_first = (int)blockIdx.x * TEAMS + team;
  const int u_step = (int)gridDim.x * TEAMS;

  // the heads' bias once: read again for every window, it would be as many
  // bytes as the qkv itself. With it, the first window's mask and rows.
  float table[kTableRegs];
  if (u_first < total && active) prefetch_qk(u_first);
  if (team == 0 && active) {
    for (int i0 = 0; i0 < n; i0 += kTableRegs / 2) {
      table_load(table, bias + (long long)h * n * n, n, i0, 1, lane);
      table_store(bias_s, table, n, i0, 1, lane);
    }
  }
  if (u_first < total && masked) {
    table_load(table, mask + (long long)(u_first % n_windows) * n * n, n, warp, kHeadsPerBlock, lane);
    table_store(mask_s, table, n, warp, kHeadsPerBlock, lane);
  }
  // the rsqrt estimate table (xla_rsqrt.cuh) as 16-bit words, resident for
  // the block's life
  uint16_t* rsqrt_s = reinterpret_cast<uint16_t*>(smem_mma + mma_smem_bytes<HD, NR, TEAMS>());
  xla_rsqrt_table_to_shared(rsqrt_s, threadIdx.x, 32 * kHeadsPerBlock * TEAMS);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float sc = active ? __ldg(scale + h) : 0.f;

  for (int u = u_first; u < total; u += u_step) {
    const int w = u % n_windows;
    const long long b = u / n_windows;
    const int u_next = u + u_step;

    // this window's mask and raw rows were fetched during the last window
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (masked) team_barrier(team);  // publishes the team's mask rows
    __syncwarp();

    float acc[NR][NR][2];
    if (active) {
      const bf16* vb =
          qkv + b * s_b + (long long)w * s_w + (long long)h * s_h + 2 * s_three;

      // q and k: the raw rows into registers (qn and kn take their place),
      // then each row normalised in f32 by the kChunks neighbouring lanes
      // that hold it
      {
        uint4 raw[2][kLoadIters];
#pragma unroll
        for (int it = 0; it < kLoadIters; ++it) {
          const int idx = it * 32 + lane;
          raw[0][it] = raw[1][it] = make_uint4(0u, 0u, 0u, 0u);
          if (idx / kChunks < n) {
            raw[0][it] = raw_s[idx];
            raw[1][it] = raw_s[kRows * kChunks + idx];
          }
        }
        __syncwarp();  // every lane holds its rows
        // every row's sum of squares first, then every rsqrt (independent
        // chains of a table load and two Newton steps, which overlap), then
        // the scaling
        float inv[2][kLoadIters];
#pragma unroll
        for (int which = 0; which < 2; ++which) {
#pragma unroll
          for (int it = 0; it < kLoadIters; ++it) {
            const uint32_t* wds = reinterpret_cast<const uint32_t*>(&raw[which][it]);
            float ss = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&wds[e]));
              ss = fmaf(f.x, f.x, ss);
              ss = fmaf(f.y, f.y, ss);
            }
#pragma unroll
            for (int off = 1; off < kChunks; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
            inv[which][it] = ss;
          }
        }
#pragma unroll
        for (int which = 0; which < 2; ++which) {
#pragma unroll
          for (int it = 0; it < kLoadIters; ++it)
            inv[which][it] = xla_rsqrt_floored(fmaxf(inv[which][it], 1e-12f), rsqrt_s);
        }
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          float* dst = which == 0 ? qn : kn;
#pragma unroll
          for (int it = 0; it < kLoadIters; ++it) {
            const int idx = it * 32 + lane;
            const int row = idx / kChunks, ch = idx % kChunks;
            const uint32_t* wds = reinterpret_cast<const uint32_t*>(&raw[which][it]);
            float x[8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&wds[e]));
              x[2 * e] = f.x * inv[which][it];
              x[2 * e + 1] = f.y * inv[which][it];
            }
            if (qk_bf16) {
#pragma unroll
              for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(__float2bfloat16(x[e]));
            }
            if (row < kRows) {  // rows n .. kRows - 1 are zeros
              float4* d4 = reinterpret_cast<float4*>(dst + row * kQStride + ch * 8);
              d4[0] = make_float4(x[0], x[1], x[2], x[3]);
              d4[1] = make_float4(x[4], x[5], x[6], x[7]);
            }
          }
        }
      }
      __syncwarp();

      // logits: acc[r][c][e] = qn[8r + g] . kn[8c + 2t + e], f32 FMAs in the
      // order of d
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < NR; ++c) acc[r][c][0] = acc[r][c][1] = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < HD; d0 += 4) {
        float4 qv[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r)
          qv[r] = *reinterpret_cast<const float4*>(qn + (8 * r + g) * kQStride + d0);
#pragma unroll
        for (int c = 0; c < NR; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 kv =
                *reinterpret_cast<const float4*>(kn + (8 * c + 2 * t + e) * kQStride + d0);
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              float a = acc[r][c][e];
              a = fmaf(qv[r].x, kv.x, a);
              a = fmaf(qv[r].y, kv.y, a);
              a = fmaf(qv[r].z, kv.z, a);
              a = fmaf(qv[r].w, kv.w, a);
              acc[r][c][e] = a;
            }
          }
        }
      }

      // v: asynchronous 16-byte copies that land while the softmax runs; rows past n zeroed (their weights are 0, but
      // 0 * garbage could be NaN)
      __syncwarp();  // every lane is done with qn and kn
      const uint32_t vs_addr = smem_u32(vs);
#pragma unroll
      for (int it = 0; it < kKeyPad * kChunks / 32; ++it) {
        const int idx = it * 32 + lane;
        const int row = idx / kChunks, ch = idx % kChunks;
        if (row < n) {
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                       :: "r"(vs_addr + (uint32_t)(row * kVStride + ch * 8) * 2u),
                          "l"(vb + (long long)row * s_n + ch * 8) : "memory");
        } else {
          *reinterpret_cast<uint4*>(vs + row * kVStride + ch * 8) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (!active) {  // a warp without a head: the barrier and the next mask
      if (masked) {
        if (u_next < total)
          table_load(table, mask + (long long)(u_next % n_windows) * n * n, n, warp, kHeadsPerBlock, lane);
        team_barrier(team);
        if (u_next < total) table_store(mask_s, table, n, warp, kHeadsPerBlock, lane);
      }
      continue;
    }

    // (dot * scale + bias) + mask, each step rounded as the JAX kernel does;
    // columns past n to -inf; then the row max, exp, the bf16 rounding and
    // the f32 sum of the rounded weights
    uint32_t pk[2 * kMTiles][2 * kKSteps];  // [r][c]: weights (e = 0, 1) as a bf16 pair
    float rsum[2 * kMTiles];
#pragma unroll
    for (int r = 0; r < 2 * kMTiles; ++r) {
      rsum[r] = 1.f;
#pragma unroll
      for (int c = 0; c < 2 * kKSteps; ++c) pk[r][c] = 0u;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      // every load of the row group first, with no branch between them; rows
      // and columns past n read what the tables hold and are dropped below
      const int row_off = (8 * r + g) * kTableStride + 2 * t;
      float2 bv[NR], mv[NR];
#pragma unroll
      for (int c = 0; c < NR; ++c)
        bv[c] = *reinterpret_cast<const float2*>(bias_s + row_off + 8 * c);
      if (masked) {
#pragma unroll
        for (int c = 0; c < NR; ++c)
          mv[c] = *reinterpret_cast<const float2*>(mask_s + row_off + 8 * c);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < NR; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float l = __fadd_rn(__fmul_rn(acc[r][c][e], sc), e == 0 ? bv[c].x : bv[c].y);
          if (masked) l = __fadd_rn(l, e == 0 ? mv[c].x : mv[c].y);
          if (8 * c + 2 * t + e >= n) l = -INFINITY;
          acc[r][c][e] = l;
          mx = fmaxf(mx, l);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < NR; ++c) {
        bf162 p = __floats2bfloat162_rn(expf(acc[r][c][0] - mx), expf(acc[r][c][1] - mx));
        const float2 f = __bfloat1622float2(p);
        s += f.x + f.y;
        pk[r][c] = *reinterpret_cast<uint32_t*>(&p);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      rsum[r] = s;
    }

    // the next window's raw rows (a group after v's) and mask rows: the
    // loads fly during the P V product and are stored after it, once the
    // whole team is past this window's mask
    if (u_next < total) {
      prefetch_qk(u_next);
      if (masked)
        table_load(table, mask + (long long)(u_next % n_windows) * n * n, n, warp, kHeadsPerBlock, lane);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // P V on the tensor cores, f32 accumulation
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();  // every lane's v copies and zeros are visible
    float o[kMTiles][kNTiles][4];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
        o[m][nt][0] = o[m][nt][1] = o[m][nt][2] = o[m][nt][3] = 0.f;
    const uint32_t vs_addr = smem_u32(vs);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      // B fragments of this step's 16 keys for every n8 tile: one ldmatrix.x4
      // covers two tiles (lanes 0-7 / 8-15: keys 0-7 / 8-15 of the first,
      // lanes 16-31 likewise of the second)
      uint32_t bfrag[kNTiles][2];
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        const int key = 16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = 16 * np + (lane >> 4) * 8;
        const uint32_t addr = vs_addr + (uint32_t)(key * kVStride + col) * 2u;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(bfrag[2 * np][0]), "=r"(bfrag[2 * np][1]),
                       "=r"(bfrag[2 * np + 1][0]), "=r"(bfrag[2 * np + 1][1])
                     : "r"(addr));
      }
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        const uint32_t a0 = pk[2 * m][2 * ks], a1 = pk[2 * m + 1][2 * ks];
        const uint32_t a2 = pk[2 * m][2 * ks + 1], a3 = pk[2 * m + 1][2 * ks + 1];
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(o[m][nt][0]), "+f"(o[m][nt][1]), "+f"(o[m][nt][2]), "+f"(o[m][nt][3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(bfrag[nt][0]), "r"(bfrag[nt][1]));
        }
      }
    }

    if (masked) {
      team_barrier(team);
      if (u_next < total) table_store(mask_s, table, n, warp, kHeadsPerBlock, lane);
    }

    // divide, round, and stage the head's (n, HD) tile so that it leaves 16
    // bytes a thread. o / s as the division routine computes it, with the
    // reciprocal taken once a row: q = o * (1 / s), then one correction by the
    // exact remainder.
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 2 * m + half;
        if (r < NR) {
          const float s = rsum[r];
          const float inv = 1.f / s;
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
            float y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = o[m][nt][2 * half + e];
              const float q0 = x * inv;
              y[e] = fmaf(fmaf(-s, q0, x), inv, q0);
            }
            *reinterpret_cast<bf162*>(stage + (8 * r + g) * HD + 8 * nt + 2 * t) =
                __floats2bfloat162_rn(y[0], y[1]);
          }
        }
      }
    }
    __syncwarp();
    bf16* ob = out + b * o_b + (long long)w * o_w + (long long)h * o_h;
    for (int idx = lane; idx < n * kChunks; idx += 32) {
      const int row = idx / kChunks, ch = idx % kChunks;
      *reinterpret_cast<uint4*>(ob + (long long)row * o_n + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + row * HD + ch * 8);
    }
    __syncwarp();  // the area is rewritten for the warp's next window
  }
}

template <int HD, int NR, int TEAMS>
cudaError_t launch_mma(const void* qkv, void* out, const float* scale, const float* bias,
                       const float* mask, int batch, int n_windows, int n, int heads,
                       long long s_b, long long s_w, long long s_n, long long s_three, long long s_h,
                       long long o_b, long long o_w, long long o_n, long long o_h, int qk_bf16,
                       cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<HD, NR, TEAMS>() + kXlaRsqrtSharedBytes;
  static_assert(bytes <= 232448, "a block's shared memory on sm_90");
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(win_attn_mma_kernel<HD, NR, TEAMS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // one block an SM, each on one group of four heads for its whole life
  const long long total = (long long)batch * n_windows;
  if (total > INT_MAX) return cudaErrorInvalidValue;
  const int groups = (heads + kHeadsPerBlock - 1) / kHeadsPerBlock;
  int device = 0, sms = 0;  // of the current device, asked at every launch
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  long long per_group = sms / groups > 0 ? sms / groups : 1;
  const long long most = (total + TEAMS - 1) / TEAMS;
  if (per_group > most) per_group = most;
  if (groups > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)per_group, (unsigned)groups);
  win_attn_mma_kernel<HD, NR, TEAMS><<<grid, 32 * kHeadsPerBlock * TEAMS, bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), scale, bias, mask, batch, n_windows,
      n, heads, s_b, s_w, s_n, s_three, s_h, o_b, o_w, o_n, o_h, qk_bf16);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. variant: 0 = "rows", 1 = "mma"
// (bfloat16; head_dim 16 or 32 with n <= 64, or head_dim 64 with n <= 56;
// qkv and out 16-byte aligned with strides that are multiples of 8). Strides are in elements; the last
// (head_dim) stride of qkv and out is 1. scale (H,), bias (H, n, n) and mask
// (nW, n, n) are contiguous f32; mask may be null (unshifted blocks).
// rsqrt_table: the host's 2048 rsqrt estimates (xla_rsqrt.cuh), copied to
// the device at its first launch there.
extern "C" int window_cosine_attention_launch(
    const void* qkv, void* out, const void* scale, const void* bias, const void* mask,
    int batch, int n_windows, int n, int heads, int head_dim, int dtype_code, int qk_bf16,
    int variant,
    long long s_b, long long s_w, long long s_n, long long s_three, long long s_h,
    long long o_b, long long o_w, long long o_n, long long o_h, const void* rsqrt_table,
    void* stream) {
  if (batch <= 0 || n_windows <= 0 || heads <= 0 || n <= 0 || n > kMaxTokens)
    return (int)cudaErrorInvalidValue;
  const cudaError_t table_err = xla_rsqrt_ensure_table(rsqrt_table);
  if (table_err != cudaSuccess) return (int)table_err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* ma = static_cast<const float*>(mask);
#define KET_WIN_ARGS                                                                      \
  qkv, out, sc, bi, ma, batch, n_windows, n, heads, s_b, s_w, s_n, s_three, s_h, o_b, o_w, \
      o_n, o_h, qk_bf16, st
  if (variant == 1) {
    if (dtype_code != 1 || n > 64) return (int)cudaErrorInvalidValue;
    const uintptr_t ptrs = (uintptr_t)qkv | (uintptr_t)out;
    const long long strides = s_b | s_w | s_n | s_three | s_h | o_b | o_w | o_n | o_h;
    if ((ptrs & 15) || (strides & 7)) return (int)cudaErrorMisalignedAddress;
    // two windows a block where shared memory holds them (n <= 56, hd <= 32)
    if (n <= 56) {
      if (head_dim == 16) return (int)launch_mma<16, 7, 2>(KET_WIN_ARGS);
      if (head_dim == 32) return (int)launch_mma<32, 7, 2>(KET_WIN_ARGS);
      if (head_dim == 64) return (int)launch_mma<64, 7, 1>(KET_WIN_ARGS);
    } else {
      if (head_dim == 16) return (int)launch_mma<16, 8, 1>(KET_WIN_ARGS);
      if (head_dim == 32) return (int)launch_mma<32, 8, 1>(KET_WIN_ARGS);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
#define KET_WIN_CASE(T, HD) \
  if (head_dim == HD) return (int)launch_rows<T, HD>(KET_WIN_ARGS)
#define KET_WIN_DTYPE(T) \
  KET_WIN_CASE(T, 8);    \
  KET_WIN_CASE(T, 16);   \
  KET_WIN_CASE(T, 24);   \
  KET_WIN_CASE(T, 32);   \
  KET_WIN_CASE(T, 40);   \
  KET_WIN_CASE(T, 48);   \
  KET_WIN_CASE(T, 56);   \
  KET_WIN_CASE(T, 64)
  if (dtype_code == 0) {
    KET_WIN_DTYPE(float);
  } else if (dtype_code == 1) {
    KET_WIN_DTYPE(__nv_bfloat16);
  }
#undef KET_WIN_DTYPE
#undef KET_WIN_CASE
#undef KET_WIN_ARGS
  return (int)cudaErrorInvalidValue;
}
