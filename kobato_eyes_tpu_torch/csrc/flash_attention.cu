// Flash attention for the ViT's attn_impl="flash": a forward that saves the
// row max m and the row sum l, and the two backward kernels (dK/dV, dQ).
//
// Replaces what kobato_eyes_tpu/models/vit.py:_flash_attention_padded runs:
// JAX's Pallas TPU flash attention (jax/experimental/pallas/ops/tpu/
// flash_attention.py, jax 0.9.0): the forward pallas_call of
// _flash_attention_impl (body _flash_attention_kernel_single_batch), the
// dK/dV pallas_call (_flash_attention_dkv_kernel) and the dQ pallas_call
// (_flash_attention_dq_kernel) under its custom_vjp. It computes what those
// bodies compute over the T real tokens:
//
//   forward:  s = (q k^T in f32) * scale     (scaled after the product)
//             online row max m and row sum l in f32, p = exp(s - m),
//             o = (p rounded to v's dtype) v, f32 accumulation, / l
//   backward: p = exp(s - m) * (1 / l)
//             dV = (p rounded to dO's dtype)^T dO
//             dP = dO v^T
//             dS = ((dP - di) * p) * scale,   di = rowsum(o * dO) in f32
//             dK = (dS rounded)^T q,  dQ = (dS rounded) k
//
// The JAX version pads T to a multiple of 128 and masks the padded keys with
// segment ids; exp sends them to 0. Here the keys and rows past T are cut by
// bounds checks, which is the same function.
//
// Bound on the card: operations. At ViT-B/448 (T = 785, H = 12, D = 64) the
// forward at batch 32 is 4 T^2 D B H = 60.6 GFLOP against 154 MB moved, and
// the backward at batch 16 computes seven T x T x D products (S and dP in
// both kernels, dV, dK, dQ), 106 GFLOP. On the TPU, the grid walks the key
// blocks in order on one core and carries m, l and the accumulator in VMEM
// scratch; here a block owns a 64-row tile (of q rows, or of keys for dK/dV)
// and loops over the other axis itself, so nothing crosses blocks and no
// atomics are needed: the dK/dV kernel sums over the q rows inside the
// block, the dQ kernel over the keys.
//
// Three designs. "fma" (forward and backward for float32, and for bfloat16
// views the others cannot copy): every product f32 FMAs out of shared
// memory, for float32 (tensor cores would mean TF32, which the port does
// not use) and for bfloat16 alike (bf16 values widen to f32 exactly as they
// are loaded; bf16 products are exact in f32). 256 threads a block; thread
// (tr, tc) = (tid / 16, tid % 16) owns rows tr + 16 i (i < 4) and columns
// tc + 16 j of each 64 x 64 tile, so a row's 64 columns sit on the 16
// lanes of one half-warp and its max and sum reduce by shuffles. The head
// width is padded to DP = 32, 64 or 128 with zeros (D = 48 runs as 64).
// q, k, v and dO are read one element at a time through their strides, so
// any view with a unit last stride is taken, aligned or not. Two shared
// loads feed four FMAs: ~20 TFLOP/s on an H100 this way.
//
// "wgmma" forward (bfloat16 whose q, k and v rows are 16-byte aligned with
// strides that are multiples of 8: the ViT's packed projection): the
// tensor-core body of head_resident_attention.cu (kernel 1), shared through
// attention_wgmma.cuh. Two warpgroups a block share each 64-key K/V tile of
// a three-stage cp.async ring; S = Q K^T by wgmma into registers, the online
// softmax on the fragment, P rounded to bf16 there as the register A
// operand of O += P V, and S of the next tile issued together with O += P V
// of this one. It keeps this file's arithmetic, not kernel 1's (its FLASH
// instance): no bf16 pre-scale of q, l of the unrounded p, m and l written.
//
// "wgmma" backward (bfloat16 whose q, k, v and dO are aligned so): one
// warpgroup a block, every product a wgmma with f32 accumulation out of
// swizzled shared memory (wgmma.cuh), S and dP in registers, P and dS
// formed there with the same arithmetic and rounded to bf16 as the
// register A operand of the next product, so neither touches shared
// memory. dK/dV owns 64 keys (K, V staged once) and streams the q tiles,
// with their dO, m, 1 / l and di, through a cp.async ring; dK and dV stay
// in registers over the whole loop. dQ owns 64 q rows (Q, dO staged once)
// and streams the K, V tiles.
//
// Both "wgmma" designs round the head width up to 16, the wgmma depth (the
// columns past d are zeros in shared memory).
//
// The scaling is __fmul_rn, so that the compiler cannot fuse it into the
// subtraction of m that follows: JAX rounds the scaled logits first.
//
// Plain C entries for ctypes: each returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTile = 64;      // q rows or keys of a tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 entries of a tile each
constexpr int kPLd = kTile + 1;  // row stride of a 64 x 64 tile in shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// x rounded to T and widened back: what astype(T) of an f32 value gives
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// rows r0 .. r0 + 63 of a (T, D) view with row stride `st` into a
// [64][DP + 1] f32 tile; rows past T and columns past d are zero
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int t_len, int d, long long st) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP, c = i - (i / DP) * DP;
    float x = 0.f;
    if (r0 + r < t_len && c < d) x = to_f(src[(long long)(r0 + r) * st + c]);
    dst[r * (DP + 1) + c] = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[i][j] += sum over dd of a[(tr + 16 i) * (DP + 1) + dd] * b[(tc + 16 j) * (DP + 1) + dd]:
// a 64 x 64 tile of A B^T with both tiles row-major in shared memory
template <int DP>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* a, const float* b,
                                         int tr, int tc) {
  constexpr int LD = DP + 1;
#pragma unroll 4
  for (int dd = 0; dd < DP; ++dd) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(tr + 16 * i) * LD + dd];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tc + 16 * j) * LD + dd];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per 64 q rows of one (batch, head), looping over keys
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * kTile * (DP + 1) + kTile * kPLd);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                 int t_len, int heads, int d,
                 long long in_sb, long long in_st, long long in_sh,
                 long long out_sb, long long out_st, long long out_sh, float scale) {
  constexpr int LD = DP + 1;
  constexpr int NJ = DP / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;               // [64][LD]
  float* ks = qs + kTile * LD;    // [64][LD]
  float* vs = ks + kTile * LD;    // [64][LD]
  float* ps = vs + kTile * LD;    // [64][kPLd]: p of this tile, rounded to v's dtype

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const long long base = (long long)b * in_sb + (long long)h * in_sh;
  load_tile<T, DP>(qs, q + base, q0, t_len, d, in_st);

  float acc[4][NJ];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < t_len; k0 += kTile) {
    __syncthreads();  // the previous tile's ks, vs, ps are no longer read
    load_tile<T, DP>(ks, k + base, k0, t_len, d, in_st);
    load_tile<T, DP>(vs, v + base, k0, t_len, d, in_st);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    tile_abt<DP>(s, qs, ks, tr, tc);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // scaled in f32 after the product; keys past T drop out
        s[i][j] = k0 + tc + 16 * j < t_len ? __fmul_rn(s[i][j], scale) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds a key below T, so the new max is finite
      const float m_new = fmaxf(m_run[i], half_warp_max(mx));
      const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);  // keys past T: exp(-inf) = 0
        psum += p;
        ps[(tr + 16 * i) * kPLd + tc + 16 * j] = round_to<T>(p);
      }
      l_run[i] = l_run[i] * alpha + half_warp_sum(psum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V over this tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(tr + 16 * i) * kPLd + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[kk * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }

  T* ob = o + (long long)b * out_sb + (long long)h * out_sh;
  const long long ml = ((long long)b * heads + h) * t_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= t_len) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tc + 16 * j;
      if (c < d) ob[(long long)row * out_st + c] = from_f<T>(acc[i][j] / l_run[i]);
    }
    if (tc == 0) {
      m_out[ml + row] = m_run[i];
      l_out[ml + row] = l_run[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward dK/dV: one block per 64 keys of one (batch, head), looping over
// the q rows
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kTile * (DP + 1) + 2 * kTile * kPLd + 3 * kTile);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ m,
                     const float* __restrict__ l, const float* __restrict__ di,
                     T* __restrict__ dk, T* __restrict__ dv,
                     int t_len, int heads, int d,
                     long long in_sb, long long in_st, long long in_sh,
                     long long do_sb, long long do_st, long long do_sh,
                     long long g_sb, long long g_st, long long g_sh, float scale) {
  constexpr int LD = DP + 1;
  constexpr int NJ = DP / 16;
  extern __shared__ float smem[];
  float* ks = smem;                // [64][LD] this block's keys
  float* vs = ks + kTile * LD;     // [64][LD]
  float* qs = vs + kTile * LD;     // [64][LD] the q tile
  float* dos = qs + kTile * LD;    // [64][LD] its dO
  float* ps = dos + kTile * LD;    // [64 q][kPLd] p rounded to dO's dtype
  float* dss = ps + kTile * kPLd;  // [64 q][kPLd] dS rounded to dO's dtype
  float* m_s = dss + kTile * kPLd; // [64] the q tile's m, 1 / l, di
  float* linv_s = m_s + kTile;
  float* di_s = linv_s + kTile;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kTile;
  const long long base = (long long)b * in_sb + (long long)h * in_sh;
  const long long do_base = (long long)b * do_sb + (long long)h * do_sh;
  const long long ml = ((long long)b * heads + h) * t_len;
  load_tile<T, DP>(ks, k + base, k0, t_len, d, in_st);
  load_tile<T, DP>(vs, v + base, k0, t_len, d, in_st);

  // keys tr + 16 i, columns tc + 16 j
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  for (int q0 = 0; q0 < t_len; q0 += kTile) {
    __syncthreads();  // the previous q tile's qs, dos, ps, dss are no longer read
    load_tile<T, DP>(qs, q + base, q0, t_len, d, in_st);
    load_tile<T, DP>(dos, dout + do_base, q0, t_len, d, do_st);
    if (tid < kTile) {
      const int row = q0 + tid;
      const bool ok = row < t_len;
      m_s[tid] = ok ? m[ml + row] : 0.f;
      linv_s[tid] = ok ? 1.f / l[ml + row] : 0.f;
      di_s[tid] = ok ? di[ml + row] : 0.f;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: q rows tr + 16 i, keys tc + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    tile_abt<DP>(s, qs, ks, tr, tc);
    tile_abt<DP>(dp, dos, vs, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const bool row_ok = q0 + r < t_len;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        float p = 0.f;  // rows and keys past T take no part
        if (row_ok && k0 + c < t_len) p = expf(__fmul_rn(s[i][j], scale) - m_s[r]) * linv_s[r];
        const float ds = ((dp[i][j] - di_s[r]) * p) * scale;
        ps[r * kPLd + c] = round_to<T>(p);
        dss[r * kPLd + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over this tile's q rows
#pragma unroll 2
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], dsv[4], dov[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[qq * kPLd + tr + 16 * i];
        dsv[i] = dss[qq * kPLd + tr + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dov[j] = dos[qq * LD + tc + 16 * j];
        qv[j] = qs[qq * LD + tc + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
      }
    }
  }

  const long long g_base = (long long)b * g_sb + (long long)h * g_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr + 16 * i;
    if (key >= t_len) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tc + 16 * j;
      if (c < d) {
        const long long off = g_base + (long long)key * g_st + c;
        dk[off] = from_f<T>(dk_acc[i][j]);
        dv[off] = from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward dQ: one block per 64 q rows of one (batch, head), looping over keys
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kTile * (DP + 1) + kTile * kPLd);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ m,
                    const float* __restrict__ l, const float* __restrict__ di,
                    T* __restrict__ dq,
                    int t_len, int heads, int d,
                    long long in_sb, long long in_st, long long in_sh,
                    long long do_sb, long long do_st, long long do_sh,
                    long long g_sb, long long g_st, long long g_sh, float scale) {
  constexpr int LD = DP + 1;
  constexpr int NJ = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;                // [64][LD] this block's q rows
  float* dos = qs + kTile * LD;    // [64][LD] their dO
  float* ks = dos + kTile * LD;    // [64][LD] the key tile
  float* vs = ks + kTile * LD;     // [64][LD]
  float* dss = vs + kTile * LD;    // [64 q][kPLd] dS rounded to k's dtype

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const long long base = (long long)b * in_sb + (long long)h * in_sh;
  const long long do_base = (long long)b * do_sb + (long long)h * do_sh;
  const long long ml = ((long long)b * heads + h) * t_len;
  load_tile<T, DP>(qs, q + base, q0, t_len, d, in_st);
  load_tile<T, DP>(dos, dout + do_base, q0, t_len, d, do_st);

  // this thread's rows tr + 16 i: m, 1 / l, di (rows past T take no part)
  float m_r[4], linv_r[4], di_r[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    row_ok[i] = row < t_len;
    m_r[i] = row_ok[i] ? m[ml + row] : 0.f;
    linv_r[i] = row_ok[i] ? 1.f / l[ml + row] : 0.f;
    di_r[i] = row_ok[i] ? di[ml + row] : 0.f;
  }
  float dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < t_len; k0 += kTile) {
    __syncthreads();  // the previous key tile's ks, vs, dss are no longer read
    load_tile<T, DP>(ks, k + base, k0, t_len, d, in_st);
    load_tile<T, DP>(vs, v + base, k0, t_len, d, in_st);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    tile_abt<DP>(s, qs, ks, tr, tc);
    tile_abt<DP>(dp, dos, vs, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        float p = 0.f;
        if (row_ok[i] && k0 + c < t_len) p = expf(__fmul_rn(s[i][j], scale) - m_r[i]) * linv_r[i];
        const float ds = ((dp[i][j] - di_r[i]) * p) * scale;
        dss[(tr + 16 * i) * kPLd + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dQ += dS K over this tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(tr + 16 * i) * kPLd + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = ks[kk * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq_acc[i][j] = fmaf(dsv[i], kv[j], dq_acc[i][j]);
      }
    }
  }

  const long long g_base = (long long)b * g_sb + (long long)h * g_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const int row = q0 + tr + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tc + 16 * j;
      if (c < d) dq[g_base + (long long)row * g_st + c] = from_f<T>(dq_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward on the tensor cores ("wgmma", bfloat16): one warpgroup a block
// ---------------------------------------------------------------------------
//
// The same functions as the two kernels above, with every product a wgmma
// (bf16 operands, f32 accumulation) out of swizzled shared memory
// (wgmma.cuh) and the elementwise steps on the accumulator fragments in
// registers. D16 is the head width rounded up to 16, the wgmma depth;
// columns d .. D16 - 1 are zero-filled in shared memory, which leaves every
// product over D as it is, and output columns past d are not written. q, k,
// v and dO are copied 16 bytes at a time (rows 16-byte aligned, strides
// multiples of 8), through a ring of STAGES tiles.

constexpr int kWgThreads = 128;

// m, l and di of rows r0 .. r0 + 63 of one (batch, head) into [64] f32
// arrays, zero past T: thread `tid` < 64 copies row tid's three values
__device__ __forceinline__ void load_row_params_async(uint32_t m_dst, uint32_t l_dst, uint32_t di_dst,
                                                      const float* m, const float* l, const float* di,
                                                      long long ml, int r0, int t_len, int tid) {
  if (tid >= kTile) return;
  const bool ok = r0 + tid < t_len;
  const long long off = ok ? ml + r0 + tid : 0;
  const int bytes = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(m_dst + 4 * tid), "l"(m + off), "r"(bytes)
               : "memory");
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(l_dst + 4 * tid), "l"(l + off), "r"(bytes)
               : "memory");
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(di_dst + 4 * tid), "l"(di + off), "r"(bytes)
               : "memory");
}

// Writes this warp's 16 rows (16 * warp ..) of a 64 x D16 accumulator
// fragment, rounded to bf16, into the tile at `tile` (no longer read), then
// from there to rows r0 + 16 * warp .. of a (T, d) view with row stride
// `st`: 16 bytes a thread where the view allows it. FULL: d == D16.
template <int D16, bool FULL>
__device__ __forceinline__ void store_rows(const float* acc, uint8_t* tile, bf16* dst, int r0, int t_len,
                                           int d, long long st, bool vec_ok, int warp, int lane) {
  using L = SwTile<D16, kTile>;
  const int g = lane >> 2, quad = lane & 3, wrow = 16 * warp;
#pragma unroll
  for (int j = 0; j < D16 / 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + L::offset(wrow + g, j) + 4 * quad) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + L::offset(wrow + g + 8, j) + 4 * quad) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * L::kChunks; i += 32) {
    const int r = wrow + i / L::kChunks, c = i % L::kChunks;
    if (r0 + r >= t_len || (!FULL && 8 * c >= d)) continue;
    bf16* out = dst + (long long)(r0 + r) * st + 8 * c;
    const uint8_t* src = tile + L::offset(r, c);
    if (vec_ok && d - 8 * c >= 8) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
    } else {
      const int n = d - 8 * c < 8 ? d - 8 * c : 8;
      for (int e = 0; e < n; ++e) out[e] = reinterpret_cast<const bf16*>(src)[e];
    }
  }
}

// 16-byte stores into a view: its address and strides allow them
__device__ __forceinline__ bool vec_view(const void* p, long long sb, long long st, long long sh) {
  return ((uintptr_t)p & 15) == 0 && ((sb | st | sh) & 7) == 0;
}

template <int D16>
__host__ __device__ constexpr int wg_stages() { return D16 <= 64 ? 3 : 2; }

template <int D16>
constexpr size_t dkv_wgmma_smem_bytes() {
  // K, V; a ring of (Q, dO) tiles and their rows' m, 1 / l, di; alignment room
  return (2 + 2 * wg_stages<D16>()) * (size_t)SwTile<D16, kTile>::kBytes +
         wg_stages<D16>() * 3 * kTile * sizeof(float) + 1024;
}

// dK/dV: a block owns 64 keys of one (batch, head) and walks over the q
// tiles. S^T = K Q^T and dP^T = V dO^T (a warp owns 16 keys, its lanes the
// fragment's q columns); P^T and dS^T formed in registers and rounded to
// bf16 as the A fragments of dV += P^T dO and dK += dS^T Q, whose B operands
// are the dO and Q tiles read MN-major. dK and dV stay in registers over the
// whole loop. FULL: d == D16, no column is padded (wgmma.cuh).
// Blocks an SM the register budget must leave room for: three up to D = 64
// (at most 168 registers a thread; the dK/dV body at 171 ran two blocks an
// SM and took 0.43 against 0.32 ms at ViT-B/448 B = 16 on an H100), one
// above.
template <int D16>
__host__ __device__ constexpr int wg_min_blocks() { return D16 <= 64 ? 3 : 1; }

template <int D16, bool FULL>
__global__ void __launch_bounds__(kWgThreads, wg_min_blocks<D16>())
flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const bf16* __restrict__ dout, const float* __restrict__ m,
                           const float* __restrict__ l, const float* __restrict__ di,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int t_len, int heads, int d,
                           long long in_sb, long long in_st, long long in_sh,
                           long long do_sb, long long do_st, long long do_sh,
                           long long g_sb, long long g_st, long long g_sh, float scale) {
  using L = SwTile<D16, kTile>;
  constexpr int S = wg_stages<D16>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  uint8_t* base = smem_raw + pad;
  const uint32_t ks_addr = raw_addr + pad;
  const uint32_t vs_addr = ks_addr + L::kBytes;
  const uint32_t qs_addr = vs_addr + L::kBytes;           // [S] Q tiles
  const uint32_t dos_addr = qs_addr + S * L::kBytes;      // [S] dO tiles
  const uint32_t par_addr = dos_addr + S * L::kBytes;     // [S][3][64]: m, 1 / l, di
  const float* par = reinterpret_cast<const float*>(base + (par_addr - ks_addr));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, quad = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kTile;
  const long long in_base = (long long)b * in_sb + (long long)h * in_sh;
  const bf16* qb = q + in_base;
  const bf16* dob = dout + (long long)b * do_sb + (long long)h * do_sh;
  const long long ml = ((long long)b * heads + h) * t_len;
  const int n_tiles = (t_len + kTile - 1) / kTile;

  auto load_tile = [&](int it) {
    const int st = it % S, q0 = it * kTile;
    load_tile_async<D16, kTile, FULL>(qs_addr + st * L::kBytes, qb, q0, t_len, d, in_st, tid, kWgThreads);
    load_tile_async<D16, kTile, FULL>(dos_addr + st * L::kBytes, dob, q0, t_len, d, do_st, tid, kWgThreads);
    const uint32_t p = par_addr + st * 3 * kTile * 4;
    load_row_params_async(p, p + kTile * 4, p + 2 * kTile * 4, m, l, di, ml, q0, t_len, tid);
  };
  {
    const uint32_t dsts[2] = {ks_addr, vs_addr};
    const bf16* const srcs[2] = {k + in_base, v + in_base};
    load_tiles_async<D16, kTile, FULL>(dsts, srcs, k0, t_len, d, in_st, tid, kWgThreads);
  }
#pragma unroll
  for (int it = 0; it < S - 1; ++it) {
    if (it < n_tiles) load_tile(it);
    cp_async_commit();
  }

  // this thread's keys (fragment rows); keys past T take no part
  const bool key0_ok = k0 + 16 * warp + g < t_len, key1_ok = k0 + 16 * warp + g + 8 < t_len;
  float dk_acc[D16 / 2], dv_acc[D16 / 2];
#pragma unroll
  for (int i = 0; i < D16 / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % S;
    cp_async_wait<S - 2>();  // tile it has landed (this thread's copies)
    if (tid < kTile) {       // the row whose m, l, di this thread copied: 1 / l in place of l
      float* lp = reinterpret_cast<float*>(base + (par_addr - ks_addr)) + st * 3 * kTile + kTile + tid;
      *lp = it * kTile + tid < t_len ? 1.f / *lp : 0.f;
    }
    fence_proxy_async();
    // every thread's copies of tile it are visible, and every warp is done
    // with tile it - 1, whose stage the copies of tile it + S - 1 refill
    __syncthreads();
    if (it + S - 1 < n_tiles) load_tile(it + S - 1);
    cp_async_commit();

    const uint64_t q_desc = L::desc(qs_addr + st * L::kBytes), do_desc = L::desc(dos_addr + st * L::kBytes);
    const uint64_t k_desc = L::desc(ks_addr), v_desc = L::desc(vs_addr);  // made here: fewer live registers
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D16 / 16; ++kk) {
      wgmma_ss_n64(s, k_desc + L::kmajor(kk), q_desc + L::kmajor(kk), kk > 0);
      wgmma_ss_n64(dp, v_desc + L::kmajor(kk), do_desc + L::kmajor(kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    // P^T and dS^T: fragment column c = 8j + 2 quad + e is q row it * 64 + c
    const float* pm = par + st * 3 * kTile;
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const float2 mc = *reinterpret_cast<const float2*>(pm + c);
      const float2 lc = *reinterpret_cast<const float2*>(pm + kTile + c);
      const float2 dc = *reinterpret_cast<const float2*>(pm + 2 * kTile + c);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = e < 2 ? key0_ok : key1_ok;
        const float mv = e & 1 ? mc.y : mc.x, lv = e & 1 ? lc.y : lc.x, dv_ = e & 1 ? dc.y : dc.x;
        p[e] = ok ? expf(__fmul_rn(s[4 * j + e], scale) - mv) * lv : 0.f;
        ds[e] = ((dp[4 * j + e] - dv_) * p[e]) * scale;
      }
      pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO, dK += dS^T Q: 16 q rows a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_rs_tile<D16, kTile>(dv_acc, pa[kk], do_desc, kk);
      wgmma_rs_tile<D16, kTile>(dk_acc, dsa[kk], q_desc, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
  }
  __syncthreads();  // every warp is past its last product: K and V are free

  const long long g_base = (long long)b * g_sb + (long long)h * g_sh;
  const bool vec_ok = vec_view(dk, g_sb, g_st, g_sh) && vec_view(dv, g_sb, g_st, g_sh);
  store_rows<D16, FULL>(dk_acc, base, dk + g_base, k0, t_len, d, g_st, vec_ok, warp, lane);
  store_rows<D16, FULL>(dv_acc, base + L::kBytes, dv + g_base, k0, t_len, d, g_st, vec_ok, warp, lane);
}

template <int D16>
constexpr size_t dq_wgmma_smem_bytes() {
  // Q, dO; a ring of (K, V) tiles; alignment room
  return (2 + 2 * wg_stages<D16>()) * (size_t)SwTile<D16, kTile>::kBytes + 1024;
}

// dQ: a block owns 64 q rows of one (batch, head) and walks over the key
// tiles. S = Q K^T and dP = dO V^T; dS formed in registers and rounded to
// bf16 as the A fragment of dQ += dS K, whose B operand is the K tile read
// MN-major. FULL as for dK/dV.
template <int D16, bool FULL>
__global__ void __launch_bounds__(kWgThreads, wg_min_blocks<D16>())
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          const bf16* __restrict__ dout, const float* __restrict__ m,
                          const float* __restrict__ l, const float* __restrict__ di,
                          bf16* __restrict__ dq,
                          int t_len, int heads, int d,
                          long long in_sb, long long in_st, long long in_sh,
                          long long do_sb, long long do_st, long long do_sh,
                          long long g_sb, long long g_st, long long g_sh, float scale) {
  using L = SwTile<D16, kTile>;
  constexpr int S = wg_stages<D16>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  uint8_t* base = smem_raw + pad;
  const uint32_t qs_addr = raw_addr + pad;
  const uint32_t dos_addr = qs_addr + L::kBytes;
  const uint32_t ks_addr = dos_addr + L::kBytes;      // [S] K tiles
  const uint32_t vs_addr = ks_addr + S * L::kBytes;   // [S] V tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, quad = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const long long in_base = (long long)b * in_sb + (long long)h * in_sh;
  const bf16* kb = k + in_base;
  const bf16* vb = v + in_base;
  const long long ml = ((long long)b * heads + h) * t_len;
  const int n_tiles = (t_len + kTile - 1) / kTile;

  auto load_tile = [&](int it) {
    const int st = it % S;
    const uint32_t dsts[2] = {ks_addr + st * L::kBytes, vs_addr + st * L::kBytes};
    const bf16* const srcs[2] = {kb, vb};
    load_tiles_async<D16, kTile, FULL>(dsts, srcs, it * kTile, t_len, d, in_st, tid, kWgThreads);
  };
  load_tile_async<D16, kTile, FULL>(qs_addr, q + in_base, q0, t_len, d, in_st, tid, kWgThreads);
  load_tile_async<D16, kTile, FULL>(dos_addr, dout + (long long)b * do_sb + (long long)h * do_sh, q0, t_len, d, do_st,
                              tid, kWgThreads);
#pragma unroll
  for (int it = 0; it < S - 1; ++it) {
    if (it < n_tiles) load_tile(it);
    cp_async_commit();
  }

  // this thread's rows g and g + 8 of its warp's 16: m, 1 / l, di (rows past
  // T take no part)
  float m_r[2], linv_r[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    const bool ok = row < t_len;
    m_r[i] = ok ? m[ml + row] : 0.f;
    linv_r[i] = ok ? 1.f / l[ml + row] : 0.f;
    di_r[i] = ok ? di[ml + row] : 0.f;
  }
  float dq_acc[D16 / 2];
#pragma unroll
  for (int i = 0; i < D16 / 2; ++i) dq_acc[i] = 0.f;
  const uint64_t q_desc = L::desc(qs_addr), do_desc = L::desc(dos_addr);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % S, c0 = it * kTile;
    cp_async_wait<S - 2>();
    fence_proxy_async();
    __syncthreads();
    if (it + S - 1 < n_tiles) load_tile(it + S - 1);
    cp_async_commit();

    const uint64_t k_desc = L::desc(ks_addr + st * L::kBytes), v_desc = L::desc(vs_addr + st * L::kBytes);
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D16 / 16; ++kk) {
      wgmma_ss_n64(s, q_desc + L::kmajor(kk), k_desc + L::kmajor(kk), kk > 0);
      wgmma_ss_n64(dp, do_desc + L::kmajor(kk), v_desc + L::kmajor(kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    // dS: fragment column c = 8j + 2 quad + e is key c0 + c (past T: p = 0)
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = c0 + 8 * j + 2 * quad + (e & 1) < t_len
                            ? expf(__fmul_rn(s[4 * j + e], scale) - m_r[i]) * linv_r[i] : 0.f;
        ds[e] = ((dp[4 * j + e] - di_r[i]) * p) * scale;
      }
      dsa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K: 16 keys a step, K rows are the reduction axis
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) wgmma_rs_tile<D16, kTile>(dq_acc, dsa[kk], k_desc, kk);
    wgmma_commit();
    wgmma_wait_all();
  }
  __syncthreads();  // every warp is past its last product: Q is free

  const long long g_base = (long long)b * g_sb + (long long)h * g_sh;
  store_rows<D16, FULL>(dq_acc, base, dq + g_base, q0, t_len, d, g_st, vec_view(dq, g_sb, g_st, g_sh), warp, lane);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Dynamic shared memory above 48 KB needs the attribute, set once per
// kernel and device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (*configured >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 32) *configured |= 1u << dev;
  return err;
}

struct Shape {
  int batch, t_len, heads, d;
};

template <typename T, int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                       Shape sh, const long long* in_s, const long long* out_s, float scale,
                       cudaStream_t stream) {
  static unsigned configured = 0;
  constexpr size_t bytes = fwd_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DP>, bytes, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.t_len + kTile - 1) / kTile, sh.heads, sh.batch);
  flash_fwd_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m, l, sh.t_len, sh.heads, sh.d,
      in_s[0], in_s[1], in_s[2], out_s[0], out_s[1], out_s[2], scale);
  return cudaGetLastError();
}

template <int D16, bool FULL>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                             Shape sh, const long long* in_s, const long long* out_s, float scale,
                             cudaStream_t stream) {
  static unsigned configured = 0;
  constexpr size_t bytes = wgmma_smem_bytes<D16>();
  cudaError_t err = allow_smem(attn_wgmma_kernel<D16, FULL, true>, bytes, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.t_len + kQRows - 1) / kQRows, sh.heads, sh.batch);
  attn_wgmma_kernel<D16, FULL, true><<<grid, kNumThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), m, l, sh.t_len, sh.heads, sh.d,
      in_s[0], in_s[1], in_s[2], out_s[0], out_s[1], out_s[2], scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* m, const float* l, const float* di, void* dk, void* dv,
                       Shape sh, const long long* in_s, const long long* do_s,
                       const long long* g_s, float scale, cudaStream_t stream) {
  static unsigned configured = 0;
  constexpr size_t bytes = dkv_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, DP>, bytes, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.t_len + kTile - 1) / kTile, sh.heads, sh.batch);
  flash_bwd_dkv_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), m, l, di, static_cast<T*>(dk), static_cast<T*>(dv),
      sh.t_len, sh.heads, sh.d, in_s[0], in_s[1], in_s[2], do_s[0], do_s[1], do_s[2],
      g_s[0], g_s[1], g_s[2], scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* m, const float* l, const float* di, void* dq,
                      Shape sh, const long long* in_s, const long long* do_s,
                      const long long* g_s, float scale, cudaStream_t stream) {
  static unsigned configured = 0;
  constexpr size_t bytes = dq_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DP>, bytes, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.t_len + kTile - 1) / kTile, sh.heads, sh.batch);
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), m, l, di, static_cast<T*>(dq),
      sh.t_len, sh.heads, sh.d, in_s[0], in_s[1], in_s[2], do_s[0], do_s[1], do_s[2],
      g_s[0], g_s[1], g_s[2], scale);
  return cudaGetLastError();
}

template <int D16, bool FULL>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const float* m, const float* l, const float* di, void* dk, void* dv,
                             Shape sh, const long long* in_s, const long long* do_s,
                             const long long* g_s, float scale, cudaStream_t stream) {
  static unsigned configured = 0;
  constexpr size_t bytes = dkv_wgmma_smem_bytes<D16>();
  cudaError_t err = allow_smem(flash_bwd_dkv_wgmma_kernel<D16, FULL>, bytes, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.t_len + kTile - 1) / kTile, sh.heads, sh.batch);
  flash_bwd_dkv_wgmma_kernel<D16, FULL><<<grid, kWgThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), m, l, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      sh.t_len, sh.heads, sh.d, in_s[0], in_s[1], in_s[2], do_s[0], do_s[1], do_s[2],
      g_s[0], g_s[1], g_s[2], scale);
  return cudaGetLastError();
}

template <int D16, bool FULL>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const float* m, const float* l, const float* di, void* dq,
                            Shape sh, const long long* in_s, const long long* do_s,
                            const long long* g_s, float scale, cudaStream_t stream) {
  static unsigned configured = 0;
  constexpr size_t bytes = dq_wgmma_smem_bytes<D16>();
  cudaError_t err = allow_smem(flash_bwd_dq_wgmma_kernel<D16, FULL>, bytes, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.t_len + kTile - 1) / kTile, sh.heads, sh.batch);
  flash_bwd_dq_wgmma_kernel<D16, FULL><<<grid, kWgThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), m, l, di, static_cast<bf16*>(dq),
      sh.t_len, sh.heads, sh.d, in_s[0], in_s[1], in_s[2], do_s[0], do_s[1], do_s[2],
      g_s[0], g_s[1], g_s[2], scale);
  return cudaGetLastError();
}

// what the wgmma bodies copy 16 bytes at a time: q, k, v and dO with
// 16-byte aligned rows and strides that are multiples of 8
bool wgmma_aligned(const void* q, const void* k, const void* v, const void* dout,
                   const long long* in_s, const long long* do_s) {
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout;
  const long long strides = in_s[0] | in_s[1] | in_s[2] | do_s[0] | do_s[1] | do_s[2];
  return (ptrs & 15) == 0 && (strides & 7) == 0;
}

bool shape_ok(Shape sh) {
  return sh.batch > 0 && sh.t_len > 0 && sh.heads > 0 && sh.d > 0 && sh.d <= 128 &&
         sh.batch <= 65535 && sh.heads <= 65535;
}

// the padded head width a call runs at
int padded(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Strides are in elements, (batch,
// token, head) each; the head_dim stride is 1 for every tensor. q, k and v
// share their strides; m and l are (B, H, T) f32, written. variant: 0 =
// "fma" (float32 or bfloat16, any view with a unit last stride), 1 =
// "wgmma" (bfloat16, q, k and v 16-byte aligned with strides that are
// multiples of 8; any head width 1 .. 128).
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, float* m, float* l,
    int batch, int t_len, int heads, int head_dim, int dtype_code, int variant,
    long long in_sb, long long in_st, long long in_sh,
    long long out_sb, long long out_st, long long out_sh,
    float scale, void* stream) {
  const Shape sh{batch, t_len, heads, head_dim};
  if (!shape_ok(sh)) return (int)cudaErrorInvalidValue;
  const long long in_s[3] = {in_sb, in_st, in_sh};
  const long long out_s[3] = {out_sb, out_st, out_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype_code != 1) return (int)cudaErrorInvalidValue;
    if (!wgmma_aligned(q, k, v, v, in_s, in_s)) return (int)cudaErrorMisalignedAddress;  // no dO here
#define KET_FWD_WG(D16) \
  (head_dim == D16 ? launch_fwd_wgmma<D16, true>(q, k, v, o, m, l, sh, in_s, out_s, scale, s) \
                   : launch_fwd_wgmma<D16, false>(q, k, v, o, m, l, sh, in_s, out_s, scale, s))
    switch ((head_dim + 15) / 16) {
      case 1: return (int)KET_FWD_WG(16);
      case 2: return (int)KET_FWD_WG(32);
      case 3: return (int)KET_FWD_WG(48);
      case 4: return (int)KET_FWD_WG(64);
      case 5: return (int)KET_FWD_WG(80);
      case 6: return (int)KET_FWD_WG(96);
      case 7: return (int)KET_FWD_WG(112);
      default: return (int)KET_FWD_WG(128);
    }
#undef KET_FWD_WG
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
#define KET_FWD(T, DP) launch_fwd<T, DP>(q, k, v, o, m, l, sh, in_s, out_s, scale, s)
  const int dp = padded(head_dim);
  if (dtype_code == 0) {
    if (dp == 32) return (int)KET_FWD(float, 32);
    if (dp == 64) return (int)KET_FWD(float, 64);
    return (int)KET_FWD(float, 128);
  }
  if (dtype_code == 1) {
    if (dp == 32) return (int)KET_FWD(bf16, 32);
    if (dp == 64) return (int)KET_FWD(bf16, 64);
    return (int)KET_FWD(bf16, 128);
  }
#undef KET_FWD
  return (int)cudaErrorInvalidValue;
}

// dO has its own strides; dk and dv (and dq below) share theirs (`g_*`: the
// packed (B, T, 3, H, D) gradient of qkv). m, l and di are (B, H, T) f32.
// variant: 0 = "fma" (float32 or bfloat16, any view with a unit last
// stride), 1 = "wgmma" (bfloat16, q, k, v and dO 16-byte aligned with
// strides that are multiples of 8; any head width 1 .. 128).
extern "C" int flash_attention_backward_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* m, const float* l, const float* di, void* dk, void* dv,
    int batch, int t_len, int heads, int head_dim, int dtype_code, int variant,
    long long in_sb, long long in_st, long long in_sh,
    long long do_sb, long long do_st, long long do_sh,
    long long g_sb, long long g_st, long long g_sh,
    float scale, void* stream) {
  const Shape sh{batch, t_len, heads, head_dim};
  if (!shape_ok(sh)) return (int)cudaErrorInvalidValue;
  const long long in_s[3] = {in_sb, in_st, in_sh};
  const long long do_s[3] = {do_sb, do_st, do_sh};
  const long long g_s[3] = {g_sb, g_st, g_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype_code != 1) return (int)cudaErrorInvalidValue;
    if (!wgmma_aligned(q, k, v, dout, in_s, do_s)) return (int)cudaErrorMisalignedAddress;
#define KET_DKV_WG(D16) \
  (head_dim == D16 ? launch_dkv_wgmma<D16, true>(q, k, v, dout, m, l, di, dk, dv, sh, in_s, do_s, g_s, scale, s) \
                   : launch_dkv_wgmma<D16, false>(q, k, v, dout, m, l, di, dk, dv, sh, in_s, do_s, g_s, scale, s))
    switch ((head_dim + 15) / 16) {
      case 1: return (int)KET_DKV_WG(16);
      case 2: return (int)KET_DKV_WG(32);
      case 3: return (int)KET_DKV_WG(48);
      case 4: return (int)KET_DKV_WG(64);
      case 5: return (int)KET_DKV_WG(80);
      case 6: return (int)KET_DKV_WG(96);
      case 7: return (int)KET_DKV_WG(112);
      default: return (int)KET_DKV_WG(128);
    }
#undef KET_DKV_WG
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
#define KET_DKV(T, DP) launch_dkv<T, DP>(q, k, v, dout, m, l, di, dk, dv, sh, in_s, do_s, g_s, scale, s)
  const int dp = padded(head_dim);
  if (dtype_code == 0) {
    if (dp == 32) return (int)KET_DKV(float, 32);
    if (dp == 64) return (int)KET_DKV(float, 64);
    return (int)KET_DKV(float, 128);
  }
  if (dtype_code == 1) {
    if (dp == 32) return (int)KET_DKV(bf16, 32);
    if (dp == 64) return (int)KET_DKV(bf16, 64);
    return (int)KET_DKV(bf16, 128);
  }
#undef KET_DKV
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_backward_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* m, const float* l, const float* di, void* dq,
    int batch, int t_len, int heads, int head_dim, int dtype_code, int variant,
    long long in_sb, long long in_st, long long in_sh,
    long long do_sb, long long do_st, long long do_sh,
    long long g_sb, long long g_st, long long g_sh,
    float scale, void* stream) {
  const Shape sh{batch, t_len, heads, head_dim};
  if (!shape_ok(sh)) return (int)cudaErrorInvalidValue;
  const long long in_s[3] = {in_sb, in_st, in_sh};
  const long long do_s[3] = {do_sb, do_st, do_sh};
  const long long g_s[3] = {g_sb, g_st, g_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype_code != 1) return (int)cudaErrorInvalidValue;
    if (!wgmma_aligned(q, k, v, dout, in_s, do_s)) return (int)cudaErrorMisalignedAddress;
#define KET_DQ_WG(D16) \
  (head_dim == D16 ? launch_dq_wgmma<D16, true>(q, k, v, dout, m, l, di, dq, sh, in_s, do_s, g_s, scale, s) \
                   : launch_dq_wgmma<D16, false>(q, k, v, dout, m, l, di, dq, sh, in_s, do_s, g_s, scale, s))
    switch ((head_dim + 15) / 16) {
      case 1: return (int)KET_DQ_WG(16);
      case 2: return (int)KET_DQ_WG(32);
      case 3: return (int)KET_DQ_WG(48);
      case 4: return (int)KET_DQ_WG(64);
      case 5: return (int)KET_DQ_WG(80);
      case 6: return (int)KET_DQ_WG(96);
      case 7: return (int)KET_DQ_WG(112);
      default: return (int)KET_DQ_WG(128);
    }
#undef KET_DQ_WG
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
#define KET_DQ(T, DP) launch_dq<T, DP>(q, k, v, dout, m, l, di, dq, sh, in_s, do_s, g_s, scale, s)
  const int dp = padded(head_dim);
  if (dtype_code == 0) {
    if (dp == 32) return (int)KET_DQ(float, 32);
    if (dp == 64) return (int)KET_DQ(float, 64);
    return (int)KET_DQ(float, 128);
  }
  if (dtype_code == 1) {
    if (dp == 32) return (int)KET_DQ(bf16, 32);
    if (dp == 64) return (int)KET_DQ(bf16, 64);
    return (int)KET_DQ(bf16, 128);
  }
#undef KET_DQ
  return (int)cudaErrorInvalidValue;
}
