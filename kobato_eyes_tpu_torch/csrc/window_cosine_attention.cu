// SwinV2 window cosine attention for every (batch, window, head).
//
// Replaces the JAX package's window-resident Pallas kernel
// (kobato_eyes_tpu/ops/pallas_window_attention.py: _win_attn_kernel via
// _win_attn_call / windowed_cosine_attention_packed). It computes what
// _win_attn_kernel computes, per window and head:
//   qn = q * rsqrt(max(sum(q^2), 1e-12)), kn likewise, both in f32
//     (qk_bf16: qn and kn rounded to bf16, as qk_precision="bf16" does);
//   logits = (qn kn^T) * scale[h] + bias[h] (+ mask[w]), all f32;
//   w = exp(logits - rowmax) rounded to v's dtype, rowsum = sum(w) in f32;
//   out = (w v accumulated in f32) / rowsum, written in qkv's dtype.
// The products take f32 operands: that is what the JAX function computes on
// the CPU for qk_precision "default" and "highest". On the TPU, "default"
// rounds the operands to bf16 on its matrix unit; here only "bf16" does.
//
// The TPU program holds all of one (batch, head)'s windows in VMEM (9.8 MB
// of logits at SwinV2-B/448 stage 0), far over a Hopper block's 227 KB. So
// one block here takes one (batch, window, head): 32*256*4 = 32768 blocks at
// stage 0. The window's normalised keys and its values sit in shared memory
// (n x hd f32 each); each of the block's four warps takes query rows in turn
// and computes one row's n logits into its own shared row buffer, so the
// (n, n) tile is never held whole and n = 196 (window 14) fits as well as
// n = 49. q, k and v are read through strides straight from the packed
// (B, nW, n, 3, H, hd) projection (the TPU call transposes the whole tensor
// first), and the output is written as (B, nW, n, H, hd), which the model's
// output projection reads as (B*nW, n, C) with no copy.
//
// The row-max shift stays: q and k are different projections, so no row has
// a guaranteed-large logit, and with the clamped scale of 100, the CPB bias
// of up to 16 and the -100 shift mask a static shift underflows whole rows
// (test_static_shift_safe_at_production_bounds in the JAX package).
//
// Bound on the card: bytes. At SwinV2-B/448 stage 0 (B=32, nW=256, n=49,
// H=4, hd=32, bf16) the call reads 308 MB of qkv and writes 103 MB, 0.12 ms
// at 3.35 TB/s, against 10.1 GFLOP of products. This first version does the
// products with f32 FMAs out of shared memory and loads one element per
// lane; tensor cores, cp.async and wider loads are later work.
//
// Plain C entry for ctypes: returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

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
  const float inv = rsqrtf(fmaxf(ss, 1e-12f));
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
win_attn_kernel(const T* __restrict__ qkv, T* __restrict__ out,
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
cudaError_t launch(const void* qkv, void* out, const float* scale, const float* bias,
                   const float* mask, int batch, int n_windows, int n, int heads,
                   long long s_b, long long s_w, long long s_n, long long s_three, long long s_h,
                   long long o_b, long long o_w, long long o_n, long long o_h, int qk_bf16,
                   cudaStream_t stream) {
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(win_attn_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes<HD>(kMaxTokens));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long blocks = (long long)batch * n_windows * heads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  win_attn_kernel<T, HD><<<(unsigned)blocks, kThreads, smem_bytes<HD>(n), stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), scale, bias, mask, n_windows, n, heads,
      s_b, s_w, s_n, s_three, s_h, o_b, o_w, o_n, o_h, qk_bf16);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// (head_dim) stride of qkv and out is 1. scale (H,), bias (H, n, n) and mask
// (nW, n, n) are contiguous f32; mask may be null (unshifted blocks).
extern "C" int window_cosine_attention_launch(
    const void* qkv, void* out, const void* scale, const void* bias, const void* mask,
    int batch, int n_windows, int n, int heads, int head_dim, int dtype_code, int qk_bf16,
    long long s_b, long long s_w, long long s_n, long long s_three, long long s_h,
    long long o_b, long long o_w, long long o_n, long long o_h, void* stream) {
  if (batch <= 0 || n_windows <= 0 || heads <= 0 || n <= 0 || n > kMaxTokens)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* ma = static_cast<const float*>(mask);
#define KET_WIN_CASE(T, HD)                                                                \
  if (head_dim == HD)                                                                      \
  return (int)launch<T, HD>(qkv, out, sc, bi, ma, batch, n_windows, n, heads, s_b, s_w,    \
                            s_n, s_three, s_h, o_b, o_w, o_n, o_h, qk_bf16, st)
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
  return (int)cudaErrorInvalidValue;
}
