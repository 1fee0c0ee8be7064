// Residual-fused LayerNorm: out = shortcut + LayerNorm(x), row by row.
//
// Replaces the JAX package's residual LayerNorm Pallas kernel
// (kobato_eyes_tpu/ops/pallas_layernorm_residual.py: _ln_res_kernel via
// _ln_res_call / layernorm_residual). It computes what _ln_res_kernel
// computes, per row of C values:
//   mean = sum(x) / C and var = sum(x^2) / C - mean^2 in f32 (no clamp),
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta in f32, the rsqrt
//     XLA's CPU one (xla_rsqrt.cuh), which the JAX kernel's jax.lax.rsqrt is
//     on the CPU,
//   out = shortcut + y in f32, rounded once to x's dtype.
//
// Bound on the card: bytes. The call reads x and the shortcut once and
// writes the output once: at SwinV2-B/448 stage 0 (401408 rows x 128, bf16)
// that is 308 MB, 0.092 ms at 3.35 TB/s, against a few operations a byte; at
// stage 3 (6272 rows x 1024) it is 38.5 MB and under one wave of warps, so
// what counts there is how many bytes a warp has in flight before it waits.
//
// Two kernels, chosen by shape and alignment (the wrapper's kernel_variant),
// never one after the other's failure:
//
// * "vec8": C a multiple of 8 and every pointer a multiple of 16 bytes. A
//   lane owns chunks of 8 consecutive columns: one 16-byte load for bf16,
//   two for f32. A row of C/8 chunks is spread over LPR = 8, 16 or 32 lanes
//   (the least power of two that holds it, so C = 128 puts two rows in a
//   warp and C = 1024 gives a lane four chunks); neighbouring lanes read
//   neighbouring 16 bytes. Every load of x AND of the shortcut is issued
//   before the first reduction, so a row makes one trip to device memory;
//   the row stays in registers as loaded and is unpacked where it is used.
//   The sums go through shuffles over the row's LPR lanes only. gamma and
//   beta are read as float4 pairs (they stay in L1).
// * "scalar": any C up to 1024, any alignment: a warp a row, lanes on
//   columns lane, lane + 32, ... with one element a load.
//
// Both keep the TPU kernel's arithmetic: f32 sums (in another order),
// var = E[x^2] - mean^2 without a clamp, ((x - mean) * inv) * gamma + beta
// rounded step by step, one final rounding.
//
// Plain C entry for ctypes: returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "xla_rsqrt.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block, scalar kernel: a row each
constexpr int kThreads = kWarps * 32;
constexpr int kVecWarps = 4;  // warps per block, vec8 kernel
constexpr int kVecThreads = kVecWarps * 32;
constexpr int kMaxCols = 1024;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// "scalar": one warp a row, one element a load
// ---------------------------------------------------------------------------

// K = values each lane holds: C <= 32 * K.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
ln_res_kernel(const T* __restrict__ x, const T* __restrict__ res,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              T* __restrict__ out, long long rows, int cols, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const long long base = row * cols;

  float v[K];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < cols ? to_f(x[base + c]) : 0.f;
    sum += v[k];
    sq = fmaf(v[k], v[k], sq);
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = sum / (float)cols;
  const float var = __fsub_rn(sq / (float)cols, __fmul_rn(mean, mean));
  const float inv = xla_rsqrt(__fadd_rn(var, eps));
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    if (c < cols) {
      // ((x - mean) * inv) * gamma + beta, each step rounded as in the JAX kernel
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[k], mean), inv), gamma[c]), beta[c]);
      out[base + c] = from_f<T>(__fadd_rn(to_f(res[base + c]), y));
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* res, const float* gamma, const float* beta,
                   void* out, long long rows, int cols, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  ln_res_kernel<T, K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), gamma, beta, static_cast<T*>(out),
      rows, cols, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols(const void* x, const void* res, const float* gamma, const float* beta,
                        void* out, long long rows, int cols, float eps, cudaStream_t stream) {
  if (cols <= 128) return launch<T, 4>(x, res, gamma, beta, out, rows, cols, eps, stream);
  if (cols <= 256) return launch<T, 8>(x, res, gamma, beta, out, rows, cols, eps, stream);
  if (cols <= 512) return launch<T, 16>(x, res, gamma, beta, out, rows, cols, eps, stream);
  return launch<T, 32>(x, res, gamma, beta, out, rows, cols, eps, stream);
}

// ---------------------------------------------------------------------------
// "vec8": a lane owns chunks of 8 consecutive columns, 16 bytes a load
// ---------------------------------------------------------------------------

// Eight consecutive values as they lie in memory.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  float4 a, b;
};
template <>
struct Chunk<__nv_bfloat16> {
  uint4 u;
};

__device__ __forceinline__ void zero(Chunk<float>& c) {
  c.a = make_float4(0.f, 0.f, 0.f, 0.f);
  c.b = c.a;
}
__device__ __forceinline__ void zero(Chunk<__nv_bfloat16>& c) { c.u = make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ void load(Chunk<float>& c, const float* p) {
  c.a = __ldg(reinterpret_cast<const float4*>(p));
  c.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}
__device__ __forceinline__ void load(Chunk<__nv_bfloat16>& c, const __nv_bfloat16* p) {
  c.u = __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(const Chunk<float>& c, float (&v)[8]) {
  v[0] = c.a.x; v[1] = c.a.y; v[2] = c.a.z; v[3] = c.a.w;
  v[4] = c.b.x; v[5] = c.b.y; v[6] = c.b.z; v[7] = c.b.w;
}
// a bf16 is the upper half of its f32: the low element of a word shifts up
__device__ __forceinline__ void unpack(const Chunk<__nv_bfloat16>& c, float (&v)[8]) {
  const uint32_t w[4] = {c.u.x, c.u.y, c.u.z, c.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // round to nearest even, the first value in the word's low half
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// LPR = lanes a row (8, 16 or 32), K = chunks a lane: C <= 8 * LPR * K.
// A warp takes 32 / LPR rows; lane s of a row owns chunks s, s + LPR, ...
template <typename T, int LPR, int K>
__global__ void __launch_bounds__(kVecThreads)
ln_res_vec_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  T* __restrict__ out, long long rows, int cols, float eps) {
  constexpr int kRowsPerWarp = 32 / LPR;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR;
  const long long warp = (long long)blockIdx.x * kVecWarps + (threadIdx.x >> 5);
  const long long row = warp * kRowsPerWarp + lane / LPR;
  // a lane without a row or a chunk loads nothing and adds zeros: it stays
  // for the shuffles, which name the whole warp
  const bool row_live = row < rows;
  const int chunks = cols >> 3;
  const long long base = row * cols;

  Chunk<T> xc[K], rc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = sub + LPR * k;
    if (row_live && j < chunks) {
      load(xc[k], x + base + 8 * j);
    } else {
      zero(xc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = sub + LPR * k;
    if (row_live && j < chunks) {
      load(rc[k], res + base + 8 * j);
    } else {
      zero(rc[k]);
    }
  }

  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v[8];
    unpack(xc[k], v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sum += v[i];
      sq = fmaf(v[i], v[i], sq);
    }
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) {  // stays inside the row's LPR lanes
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float mean = sum / (float)cols;
  const float var = __fsub_rn(sq / (float)cols, __fmul_rn(mean, mean));
  const float inv = xla_rsqrt(__fadd_rn(var, eps));

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = sub + LPR * k;
    if (row_live && j < chunks) {
      float v[8], r[8], g[8], b[8], o[8];
      unpack(xc[k], v);
      unpack(rc[k], r);
      Chunk<float> gc, bc;
      load(gc, gamma + 8 * j);
      load(bc, beta + 8 * j);
      unpack(gc, g);
      unpack(bc, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // ((x - mean) * inv) * gamma + beta, each step rounded as in the JAX kernel
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), inv), g[i]), b[i]);
        o[i] = __fadd_rn(r[i], y);
      }
      store(out + base + 8 * j, o);
    }
  }
}

template <typename T, int LPR, int K>
cudaError_t launch_vec(const void* x, const void* res, const float* gamma, const float* beta,
                       void* out, long long rows, int cols, float eps, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kVecWarps * (32 / LPR);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  ln_res_vec_kernel<T, LPR, K><<<(unsigned)blocks, kVecThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), gamma, beta, static_cast<T*>(out),
      rows, cols, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec_cols(const void* x, const void* res, const float* gamma, const float* beta,
                            void* out, long long rows, int cols, float eps, cudaStream_t stream) {
  if (cols <= 64) return launch_vec<T, 8, 1>(x, res, gamma, beta, out, rows, cols, eps, stream);
  if (cols <= 128) return launch_vec<T, 16, 1>(x, res, gamma, beta, out, rows, cols, eps, stream);
  if (cols <= 256) return launch_vec<T, 32, 1>(x, res, gamma, beta, out, rows, cols, eps, stream);
  if (cols <= 512) return launch_vec<T, 32, 2>(x, res, gamma, beta, out, rows, cols, eps, stream);
  if (cols <= 768) return launch_vec<T, 32, 3>(x, res, gamma, beta, out, rows, cols, eps, stream);
  return launch_vec<T, 32, 4>(x, res, gamma, beta, out, rows, cols, eps, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. variant: 0 = "scalar", 1 = "vec8"
// (cols a multiple of 8 and all five pointers multiples of 16 bytes, else
// cudaErrorInvalidValue). x, res and out are contiguous (rows, cols) of that
// dtype; gamma and beta contiguous f32 (cols,). rsqrt_table: the host's 2048
// rsqrt estimates (xla_rsqrt.cuh), copied to the device at its first launch
// there.
extern "C" int layernorm_residual_launch(const void* x, const void* res, const void* gamma,
                                         const void* beta, void* out, long long rows, int cols,
                                         int dtype_code, int variant, float eps, const void* rsqrt_table,
                                         void* stream) {
  if (rows <= 0 || cols <= 0 || cols > kMaxCols) return (int)cudaErrorInvalidValue;
  const cudaError_t table_err = xla_rsqrt_ensure_table(rsqrt_table);
  if (table_err != cudaSuccess) return (int)table_err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (variant == 1) {
    if (cols % 8 != 0 || !aligned16(x) || !aligned16(res) || !aligned16(gamma) || !aligned16(beta) ||
        !aligned16(out)) {
      return (int)cudaErrorInvalidValue;
    }
    if (dtype_code == 0) return (int)launch_vec_cols<float>(x, res, g, b, out, rows, cols, eps, st);
    if (dtype_code == 1) return (int)launch_vec_cols<__nv_bfloat16>(x, res, g, b, out, rows, cols, eps, st);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype_code == 0) return (int)launch_cols<float>(x, res, g, b, out, rows, cols, eps, st);
  if (dtype_code == 1) return (int)launch_cols<__nv_bfloat16>(x, res, g, b, out, rows, cols, eps, st);
  return (int)cudaErrorInvalidValue;
}
