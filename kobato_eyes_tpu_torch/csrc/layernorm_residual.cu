// Residual-fused LayerNorm: out = shortcut + LayerNorm(x), row by row.
//
// Replaces the JAX package's residual LayerNorm Pallas kernel
// (kobato_eyes_tpu/ops/pallas_layernorm_residual.py: _ln_res_kernel via
// _ln_res_call / layernorm_residual). It computes what _ln_res_kernel
// computes, per row of C values:
//   mean = sum(x) / C and var = sum(x^2) / C - mean^2 in f32 (no clamp),
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta in f32,
//   out = shortcut + y in f32, rounded once to x's dtype.
//
// Bound on the card: bytes. The call reads x and the shortcut once and
// writes the output once: at SwinV2-B/448 stage 0 (401408 rows x 128, bf16)
// that is 308 MB, 0.092 ms at 3.35 TB/s, against a few operations a byte.
// One warp takes one row and keeps it in registers between the statistics
// and the apply pass, so x is read once; the sums are warp shuffles, so no
// shared memory and no block-wide barrier. Lanes take columns lane, lane+32,
// ..., which keeps every warp load on consecutive addresses for any C up to
// 1024 (the TPU kernel's C % 128 rule was a Mosaic tiling limit). Wider
// vector loads are later work.
//
// Plain C entry for ctypes: returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = kWarps * 32;
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
  const float inv = rsqrtf(__fadd_rn(var, eps));
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

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. x, res and out are contiguous
// (rows, cols) of that dtype; gamma and beta contiguous f32 (cols,).
extern "C" int layernorm_residual_launch(const void* x, const void* res, const void* gamma,
                                         const void* beta, void* out, long long rows, int cols,
                                         int dtype_code, float eps, void* stream) {
  if (rows <= 0 || cols <= 0 || cols > kMaxCols) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (dtype_code == 0) return (int)launch_cols<float>(x, res, g, b, out, rows, cols, eps, st);
  if (dtype_code == 1) return (int)launch_cols<__nv_bfloat16>(x, res, g, b, out, rows, cols, eps, st);
  return (int)cudaErrorInvalidValue;
}
