// EVA02's 2D rotary position embedding, in place inside the packed
// (B, T, 3, H, D) q, k, v projection (ops/rope.py holds the plain version
// and the account of what it computes and why).
//
// Not a port of a TPU kernel: the JAX package has no EVA02. For the patch
// tokens t = prefix .. T-1 and the q and k planes, the pair (2m, 2m+1) of a
// head's columns turns by angle m of token t - prefix:
//
//   o[2m]   = q[2m] * cos - q[2m+1] * sin
//   o[2m+1] = q[2m+1] * cos + q[2m] * sin
//
// in f32 from the stored values, each product and sum rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: nvcc contracts nothing into an FMA, so
// the result equals the plain version's bit for bit), then rounded once to
// the buffer's dtype. The class token and v are not touched.
//
// Bound on the card: bytes (q and k read and written once; the tables stay
// in L2). A thread moves one 16-byte vector (8 bf16 or 4 f32 values) of one
// head's row; the flat index runs over vectors of a head, then heads, then
// the q and k planes, then tokens, then the batch, so a warp's loads and
// stores cover contiguous bytes of the packed layout. A grid-stride loop
// covers the whole work with at most kMaxBlocks blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__global__ void __launch_bounds__(kThreads) rope2d_packed_kernel(
    T* __restrict__ qkv, const float* __restrict__ sin_t, const float* __restrict__ cos_t,
    int n_tokens, int heads, int head_dim, int prefix,
    long long sb, long long st, long long s3, long long sh, long long total) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kPairs = kVec / 2;
  const int vecs = head_dim / kVec;
  const int half = head_dim / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    long long rest = i;
    const int v = (int)(rest % vecs);
    rest /= vecs;
    const int h = (int)(rest % heads);
    rest /= heads;
    const int plane = (int)(rest % 2);
    rest /= 2;
    const int n = (int)(rest % n_tokens);
    const long long b = rest / n_tokens;
    T* p = qkv + b * sb + (long long)(n + prefix) * st + plane * s3 + h * sh + (long long)v * kVec;
    Vec<T> x = *reinterpret_cast<const Vec<T>*>(p);
    const float* s_row = sin_t + (long long)n * half + v * kPairs;
    const float* c_row = cos_t + (long long)n * half + v * kPairs;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const float a = to_f32(x.v[2 * k]);
      const float c = to_f32(x.v[2 * k + 1]);
      const float sn = __ldg(s_row + k);
      const float cs = __ldg(c_row + k);
      x.v[2 * k] = from_f32<T>(__fsub_rn(__fmul_rn(a, cs), __fmul_rn(c, sn)));
      x.v[2 * k + 1] = from_f32<T>(__fadd_rn(__fmul_rn(c, cs), __fmul_rn(a, sn)));
    }
    *reinterpret_cast<Vec<T>*>(p) = x;
  }
}

template <typename T>
int launch(void* qkv, const float* sin_t, const float* cos_t, int b, int t, int h, int d, int prefix,
           long long sb, long long st, long long s3, long long sh, cudaStream_t stream) {
  const int n = t - prefix;
  const long long total = (long long)b * n * 2 * h * (d / Vec<T>::kN);
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rope2d_packed_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<T*>(qkv), sin_t, cos_t, n, h, d, prefix, sb, st, s3, sh, total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides in elements of the (B, T, 3, H, D)
// view (D's is 1). Returns the launch's cudaError_t (0 on success).
extern "C" int rope2d_packed_launch(void* qkv, const float* sin_t, const float* cos_t, int b, int t, int h,
                                    int d, int prefix, int dtype, long long sb, long long st, long long s3,
                                    long long sh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(qkv, sin_t, cos_t, b, t, h, d, prefix, sb, st, s3, sh, s);
  if (dtype == 1) return launch<__nv_bfloat16>(qkv, sin_t, cos_t, b, t, h, d, prefix, sb, st, s3, sh, s);
  return (int)cudaErrorInvalidValue;
}
