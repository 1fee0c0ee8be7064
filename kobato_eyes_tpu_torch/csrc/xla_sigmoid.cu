// exp and the logistic sigmoid in f32, as XLA's CPU backend computes
// jnp.exp and jax.nn.sigmoid: one elementwise pass.
//
// Not a port of a TPU kernel: the JAX package's probs_from_logits calls
// jax.nn.sigmoid, which XLA compiles to divide(1, add(exponential(negate(x)),
// 1)). Its f32 exponential on the CPU is Cephes' expf with every
// multiply-add fused:
//
//   m = min(floor(fma(x, log2e, 0.5)), 127)
//   r = fma(m, -0.693359375, x);  r = fma(m, 2.12194440e-4, r)
//   p = Horner of degree 5 in r (FMAs)
//   y = fma(p, r * r, r) + 1;  exp = y * 2^m
//
// Its runtime flushes subnormal results to zero: exp is 0 below
// -88.3762626 and wherever y * 2^m would be subnormal; the sigmoid is 0
// wherever 1 / (1 + e) would be. A NaN comes back quieted with its payload
// (the sigmoid's negate flips its sign). Every step here is __fmaf_rn,
// __fmul_rn, __fadd_rn or __fdiv_rn, so that nvcc contracts nothing;
// ops/xla_math.py holds the plain version, which equals jitted jnp.exp and
// jax.nn.sigmoid on every f32 binade (tests/test_torch_sigmoid.py).
//
// Bound on the card: bytes. x is read once and the output written once (the
// tagger's (32, 8192) f32 logits: 1 MB each way, 0.63 us at 3.35 TB/s).
// Four values a thread through 16-byte loads when both pointers allow it,
// one a thread otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFltMin = 1.17549435e-38f;

__device__ __forceinline__ float quiet_nan(float x, unsigned flip) {
  return __uint_as_float((__float_as_uint(x) | 0x00400000u) ^ flip);
}

__device__ __forceinline__ float xla_exp(float x) {
  if (isnan(x)) return quiet_nan(x, 0u);
  if (x < -88.3762626647949f) return 0.0f;
  const float m = fminf(floorf(__fmaf_rn(x, 1.44269504088896341f, 0.5f)), 127.0f);
  if (m < -126.0f) return 0.0f;  // y * 2^m would be subnormal: flushed
  float r = __fmaf_rn(m, -0.693359375f, x);
  r = __fmaf_rn(m, 2.12194440e-4f, r);
  float p = 1.9875691500e-4f;
  p = __fmaf_rn(p, r, 1.3981999507e-3f);
  p = __fmaf_rn(p, r, 8.3334519073e-3f);
  p = __fmaf_rn(p, r, 4.1665795894e-2f);
  p = __fmaf_rn(p, r, 1.6666665459e-1f);
  p = __fmaf_rn(p, r, 5.0000001201e-1f);
  const float y = __fadd_rn(__fmaf_rn(p, __fmul_rn(r, r), r), 1.0f);
  const float out = __fmul_rn(y, __int_as_float((static_cast<int>(m) + 127) << 23));
  return out < kFltMin ? 0.0f : out;
}

__device__ __forceinline__ float xla_sigmoid(float x) {
  if (isnan(x)) return quiet_nan(x, 0x80000000u);
  const float s = __fdiv_rn(1.0f, __fadd_rn(xla_exp(-x), 1.0f));
  return s < kFltMin ? 0.0f : s;
}

template <int OP>
__device__ __forceinline__ float apply(float x) {
  return OP == 0 ? xla_exp(x) : xla_sigmoid(x);
}

template <int OP>
__global__ void __launch_bounds__(kThreads) vec_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                                                       long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  float4 v = x[i];
  v.x = apply<OP>(v.x);
  v.y = apply<OP>(v.y);
  v.z = apply<OP>(v.z);
  v.w = apply<OP>(v.w);
  y[i] = v;
}

template <int OP>
__global__ void __launch_bounds__(kThreads) scalar_kernel(const float* __restrict__ x, float* __restrict__ y,
                                                          long long start, long long n) {
  const long long i = start + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) y[i] = apply<OP>(x[i]);
}

template <int OP>
int launch(const float* x, float* y, long long n, cudaStream_t s) {
  long long start = 0;
  if ((uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0) {
    const long long n4 = n / 4;
    if (n4 > 0) {
      vec_kernel<OP><<<(unsigned)((n4 + kThreads - 1) / kThreads), kThreads, 0, s>>>(
          reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    start = n4 * 4;
  }
  if (start < n) {
    scalar_kernel<OP><<<(unsigned)((n - start + kThreads - 1) / kThreads), kThreads, 0, s>>>(x, y, start, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y = exp(x) (op 0) or sigmoid(x) (op 1), n f32 values.
extern "C" int xla_math_launch(const void* x, void* y, long long n, int op, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (op == 0) return launch<0>(xf, yf, n, s);
  if (op == 1) return launch<1>(xf, yf, n, s);
  return (int)cudaErrorInvalidValue;
}
