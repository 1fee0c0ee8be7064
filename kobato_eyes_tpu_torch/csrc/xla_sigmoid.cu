// exp, the logistic sigmoid and rsqrt in f32, as XLA's CPU backend computes
// jnp.exp, jax.nn.sigmoid and jax.lax.rsqrt: one elementwise pass (rsqrt's
// steps are in xla_rsqrt.cuh).
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
// __fmul_rn, __fadd_rn or __frcp_rn (1 / d rounded once, as the divide
// rounds it), so that nvcc contracts nothing; ops/xla_math.py holds the
// plain version, which equals jitted jnp.exp and jax.nn.sigmoid on every
// f32 binade (tests/test_torch_sigmoid.py).
//
// Bound on the card: bytes. x is read once and the output written once (the
// tagger's (32, 8192) f32 logits: 1 MB each way, 0.63 us at 3.35 TB/s).
// Each value is a chain of ~40 dependent operations, so at that size the
// chains' latency, not the bytes, sets the time: while one value a thread
// fits in one wave of resident threads, the pass runs one value a thread
// (the "scalar" body: more chains in flight); beyond it, four values a
// thread through 16-byte loads when both pointers allow it (the "vec"
// body), where the bytes set the time. chip_smoke.py times both bodies at
// both sizes beside torch.sigmoid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_rsqrt.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kFltMin = 1.17549435e-38f;

__device__ __forceinline__ float quiet_nan(float x, unsigned flip) {
  return __uint_as_float((__float_as_uint(x) | 0x00400000u) ^ flip);
}

// exp of a value that is not NaN
__device__ __forceinline__ float xla_exp_number(float x) {
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

__device__ __forceinline__ float xla_exp(float x) {
  return isnan(x) ? quiet_nan(x, 0u) : xla_exp_number(x);
}

__device__ __forceinline__ float xla_sigmoid(float x) {
  if (isnan(x)) return quiet_nan(x, 0x80000000u);
  const float s = __frcp_rn(__fadd_rn(xla_exp_number(-x), 1.0f));
  return s < kFltMin ? 0.0f : s;
}

template <int OP>
__device__ __forceinline__ float apply(float x) {
  return OP == 0 ? xla_exp(x) : OP == 1 ? xla_sigmoid(x) : xla_rsqrt(x);
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

// threads resident on the current device at full occupancy: one wave
long long one_wave() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  return static_cast<long long>(sms) * per_sm;
}

// variant 0: by size; 1: "vec" (four a thread where aligned); 2: "scalar"
template <int OP>
int launch(const float* x, float* y, long long n, int variant, cudaStream_t s) {
  long long start = 0;
  const bool vec = variant == 1 || (variant == 0 && n > one_wave());
  if (vec && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0) {
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

// y = exp(x) (op 0), sigmoid(x) (op 1) or rsqrt(x) (op 2, xla_rsqrt.cuh;
// rsqrt_table: the host's 2048 estimates, copied to the device at its first
// rsqrt there), n f32 values; variant as launch's.
extern "C" int xla_math_launch(const void* x, void* y, long long n, int op, int variant,
                               const void* rsqrt_table, void* stream) {
  if (n <= 0) return 0;
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (op == 0) return launch<0>(xf, yf, n, variant, s);
  if (op == 1) return launch<1>(xf, yf, n, variant, s);
  if (op == 2) {
    const cudaError_t err = xla_rsqrt_ensure_table(rsqrt_table);
    if (err != cudaSuccess) return (int)err;
    return launch<2>(xf, yf, n, variant, s);
  }
  return (int)cudaErrorInvalidValue;
}
