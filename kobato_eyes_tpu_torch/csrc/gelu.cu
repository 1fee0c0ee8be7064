// GELU as XLA computes jax.nn.gelu: one elementwise pass, erf or tanh form,
// bf16 or f32, and one pass for its gradient (XLA's compiled vjp), which the
// trainer's backward runs.
//
// Not a port of a TPU kernel: the JAX package leaves the activation to XLA,
// and its tagger's MLPs (ViT, SwinV2, the CLIP tower) run it after every
// fc1. The op sequence below is the one in XLA's compiled HLO for
// jax.nn.gelu(x, approximate=False / True) at bf16 and f32 (dumped with
// .lower(x).compile().as_text() on the CPU), constants as the HLO prints
// them:
//
// * erf, bf16: half = bf16(0.5 * x); z = -x * 0.70703125 in f32 (not
//   rounded); y = bf16(erfc(z)); out = bf16(half * y).
// * erf, f32: out = (0.5 * x) * erfc(-x * 0.707106769).
// * erfc(z): w = z * z; |z| < 1: 1 - z * P(w); else
//   exp(-w) * (1 / |z|) * (|z| < 2 ? A(1 / w) : B(1 / w)), 0 where
//   -w < -88.7228394, 2 - that where z < 0.
// * tanh, bf16: every step rounded to bf16, k = 0.0446777344, c = 0.796875:
//   x * (0.5 * (1 + tanh(c * (x + k * x^3)))).
// * tanh, f32: the same without roundings, k = 0.044715, c = 0.797884583.
//
// XLA's CPU backend fuses every multiply-add that no bf16 rounding separates
// (the Horner steps, 1 - z * P(w), and x + k * x^3 in the f32 tanh form);
// those are __fmaf_rn here and every other step __fmul_rn / __fadd_rn /
// __fdiv_rn, so that nvcc contracts nothing else. exp and tanh are expf and
// tanhf (never __expf: its error moves bf16 roundings). Where the HLO
// selects between arms of erfc, this code branches: the same value, and a
// warp whose values all sit in one arm computes only that arm.
//
// Bound on the card: bytes. x is read once and the output written once
// (ViT-B/448 at batch 32: 25 120 x 3072 bf16, 154 MB each way, 0.092 ms at
// 3.35 TB/s); the erf form's ~20-45 f32 operations an element stay under
// that at 67 TFLOP/s. The gradient reads x and g and writes dx (three
// tensors' bytes). Two bodies, chosen by alignment (the wrapper's
// kernel_variant), never one after the other's failure:
//
// * "vec": every tensor at a 16-byte boundary. A thread loads 16 bytes of
//   each input (8 bf16 or 4 f32), computes and stores 16 bytes; neighbouring threads
//   own neighbouring chunks, a grid-stride loop walks the tensor, and the
//   n % (16 / sizeof(T)) elements after the last chunk go one a thread.
// * "scalar": any alignment, one element a thread.
//
// Plain C entries for ctypes: each returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks an SM on an H100

__device__ __forceinline__ float rb(float v) {  // XLA's convert pair f32 -> bf16 -> f32
  return __bfloat162float(__float2bfloat16_rn(v));
}

// XLA's f32 erfc sequence.
__device__ __forceinline__ float xla_erfc(float z) {
  const float az = fabsf(z);
  const float w = __fmul_rn(z, z);
  if (az < 1.0f) {
    float p = __fmaf_rn(w, 7.85386146e-05f, -0.000801019371f);
    p = __fmaf_rn(p, w, 0.00518832775f);
    p = __fmaf_rn(p, w, -0.0268538129f);
    p = __fmaf_rn(p, w, 0.112835854f);
    p = __fmaf_rn(p, w, -0.37612626f);
    p = __fmaf_rn(p, w, 1.12837911f);
    return __fmaf_rn(-z, p, 1.0f);
  }
  const float nw = -w;
  const float q = __fdiv_rn(1.0f, w);
  float p;
  if (az < 2.0f) {
    p = __fmaf_rn(q, 0.0232682f, -0.138703942f);
    p = __fmaf_rn(p, q, 0.368742466f);
    p = __fmaf_rn(p, q, -0.582473278f);
    p = __fmaf_rn(p, q, 0.621000469f);
    p = __fmaf_rn(p, q, -0.494451523f);
    p = __fmaf_rn(p, q, 0.340488f);
    p = __fmaf_rn(p, q, -0.274112701f);
    p = __fmaf_rn(p, q, 0.563825965f);
  } else {
    p = __fmaf_rn(q, -10.477664f, 12.9772f);
    p = __fmaf_rn(p, q, -7.49551868f);
    p = __fmaf_rn(p, q, 2.92101908f);
    p = __fmaf_rn(p, q, -1.01526523f);
    p = __fmaf_rn(p, q, 0.42184633f);
    p = __fmaf_rn(p, q, -0.282076746f);
    p = __fmaf_rn(p, q, 0.564189494f);
  }
  float r = __fmul_rn(__fmul_rn(expf(nw), __fdiv_rn(1.0f, az)), p);
  if (nw < -88.7228394f) r = 0.0f;
  return z < 0.0f ? __fsub_rn(2.0f, r) : r;
}

template <int FORM, bool BF16>
__device__ __forceinline__ float gelu_one(float x) {
  if (FORM == 0) {  // erf
    if (BF16) {
      const float half = rb(__fmul_rn(x, 0.5f));
      const float y = rb(xla_erfc(__fmul_rn(-x, 0.70703125f)));
      return __fmul_rn(half, y);  // the caller rounds to bf16
    }
    return __fmul_rn(__fmul_rn(x, 0.5f), xla_erfc(__fmul_rn(-x, 0.707106769f)));
  }
  if (BF16) {  // tanh
    const float x3 = rb(__fmul_rn(rb(__fmul_rn(x, x)), x));
    const float inner = rb(__fmul_rn(rb(__fadd_rn(x, rb(__fmul_rn(x3, 0.0446777344f)))), 0.796875f));
    const float cdf = rb(__fmul_rn(rb(__fadd_rn(rb(tanhf(inner)), 1.0f)), 0.5f));
    return __fmul_rn(x, cdf);
  }
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(__fmaf_rn(x3, 0.044715f, x), 0.797884583f);
  return __fmul_rn(x, __fmul_rn(__fadd_rn(tanhf(inner), 1.0f), 0.5f));
}

// The gradient through gelu_one, as XLA compiles JAX's vjp of the same
// formula (d erfc(z) = -2/sqrt(pi) * exp(-z^2)), g the incoming gradient:
//
// * erf, bf16: z = -x * 0.70703125 (not rounded); t2 = bf16(bf16(bf16(0.5 * x)
//   * g) * -1.125); e = bf16(exp(-bf16(bf16(z)^2))); out = bf16(
//   -bf16(bf16(t2 * e) * 0.70703125) + bf16(bf16(g * bf16(erfc(z))) * 0.5)).
// * erf, f32: t3 = ((0.5 * x) * g * -1.12837923) * exp(-z^2); out =
//   fma(-t3, 0.707106769, (g * erfc(z)) * 0.5).
// * tanh: t = tanh(inner) of the forward; m6 = x * g * 0.5 * (1 - t);
//   a2 = m6 + m6 * t; out = g * cdf + a2 * c + a2 * c * k * 3x^2, every step
//   rounded to bf16 in bf16 (there a2 * c is rounded before the k term), with
//   fused multiply-adds and c * k folded to 0.0356774069 in f32.
template <int FORM, bool BF16>
__device__ __forceinline__ float gelu_grad(float x, float g) {
  if (FORM == 0) {  // erf
    if (BF16) {
      const float z = __fmul_rn(-x, 0.70703125f);
      const float t2 = rb(__fmul_rn(rb(__fmul_rn(rb(__fmul_rn(x, 0.5f)), g)), -1.125f));
      const float zb = rb(z);
      const float e = rb(expf(-rb(__fmul_rn(zb, zb))));
      const float d1 = -rb(__fmul_rn(rb(__fmul_rn(t2, e)), 0.70703125f));
      const float m0 = rb(__fmul_rn(rb(__fmul_rn(g, rb(xla_erfc(z)))), 0.5f));
      return __fadd_rn(d1, m0);  // the caller rounds to bf16
    }
    const float z = __fmul_rn(-x, 0.707106769f);
    const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(x, 0.5f), g), -1.12837923f);
    const float t3 = __fmul_rn(t2, expf(-__fmul_rn(z, z)));
    return __fmaf_rn(-t3, 0.707106769f, __fmul_rn(__fmul_rn(g, xla_erfc(z)), 0.5f));
  }
  if (BF16) {  // tanh
    const float x2 = rb(__fmul_rn(x, x));
    const float x3 = rb(__fmul_rn(x2, x));
    const float inner = rb(__fmul_rn(rb(__fadd_rn(x, rb(__fmul_rn(x3, 0.0446777344f)))), 0.796875f));
    const float t = rb(tanhf(inner));
    const float cdf = rb(__fmul_rn(rb(__fadd_rn(t, 1.0f)), 0.5f));
    const float direct = rb(__fmul_rn(g, cdf));
    const float m6 = rb(__fmul_rn(rb(__fmul_rn(rb(__fmul_rn(x, g)), 0.5f)), rb(__fsub_rn(1.0f, t))));
    const float a2 = rb(__fadd_rn(m6, rb(__fmul_rn(m6, t))));
    const float m3 = rb(__fmul_rn(a2, 0.796875f));
    const float a1 = rb(__fadd_rn(direct, m3));
    const float m0 = rb(__fmul_rn(rb(__fmul_rn(m3, 0.0446777344f)), rb(__fmul_rn(x2, 3.0f))));
    return __fadd_rn(a1, m0);
  }
  const float x2 = __fmul_rn(x, x);
  const float t = tanhf(__fmul_rn(__fmaf_rn(__fmul_rn(x2, x), 0.044715f, x), 0.797884583f));
  const float direct = __fmul_rn(g, __fmul_rn(__fadd_rn(t, 1.0f), 0.5f));
  const float m6 = __fmul_rn(__fmul_rn(__fmul_rn(x, g), 0.5f), __fsub_rn(1.0f, t));
  const float a2 = __fmaf_rn(m6, t, m6);
  const float a1 = __fmaf_rn(a2, 0.797884583f, direct);
  return __fmaf_rn(__fmul_rn(a2, 0.0356774069f), __fmul_rn(x2, 3.0f), a1);
}

// One element: the forward of x, or (BWD) the gradient at x given g.
template <int FORM, bool BF16, bool BWD>
__device__ __forceinline__ float one(float x, float g) {
  return BWD ? gelu_grad<FORM, BF16>(x, g) : gelu_one<FORM, BF16>(x);
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// g is read only by the backward (BWD); the forward passes nullptr.
template <typename T, int FORM, bool BWD>
__global__ void __launch_bounds__(kThreads)
gelu_scalar_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y, long long n) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    store_f(y + i, one<FORM, kBf16, BWD>(load_f(x + i), BWD ? load_f(g + i) : 0.0f));
  }
}

// 16 bytes a thread: 8 bf16 or 4 f32 through one uint4 (of x, and of g).
template <typename T, int FORM, bool BWD>
__global__ void __launch_bounds__(kThreads)
gelu_vec_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y, long long n) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kVec = 16 / sizeof(T);
  const long long chunks = n / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (long long c = first; c < chunks; c += stride) {
    const uint4 in = xv[c];
    uint4 gin = make_uint4(0, 0, 0, 0);
    if (BWD) gin = gv[c];
    uint4 out;
    const T* src = reinterpret_cast<const T*>(&in);
    const T* gsrc = reinterpret_cast<const T*>(&gin);
    T* dst = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      store_f(dst + k, one<FORM, kBf16, BWD>(load_f(src + k), BWD ? load_f(gsrc + k) : 0.0f));
    }
    yv[c] = out;
  }
  const long long tail = chunks * kVec + first;  // the last n % kVec elements
  if (tail < n) store_f(y + tail, one<FORM, kBf16, BWD>(load_f(x + tail), BWD ? load_f(g + tail) : 0.0f));
}

template <typename T, int FORM, bool BWD>
cudaError_t launch_typed(const void* x, const void* g, void* y, long long n, int variant,
                         cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  const T* gs = static_cast<const T*>(g);
  T* ys = static_cast<T*>(y);
  const long long per_thread = variant == 1 ? 16 / (long long)sizeof(T) : 1;
  long long blocks = (n / per_thread + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (variant == 1) {
    gelu_vec_kernel<T, FORM, BWD><<<(unsigned)blocks, kThreads, 0, stream>>>(xs, gs, ys, n);
  } else {
    gelu_scalar_kernel<T, FORM, BWD><<<(unsigned)blocks, kThreads, 0, stream>>>(xs, gs, ys, n);
  }
  return cudaGetLastError();
}

template <bool BWD>
int launch(const void* x, const void* g, void* y, long long n, int dtype, int form, int variant,
           void* stream) {
  if (n <= 0) return 0;
  if (dtype < 0 || dtype > 1 || form < 0 || form > 1 || variant < 0 || variant > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 1 && ((uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0 ||
                       (BWD && (uintptr_t)g % 16 != 0))) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = form == 0 ? launch_typed<float, 0, BWD>(x, g, y, n, variant, s)
                    : launch_typed<float, 1, BWD>(x, g, y, n, variant, s);
  } else {
    err = form == 0 ? launch_typed<__nv_bfloat16, 0, BWD>(x, g, y, n, variant, s)
                    : launch_typed<__nv_bfloat16, 1, BWD>(x, g, y, n, variant, s);
  }
  return (int)err;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; form: 0 erf, 1 tanh; variant: 0 scalar, 1 vec
// (every pointer at a 16-byte boundary). All tensors are contiguous, n values.

// y = gelu(x).
extern "C" int gelu_launch(const void* x, void* y, long long n, int dtype, int form,
                           int variant, void* stream) {
  return launch<false>(x, nullptr, y, n, dtype, form, variant, stream);
}

// dx = the gradient through gelu at x, given the incoming gradient g.
extern "C" int gelu_backward_launch(const void* x, const void* g, void* dx, long long n, int dtype,
                                    int form, int variant, void* stream) {
  return launch<true>(x, g, dx, n, dtype, form, variant, stream);
}
