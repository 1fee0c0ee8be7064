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
// 3.35 TB/s); the gradient reads x and g and writes dx (three tensors'
// bytes). Computed element by element, the bf16 sequences above take more
// instructions than the card can issue in that time (every bf16 rounding a
// convert pair, tanhf / expf, erfc's arms), so bf16 has a body of its own.
// Three bodies, chosen by dtype and alignment (the wrapper's
// kernel_variant), never one after the other's failure:
//
// * "lut" (bf16, every tensor at a 16-byte boundary). In bf16 the forward's
//   output is a function of the one 16-bit input, and so are the gradient's
//   factors of x alone (erf: e = bf16(exp(-bf16(bf16(z)^2))) and E =
//   bf16(erfc(z)); tanh: t = bf16(tanh(inner)) and cdf), each a value the
//   HLO rounds to bf16. Outside a window of binades [lo, lo + span) of |x|
//   one rule gives them: below it the forward is bf16(0.5 * x) and the
//   factors are (1, 1) (erf) or (bf16(0.796875 * x), 0.5) (tanh); above it
//   the forward is bf16(x * (x > 0)) (x, a signed zero, or inf * 0 = NaN)
//   and the factors (0, 2) / (0, 0) (erf, x > 0 / x < 0) or (1, 1) /
//   (-1, 0) (tanh). Inside it a table gives them, built on the card by
//   gelu_table_kernel, which runs the "vec" body's own functions once over
//   the window's 2 * span bit patterns (positive then negative |x|): one
//   bf16 output, or one uint32 of two bf16 factors (first factor low), an
//   entry. The window (2^-9 .. 2^3 erf, 2^-9 .. 2^1 tanh: 6.5 / 5.5 KB
//   forward, 13 / 11 KB backward) and the rules were found by comparing
//   with that body on all 65 536 bf16 inputs; ops/gelu.py holds the window
//   and a plain mirror of the lookup. A block copies the table into shared
//   memory, then takes 4 x 256 consecutive 16-byte chunks (8 bf16 each) of
//   x (and g), a thread issuing its four loads before its first lookup;
//   every lane reads an entry and selects (no branch on the window). On an
//   H100 that ran faster than a persistent grid-stride loop of two chunks
//   an iteration, whose skeleton alone (a plain copy through it) was slower
//   than this one's. The gradient
//   keeps its g-dependent steps, in the order above, with two neighbouring
//   elements' roundings in one convert (cvt.rn.bf16x2.f32).
// * "vec" (f32, or bf16 on request; every tensor at a 16-byte boundary). A
//   thread loads 16 bytes of each input (8 bf16 or 4 f32), computes and
//   stores 16 bytes; neighbouring threads own neighbouring chunks, a
//   grid-stride loop walks the tensor, and the n % (16 / sizeof(T))
//   elements after the last chunk go one a thread.
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
constexpr int kLutChunks = 4;         // 16-byte chunks a thread of the "lut" body

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
// Elementwise f32 steps on one value or on two neighbouring values (the
// "lut" body's pairs): rb2 rounds both with one convert.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
}
__device__ __forceinline__ float2 mul(float2 a, float b) { return make_float2(__fmul_rn(a.x, b), __fmul_rn(a.y, b)); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float one_minus(float a) { return __fsub_rn(1.0f, a); }
__device__ __forceinline__ float2 one_minus(float2 a) { return make_float2(__fsub_rn(1.0f, a.x), __fsub_rn(1.0f, a.y)); }
__device__ __forceinline__ float neg(float a) { return -a; }
__device__ __forceinline__ float2 neg(float2 a) { return make_float2(-a.x, -a.y); }

// Two bf16 in one word (first low) and back: bf16 -> f32 is a shift.
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // one cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 rb(float2 v) { return unpack2(pack2(v.x, v.y)); }
__device__ __forceinline__ uint32_t bf16_bits(float v) {  // v holds a bf16 value
  return __float_as_uint(v) >> 16;
}

// The gradient through gelu_one, as XLA compiles JAX's vjp of the same
// formula (d erfc(z) = -2/sqrt(pi) * exp(-z^2)), g the incoming gradient:
//
// * erf, bf16: z = -x * 0.70703125 (not rounded); t2 = bf16(bf16(bf16(0.5 * x)
//   * g) * -1.125); e = bf16(exp(-bf16(bf16(z)^2))); out = bf16(
//   -bf16(bf16(t2 * e) * 0.70703125) + bf16(bf16(g * E) * 0.5)), E = bf16(erfc(z)).
// * erf, f32: t3 = ((0.5 * x) * g * -1.12837923) * exp(-z^2); out =
//   fma(-t3, 0.707106769, (g * erfc(z)) * 0.5).
// * tanh: t = tanh(inner) of the forward; m6 = x * g * 0.5 * (1 - t);
//   a2 = m6 + m6 * t; out = g * cdf + a2 * c + a2 * c * k * 3x^2, every step
//   rounded to bf16 in bf16 (there a2 * c is rounded before the k term), with
//   fused multiply-adds and c * k folded to 0.0356774069 in f32.
//
// In bf16 each form splits into factors of x alone (grad_factors, which
// the "lut" body's table holds) and the steps that take g (grad_apply).
template <int FORM>
__device__ __forceinline__ void grad_factors(float x, float& a, float& c) {
  if (FORM == 0) {  // erf: e, E
    const float z = __fmul_rn(-x, 0.70703125f);
    const float zb = rb(z);
    a = rb(expf(-rb(__fmul_rn(zb, zb))));
    c = rb(xla_erfc(z));
  } else {  // tanh: t, cdf
    const float x3 = rb(__fmul_rn(rb(__fmul_rn(x, x)), x));
    const float inner = rb(__fmul_rn(rb(__fadd_rn(x, rb(__fmul_rn(x3, 0.0446777344f)))), 0.796875f));
    a = rb(tanhf(inner));
    c = rb(__fmul_rn(rb(__fadd_rn(a, 1.0f)), 0.5f));
  }
}

// V is float (one element) or float2 (two); the result is rounded to bf16
// by the caller.
template <int FORM, typename V>
__device__ __forceinline__ V grad_apply(V x, V g, V a, V c) {
  if (FORM == 0) {  // erf: a = e, c = E
    const V t2 = rb(mul(rb(mul(rb(mul(x, 0.5f)), g)), -1.125f));
    const V d1 = neg(rb(mul(rb(mul(t2, a)), 0.70703125f)));
    const V m0 = rb(mul(rb(mul(g, c)), 0.5f));
    return add(d1, m0);
  }
  // tanh: a = t, c = cdf
  const V x2 = rb(mul(x, x));
  const V direct = rb(mul(g, c));
  const V m6 = rb(mul(rb(mul(rb(mul(x, g)), 0.5f)), rb(one_minus(a))));
  const V a2 = rb(add(m6, rb(mul(m6, a))));
  const V m3 = rb(mul(a2, 0.796875f));
  const V a1 = rb(add(direct, m3));
  const V m0 = rb(mul(rb(mul(m3, 0.0446777344f)), rb(mul(x2, 3.0f))));
  return add(a1, m0);
}

template <int FORM, bool BF16>
__device__ __forceinline__ float gelu_grad(float x, float g) {
  if (BF16) {
    float a, c;
    grad_factors<FORM>(x, a, c);
    return grad_apply<FORM>(x, g, a, c);
  }
  if (FORM == 0) {  // erf
    const float z = __fmul_rn(-x, 0.707106769f);
    const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(x, 0.5f), g), -1.12837923f);
    const float t3 = __fmul_rn(t2, expf(-__fmul_rn(z, z)));
    return __fmaf_rn(-t3, 0.707106769f, __fmul_rn(__fmul_rn(g, xla_erfc(z)), 0.5f));
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

// ---- the "lut" body (bf16) ----
//
// b is one bf16 bit pattern; i = (b & 0x7FFF) - lo, unsigned: inside the
// window when i < span (its entry at i, or i + span for a negative x),
// below it when (int)i < 0, above it otherwise.

// The forward of the two bf16 in w (first low). Branch-free: every lane
// reads an entry (entry 0 when outside the window) and selects.
__device__ __forceinline__ uint32_t lut_forward_word(uint32_t w, const uint16_t* tab, uint32_t lo,
                                                     uint32_t span) {
  const uint32_t b0 = w & 0xFFFFu, b1 = w >> 16;
  const uint32_t i0 = (b0 & 0x7FFFu) - lo, i1 = (b1 & 0x7FFFu) - lo;
  const bool in0 = i0 < span, in1 = i1 < span;
  const uint32_t t0 = tab[in0 ? i0 + (b0 >> 15) * span : 0];
  const uint32_t t1 = tab[in1 ? i1 + (b1 >> 15) * span : 0];
  // outside the window: bf16(x * 0.5) below it, bf16(x * (x > 0)) above it
  const float m0 = (int)i0 < 0 ? 0.5f : (b0 & 0x8000u ? 0.0f : 1.0f);
  const float m1 = (int)i1 < 0 ? 0.5f : (b1 & 0x8000u ? 0.0f : 1.0f);
  const float2 x = unpack2(w);
  const uint32_t r = pack2(__fmul_rn(x.x, m0), __fmul_rn(x.y, m1));
  return (in0 ? t0 : r & 0xFFFFu) | (in1 ? t1 << 16 : r & 0xFFFF0000u);
}

// The packed factors (first low) of one bf16 input b (x its value),
// branch-free as above.
template <int FORM>
__device__ __forceinline__ uint32_t lut_factors(uint32_t b, float x, const uint32_t* tab, uint32_t lo,
                                                uint32_t span) {
  const uint32_t i = (b & 0x7FFFu) - lo;
  const bool in = i < span;
  const uint32_t t = tab[in ? i + (b >> 15) * span : 0];
  uint32_t rule;
  if (FORM == 0) {
    rule = (int)i < 0 ? 0x3F803F80u : (b & 0x8000u ? 0u : 0x40000000u);  // (1, 1) (0, 2) (0, 0)
  } else {  // (0.796875 x, 0.5) (-1, 0) (1, 1)
    rule = (int)i < 0 ? 0x3F000000u | bf16_bits(rb(__fmul_rn(x, 0.796875f))) : (b & 0x8000u ? 0x0000BF80u : 0x3F803F80u);
  }
  return in ? t : rule;
}

// The gradient at the two bf16 of w given the two of gw.
template <int FORM>
__device__ __forceinline__ uint32_t lut_backward_word(uint32_t w, uint32_t gw, const uint32_t* tab,
                                                      uint32_t lo, uint32_t span) {
  const float2 x = unpack2(w);
  const uint32_t f0 = lut_factors<FORM>(w & 0xFFFFu, x.x, tab, lo, span);
  const uint32_t f1 = lut_factors<FORM>(w >> 16, x.y, tab, lo, span);
  const float2 a = make_float2(__uint_as_float(f0 << 16), __uint_as_float(f1 << 16));
  const float2 c = make_float2(__uint_as_float(f0 & 0xFFFF0000u), __uint_as_float(f1 & 0xFFFF0000u));
  const float2 out = grad_apply<FORM>(x, unpack2(gw), a, c);
  return pack2(out.x, out.y);
}

template <int FORM, bool BWD>
__device__ __forceinline__ uint32_t lut_word(uint32_t w, uint32_t gw, const void* tab, uint32_t lo,
                                             uint32_t span) {
  if (BWD) return lut_backward_word<FORM>(w, gw, static_cast<const uint32_t*>(tab), lo, span);
  return lut_forward_word(w, static_cast<const uint16_t*>(tab), lo, span);
}

template <int FORM, bool BWD>
__device__ __forceinline__ uint4 lut_chunk(uint4 in, uint4 gin, const void* tab, uint32_t lo, uint32_t span) {
  return make_uint4(lut_word<FORM, BWD>(in.x, gin.x, tab, lo, span), lut_word<FORM, BWD>(in.y, gin.y, tab, lo, span),
                    lut_word<FORM, BWD>(in.z, gin.z, tab, lo, span), lut_word<FORM, BWD>(in.w, gin.w, tab, lo, span));
}

// The window's entries from the "vec" body's functions: entry i is the
// pattern lo + i % span, negative from i = span on.
template <int FORM, bool BWD>
__global__ void gelu_table_kernel(void* tab, uint32_t lo, uint32_t span) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * span) return;
  const uint32_t b = (i >= span ? 0x8000u : 0u) | (lo + i % span);
  const float x = __uint_as_float(b << 16);
  if (BWD) {
    float a, c;
    grad_factors<FORM>(x, a, c);
    static_cast<uint32_t*>(tab)[i] = bf16_bits(a) | (bf16_bits(c) << 16);
  } else {
    static_cast<uint16_t*>(tab)[i] = (uint16_t)bf16_bits(rb(gelu_one<FORM, true>(x)));
  }
}

// n bf16 values: n / 8 chunks of 16 bytes, kLutChunks a thread (a block
// takes kLutChunks * kThreads consecutive chunks, all its loads issued
// before the first lookup), then the n % 8 after the last chunk one a
// thread of block 0. table: 2 * span entries (table_bytes), copied to
// shared memory first.
template <int FORM, bool BWD>
__global__ void __launch_bounds__(kThreads)
gelu_lut_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ g, uint16_t* __restrict__ y,
                long long n, const uint4* __restrict__ table, uint32_t table_bytes, uint32_t lo, uint32_t span) {
  extern __shared__ uint4 shared_table[];
  for (uint32_t k = threadIdx.x; k < table_bytes / 16; k += blockDim.x) shared_table[k] = table[k];
  __syncthreads();
  const void* tab = shared_table;
  const long long chunks = n / 8;
  const long long first = (long long)blockIdx.x * kThreads * kLutChunks + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 in[kLutChunks], gin[kLutChunks];
#pragma unroll
  for (int u = 0; u < kLutChunks; ++u) {
    const long long c = first + u * kThreads;
    in[u] = c < chunks ? xv[c] : zero;
    gin[u] = BWD && c < chunks ? gv[c] : zero;
  }
#pragma unroll
  for (int u = 0; u < kLutChunks; ++u) {
    const long long c = first + u * kThreads;
    if (c < chunks) yv[c] = lut_chunk<FORM, BWD>(in[u], gin[u], tab, lo, span);
  }
  const long long tail = chunks * 8 + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) {
    y[tail] = (uint16_t)lut_word<FORM, BWD>(x[tail], BWD ? g[tail] : 0u, tab, lo, span);
  }
}

template <int FORM, bool BWD>
cudaError_t launch_lut_typed(const void* x, const void* g, void* y, long long n, const void* table,
                             uint32_t table_bytes, uint32_t lo, uint32_t span, cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kLutChunks;
  long long blocks = (n / 8 + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;  // the tail alone
  gelu_lut_kernel<FORM, BWD><<<(unsigned)blocks, kThreads, table_bytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(g), static_cast<uint16_t*>(y), n,
      static_cast<const uint4*>(table), table_bytes, lo, span);
  return cudaGetLastError();
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

// The "lut" body, bf16 only: form 0 erf, 1 tanh; table of 2 * span entries
// for the window [lo, lo + span) of |x|'s bit patterns, built by
// gelu_table_build for that form and direction. x, y (and g), table at
// 16-byte boundaries; span a multiple of 128.
static int check_lut(const void* x, const void* g, const void* y, int form, const void* table,
                     unsigned lo, unsigned span, unsigned entry_bytes) {
  if (form < 0 || form > 1 || table == nullptr || span == 0 || span % 128 != 0 || lo + span > 0x7F80u) {
    return (int)cudaErrorInvalidValue;
  }
  if (2u * span * entry_bytes > 48u * 1024u) return (int)cudaErrorInvalidValue;  // the default shared limit
  if ((uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0 || (g != nullptr && (uintptr_t)g % 16 != 0) ||
      (uintptr_t)table % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  return 0;
}

// table[2 * span] (uint16 forward, uint32 backward) from the "vec" body.
extern "C" int gelu_table_build(void* table, int form, int backward, unsigned lo, unsigned span, void* stream) {
  const int bad = check_lut(table, nullptr, table, form, table, lo, span, backward ? 4 : 2);
  if (bad != 0) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (2 * span + kThreads - 1) / kThreads;
  if (backward) {
    if (form == 0) gelu_table_kernel<0, true><<<blocks, kThreads, 0, s>>>(table, lo, span);
    else gelu_table_kernel<1, true><<<blocks, kThreads, 0, s>>>(table, lo, span);
  } else {
    if (form == 0) gelu_table_kernel<0, false><<<blocks, kThreads, 0, s>>>(table, lo, span);
    else gelu_table_kernel<1, false><<<blocks, kThreads, 0, s>>>(table, lo, span);
  }
  return (int)cudaGetLastError();
}

// y = gelu(x), bf16, from the forward table.
extern "C" int gelu_lut_launch(const void* x, void* y, long long n, int form, const void* table, unsigned lo,
                               unsigned span, void* stream) {
  if (n <= 0) return 0;
  const int bad = check_lut(x, nullptr, y, form, table, lo, span, 2);
  if (bad != 0) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t bytes = 2 * span * 2;
  return (int)(form == 0 ? launch_lut_typed<0, false>(x, nullptr, y, n, table, bytes, lo, span, s)
                         : launch_lut_typed<1, false>(x, nullptr, y, n, table, bytes, lo, span, s));
}

// dx = the gradient at x given g, bf16, from the backward table.
extern "C" int gelu_backward_lut_launch(const void* x, const void* g, void* dx, long long n, int form,
                                        const void* table, unsigned lo, unsigned span, void* stream) {
  if (n <= 0) return 0;
  if (g == nullptr) return (int)cudaErrorInvalidValue;
  const int bad = check_lut(x, g, dx, form, table, lo, span, 4);
  if (bad != 0) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t bytes = 2 * span * 4;
  return (int)(form == 0 ? launch_lut_typed<0, true>(x, g, dx, n, table, bytes, lo, span, s)
                         : launch_lut_typed<1, true>(x, g, dx, n, table, bytes, lo, span, s));
}
