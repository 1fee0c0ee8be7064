// The host CPU's own reciprocal square root estimate (rsqrtps), as a table.
//
// XLA's CPU backend lowers f32 rsqrt to the 12-bit hardware estimate of
// _mm256_rsqrt_ps followed by two Newton steps (ops/xla_math.py writes the
// steps out). The estimate depends only on the parity of x's biased exponent
// and the top 10 bits of its mantissa, so 2048 calls give all of it: entry
// ((E & 1) << 10) | (mantissa >> 13) holds the f32 bits of the estimate of
// x = 2^(E0 - 127) * (1 + top10 / 1024) with E0 = 126 + (E & 1). Another
// exponent of the same parity moves the estimate's exponent by -(E - E0) / 2.
// The bits differ between x86 vendors, so the table is read from this host's
// instruction at run time and never stored.
//
// Plain C entry for ctypes: returns 0, or -1 where the host has no rsqrtps.

#include <stdint.h>
#include <string.h>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>

__attribute__((target("avx"))) static uint32_t estimate(uint32_t x_bits) {
  float x;
  memcpy(&x, &x_bits, 4);
  float y[8];
  _mm256_storeu_ps(y, _mm256_rsqrt_ps(_mm256_set1_ps(x)));
  uint32_t y_bits;
  memcpy(&y_bits, &y[0], 4);
  return y_bits;
}
#endif

extern "C" int xla_rsqrt_estimate_table(uint32_t* out) {
#if defined(__x86_64__) || defined(__i386__)
  if (!__builtin_cpu_supports("avx")) return -1;
  for (uint32_t key = 0; key < 2048; ++key) {
    const uint32_t e0 = 126u + (key >> 10);
    out[key] = estimate((e0 << 23) | ((key & 1023u) << 13));
  }
  return 0;
#else
  (void)out;
  return -1;
#endif
}
