// XLA's CPU f32 rsqrt on the card, for the kernels that must round as the
// JAX package's CPU run does (the window kernel's q and k normalisation).
//
// XLA lowers jax.lax.rsqrt on an x86 CPU to the 12-bit estimate of
// _mm256_rsqrt_ps and two Newton steps, y = fma(-0.5 * y, fma(x * y, y, -1), y)
// (x * y and -0.5 * y rounded), keeping the raw estimate for zeros,
// subnormals, +inf and negative numbers (llvm.is.fpclass mask 764). The
// estimate depends only on the exponent's parity and the top 10 mantissa
// bits: a table of 2048 f32 bit patterns, read from the host's own
// instruction (ops/xla_math.rsqrt_estimate_table) and copied into this
// module's device memory once a device by xla_rsqrt_ensure_table. Kernels
// read it through the read-only cache, or from a copy in shared memory
// (xla_rsqrt_table_to_shared); constant memory would serialise a warp's
// distinct addresses, and the window kernel's "mma" body looks up eight
// rows at once. Entry
// ((E & 1) << 10) | (mantissa >> 13) is the estimate in the binade
// E0 = 126 + (E & 1); E moves it by -(E - E0) / 2 binades.
//
// ops/xla_math.rsqrt_plain is the same function in torch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ uint32_t g_xla_rsqrt_table[2048];

__device__ __forceinline__ float xla_rsqrt(float x) {
  const uint32_t b = __float_as_uint(x);
  const uint32_t e = (b >> 23) & 0xFFu;
  if (isnan(x)) return __uint_as_float(b | 0x00400000u);
  if (e == 0) return (b >> 31) ? -INFINITY : INFINITY;  // zeros and subnormals
  if (b >> 31) return __uint_as_float(0xFFC00000u);     // negatives: the default NaN
  if (e == 255) return 0.f;                             // +inf
  const int shift = ((int)e - 126 - (int)(e & 1u)) / 2;
  float y = __uint_as_float(__ldg(&g_xla_rsqrt_table[((e & 1u) << 10) | ((b >> 13) & 1023u)]) -
                            ((uint32_t)shift << 23));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    y = __fmaf_rn(__fmul_rn(y, -0.5f), __fmaf_rn(__fmul_rn(x, y), y, -1.0f), y);
  return y;
}

constexpr uint32_t kXlaRsqrtBase = 0x3F000000u;  // of the shared copy's entries

// The same for x >= 1e-12 or +inf, as the window kernels' floored sums of
// squares are: the estimate and the steps without the other specials' tests,
// the estimate from the table's copy in shared memory (xla_rsqrt_table_to_shared),
// or from device memory where table_s is null.
__device__ __forceinline__ float xla_rsqrt_floored(float x, const uint16_t* table_s = nullptr) {
  const uint32_t b = __float_as_uint(x);
  const uint32_t e = b >> 23;
  const uint32_t key = ((e & 1u) << 10) | ((b >> 13) & 1023u);
  const uint32_t est =
      table_s != nullptr ? kXlaRsqrtBase + ((uint32_t)table_s[key] << 11) : __ldg(&g_xla_rsqrt_table[key]);
  const int shift = ((int)e - 126 - (int)(e & 1u)) / 2;
  float y = __uint_as_float(est - ((uint32_t)shift << 23));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    y = __fmaf_rn(__fmul_rn(y, -0.5f), __fmaf_rn(__fmul_rn(x, y), y, -1.0f), y);
  return e == 255 ? 0.f : y;
}

// A block's copy of the table in shared memory, 16 bits an entry: every
// estimate lies in [0.5, 2) with its low 11 bits 0, so (bits - 0x3F000000)
// >> 11 keeps all of it. The window kernel's "mma" body reads it there: its
// small L1 (the rest of the SM's 256 KB is its shared memory) lets the
// device-memory table fall out, and each lookup then waits on L2.
constexpr size_t kXlaRsqrtSharedBytes = 2048 * sizeof(uint16_t);

__device__ __forceinline__ void xla_rsqrt_table_to_shared(uint16_t* table_s, int tid, int n_threads) {
  for (int i = tid; i < 2048; i += n_threads) table_s[i] = (uint16_t)((g_xla_rsqrt_table[i] - kXlaRsqrtBase) >> 11);
}

// Copies the 2048-entry table into device memory on the current device,
// the first time a device is seen. Synchronous: call it outside a CUDA graph
// capture (a module's first launch on a device).
cudaError_t xla_rsqrt_ensure_table(const void* host_table) {
  static unsigned uploaded = 0;  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (uploaded >> dev) & 1u) return cudaSuccess;
  if (host_table == nullptr) return cudaErrorInvalidValue;
  err = cudaMemcpyToSymbol(g_xla_rsqrt_table, host_table, sizeof(g_xla_rsqrt_table));
  if (err == cudaSuccess && dev < 32) uploaded |= 1u << dev;
  return err;
}

}  // namespace
