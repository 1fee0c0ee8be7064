// Exact softmax attention per (batch, head) for ViT-class sequence lengths.
//
// Replaces the JAX package's head-resident Pallas kernel
// (kobato_eyes_tpu/ops/pallas_attention.py: _attn_body via _attn_call_packed
// and _attn_call). It computes what _attn_body computes:
//   q is scaled in its own dtype (the scale rounded to that dtype first),
//   logits = q k^T accumulated in f32,
//   w = exp(logits - rowmax) rounded to v's dtype,
//   rowsum = sum(w) in f32, out = (w v accumulated in f32) / rowsum.
//
// The TPU design holds one head's whole (T, T) f32 logits in VMEM; at the
// ViT-B/448 shape (T = 785) that is 2.46 MB, ten times the 227 KB of shared
// memory a Hopper block can have. So both kernels here tile the keys with an
// online softmax (a running row max, a running f32 row sum, an f32 output
// accumulator) and never write the logits to device memory. q, k and v are
// read through strides straight from the packed (B, T, 3, H, D) projection
// and the output is written as (B, T, H, D), so the two whole-tensor
// transposes around the TPU call are gone.
//
// Bound on the card: 4*T^2*D*B*H operations (60.6 GFLOP per call at
// B=32, T=785, H=12, D=64) against 154 MB of qkv read and output written;
// at the bf16 tensor-core rate that is operation-bound, so the products
// have to run on the tensor cores.
//
// Two kernels, picked by dtype:
//
//  * bfloat16 (the main path): attn_wgmma_kernel of attention_wgmma.cuh,
//    the tensor-core body this file shares with the flash forward, at every
//    head width: the width rounded up to 16 (the wgmma depth) is a template
//    instance, the columns past d zero-filled in shared memory. A block
//    takes 128 q rows in two warpgroups that share each 64-key K/V tile of
//    a three-stage cp.async ring; S = Q K^T and O += P V by wgmma, the
//    online softmax on the accumulator fragment in registers, P rounded to
//    bf16 there as the register operand of the second product (the
//    header says more).
//
//  * float32: attn_fma_kernel, f32 FMAs out of shared memory. Tensor cores
//    would mean TF32 operands, which the port does not use. One block per
//    64-row q tile, four threads a row; the head width padded to 32, 64 or
//    128 with zeros.
//
// Plain C entry for ctypes: returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int kRows = 64;          // q rows per block
constexpr int kCols = 64;          // k/v rows per shared-memory tile
constexpr int kThreads = 256;      // 4 threads per q row
constexpr int kColsPerThread = kCols / 4;

template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (kCols * (D + 1) + kCols * D + kRows * (kCols + 1));
}

// Thread layout: row r = tid / 4 of the q tile belongs to a quad of threads;
// thread lane4 = tid % 4 of the quad owns key columns lane4 + 4j of each
// tile and output dims lane4 + 4j. The quad's q row lives in registers. D is
// the head width d padded to 32, 64 or 128 with zero columns.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int t_len, int head_dim,
                long long in_sb, long long in_st, long long in_sh,
                long long out_sb, long long out_st, long long out_sh,
                float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                      // [kCols][D + 1]
  float* vs = ks + kCols * (D + 1);      // [kCols][D]
  float* ps = vs + kCols * D;            // [kRows][kCols + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int lane4 = tid & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kRows + r;
  const bool row_ok = row < t_len;

  const long long in_base = (long long)b * in_sb + (long long)h * in_sh;
  const float* qb = q + in_base;
  const float* kb = k + in_base;
  const float* vb = v + in_base;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = row_ok && d < head_dim ? qb[(long long)row * in_st + d] : 0.f;
    qr[d] = x * scale;
  }

  constexpr int kDimsPerThread = D / 4;
  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc[j] = 0.f;
  float m = -INFINITY;  // running row max
  float l = 0.f;        // this thread's share of the running row sum

  for (int c0 = 0; c0 < t_len; c0 += kCols) {
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int i = tid; i < kCols * D; i += kThreads) {
      const int c = i / D;
      const int d = i - c * D;
      float kx = 0.f, vx = 0.f;
      if (c0 + c < t_len && d < head_dim) {
        const long long off = (long long)(c0 + c) * in_st + d;
        kx = kb[off];
        vx = vb[off];
      }
      ks[c * (D + 1) + d] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[kColsPerThread];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = lane4 + 4 * j;
      const float* kr = ks + c * (D + 1);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      s[j] = (c0 + c < t_len) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // every tile holds at least one unmasked column, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float p = expf(s[j] - m_new);  // masked: exp(-inf) = 0
      psum += p;
      ps[r * (kCols + 1) + lane4 + 4 * j] = p;
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) acc[j] *= alpha;
    const float* pr = ps + r * (kCols + 1);
    for (int c = 0; c < kCols; ++c) {
      const float p = pr[c];
      const float* vr = vs + c * D + lane4;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j) acc[j] = fmaf(p, vr[4 * j], acc[j]);
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (row_ok) {
    float* orow = o + (long long)b * out_sb + (long long)h * out_sh + (long long)row * out_st;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) {
      if (lane4 + 4 * j < head_dim) orow[lane4 + 4 * j] = acc[j] / l;
    }
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int batch, int t_len, int heads, int head_dim,
                       long long in_sb, long long in_st, long long in_sh,
                       long long out_sb, long long out_st, long long out_sh,
                       float scale, cudaStream_t stream) {
  constexpr size_t bytes = fma_smem_bytes<D>();
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((t_len + kRows - 1) / kRows, heads, batch);
  attn_fma_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), t_len, head_dim, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the wgmma body (attention_wgmma.cuh)
// ---------------------------------------------------------------------------

template <int D16, bool FULL>
cudaError_t launch_wgmma_body(const void* q, const void* k, const void* v, void* o,
                              int batch, int t_len, int heads, int d,
                              long long in_sb, long long in_st, long long in_sh,
                              long long out_sb, long long out_st, long long out_sh,
                              float scale, cudaStream_t stream) {
  constexpr size_t bytes = wgmma_smem_bytes<D16>();
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_wgmma_kernel<D16, FULL, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((t_len + kQRows - 1) / kQRows, heads, batch);
  attn_wgmma_kernel<D16, FULL, false><<<grid, kNumThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), nullptr, nullptr, t_len, heads, d, in_sb, in_st, in_sh, out_sb, out_st, out_sh,
      scale);
  return cudaGetLastError();
}

template <int D16>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int batch, int t_len, int heads, int d,
                         long long in_sb, long long in_st, long long in_sh,
                         long long out_sb, long long out_st, long long out_sh,
                         float scale, cudaStream_t stream) {
  auto launch = d == D16 ? launch_wgmma_body<D16, true> : launch_wgmma_body<D16, false>;
  return launch(q, k, v, o, batch, t_len, heads, d, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale, stream);
}

}  // namespace

// dtype_code: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel); head_dim
// 1 .. 128. Strides are in elements; the last (head_dim) stride is 1 for
// every tensor. q, k and v share their strides. bfloat16 q, k and v are read
// 16 bytes at a time: pointers 16-byte aligned, strides multiples of 8; the
// output is written so where its view allows it.
extern "C" int head_resident_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int batch, int t_len, int heads, int head_dim, int dtype_code,
    long long in_sb, long long in_st, long long in_sh,
    long long out_sb, long long out_st, long long out_sh,
    float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || head_dim <= 0 ||
      head_dim > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KET_ATTN_ARGS \
  q, k, v, o, batch, t_len, heads, head_dim, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale, s
  if (dtype_code == 0) {
    if (head_dim <= 32) return (int)launch_fma<32>(KET_ATTN_ARGS);
    if (head_dim <= 64) return (int)launch_fma<64>(KET_ATTN_ARGS);
    return (int)launch_fma<128>(KET_ATTN_ARGS);
  }
  if (dtype_code == 1) {
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
    if ((ptrs & 15) || ((in_sb | in_st | in_sh) & 7)) return (int)cudaErrorMisalignedAddress;
    switch ((head_dim + 15) / 16) {
      case 1: return (int)launch_wgmma<16>(KET_ATTN_ARGS);
      case 2: return (int)launch_wgmma<32>(KET_ATTN_ARGS);
      case 3: return (int)launch_wgmma<48>(KET_ATTN_ARGS);
      case 4: return (int)launch_wgmma<64>(KET_ATTN_ARGS);
      case 5: return (int)launch_wgmma<80>(KET_ATTN_ARGS);
      case 6: return (int)launch_wgmma<96>(KET_ATTN_ARGS);
      case 7: return (int)launch_wgmma<112>(KET_ATTN_ARGS);
      default: return (int)launch_wgmma<128>(KET_ATTN_ARGS);
    }
  }
#undef KET_ATTN_ARGS
  return (int)cudaErrorInvalidValue;
}
