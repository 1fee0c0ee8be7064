// Exact softmax attention per (batch, head) for ViT-class sequence lengths.
//
// Replaces the JAX package's head-resident Pallas kernel
// (kobato_eyes_tpu/ops/pallas_attention.py: _attn_body via _attn_call_packed
// and _attn_call). It computes what _attn_body computes:
//   q is scaled in its own dtype (1/sqrt(D) is a power of two, exact),
//   logits = q k^T accumulated in f32,
//   w = exp(logits - rowmax) rounded to v's dtype,
//   rowsum = sum(w) in f32, out = (w v accumulated in f32) / rowsum.
//
// The TPU design holds one head's whole (T, T) f32 logits in VMEM; at the
// ViT-B/448 shape (T = 785) that is 2.46 MB, ten times the 227 KB of shared
// memory a Hopper block can have. So this kernel is tiled with an online
// softmax: one block per (64-row q tile, head, batch), K/V staged through
// shared memory 64 rows at a time, a running row max, a running f32 row sum
// and an f32 output accumulator. The ragged last tile (785 = 12*64 + 17) is
// masked. q, k and v are read through strides straight from the packed
// (B, T, 3, H, D) projection and the output is written as (B, T, H, D), so
// the two whole-tensor transposes around the TPU call are gone.
//
// Bound on the card: 4*T^2*D*B*H operations (60.6 GFLOP per call at
// B=32, T=785, H=12, D=64) against 154 MB of qkv read and output written;
// at the bf16 tensor-core rate that is operation-bound. This first version
// does its products with f32 FMAs out of shared memory (no tensor cores),
// which is simple and exact in f32; moving the products to wgmma is later
// work.
//
// Plain C entry for ctypes: returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;          // q rows per block
constexpr int kCols = 64;          // k/v rows per shared-memory tile
constexpr int kThreads = 256;      // 4 threads per q row
constexpr int kColsPerThread = kCols / 4;

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

// x rounded through T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kCols * (D + 1) + kCols * D + kRows * (kCols + 1));
}

// Thread layout: row r = tid / 4 of the q tile belongs to a quad of threads;
// thread lane4 = tid % 4 of the quad owns key columns lane4 + 4j of each
// tile and output dims lane4 + 4j. The quad's q row lives in registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int t_len,
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
  const T* qb = q + in_base;
  const T* kb = k + in_base;
  const T* vb = v + in_base;

  const float scale_t = round_to<T>(scale);
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = row_ok ? to_f(qb[(long long)row * in_st + d]) : 0.f;
    qr[d] = round_to<T>(x * scale_t);
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
      if (c0 + c < t_len) {
        const long long off = (long long)(c0 + c) * in_st + d;
        kx = to_f(kb[off]);
        vx = to_f(vb[off]);
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
      const float p = round_to<T>(expf(s[j] - m_new));  // masked: exp(-inf) = 0
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
    T* orow = o + (long long)b * out_sb + (long long)h * out_sh + (long long)row * out_st;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) orow[lane4 + 4 * j] = from_f<T>(acc[j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int t_len, int heads,
                   long long in_sb, long long in_st, long long in_sh,
                   long long out_sb, long long out_st, long long out_sh,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((t_len + kRows - 1) / kRows, heads, batch);
  attn_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), t_len, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// (head_dim) stride is 1 for every tensor. q, k and v share their strides.
extern "C" int head_resident_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int batch, int t_len, int heads, int head_dim, int dtype_code,
    long long in_sb, long long in_st, long long in_sh,
    long long out_sb, long long out_st, long long out_sh,
    float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KET_ATTN_CASE(T, D)                                                     \
  return (int)launch<T, D>(q, k, v, o, batch, t_len, heads, in_sb, in_st, in_sh, \
                           out_sb, out_st, out_sh, scale, s)
  if (dtype_code == 0 && head_dim == 64) KET_ATTN_CASE(float, 64);
  if (dtype_code == 0 && head_dim == 32) KET_ATTN_CASE(float, 32);
  if (dtype_code == 1 && head_dim == 64) KET_ATTN_CASE(__nv_bfloat16, 64);
  if (dtype_code == 1 && head_dim == 32) KET_ATTN_CASE(__nv_bfloat16, 32);
#undef KET_ATTN_CASE
  return (int)cudaErrorInvalidValue;
}
