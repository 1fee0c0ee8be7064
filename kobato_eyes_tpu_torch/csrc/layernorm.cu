// The port's LayerNorms in one pass each: a row read once, its f32
// statistics, the affine and, for SwinV2's post-norm residual, the add of the
// shortcut, the output written once.
//
// Not a port of a TPU kernel: the JAX package leaves its LayerNorms to XLA,
// which fuses each into a loop over a row. The port wrote them op by op in
// torch (models/vit.py LayerNorm, models/swin.py ResidualPostNorm under
// ln_impl="xla"): some twelve passes over f32 copies of the rows, about 60
// bytes of traffic an element where one bf16 pass needs 4. This kernel keeps
// each module's arithmetic, per row of C values x (bf16 or f32):
//
//   S = sum(x), Q = sum(round(x * x)) in f32; mean = S * fl(1 / C) and
//   m2 = Q * fl(1 / C), as torch's CUDA mean multiplies its sum by the f32
//   reciprocal of the count;
//   epilogue 0 (vit.LayerNorm, flax's): var = max(m2 - mean^2, 0),
//     mul = rsqrt(var + eps) * w, y = (x - mean) * mul + b, rounded once to
//     the output's dtype;
//   epilogue 1 (ResidualPostNorm, the JAX package's): var = m2 - mean^2,
//     y = ((x - mean) * rsqrt(var + eps)) * w + b, y rounded to the output's
//     dtype, then shortcut + y in f32 rounded again, as the chain's add in
//     that dtype does.
//
// rsqrt is XLA's CPU one (xla_rsqrt.cuh, the host's estimate table), as
// xla_math.rsqrt gives the modules. Every step is __fadd_rn, __fmul_rn or
// __fsub_rn, so nothing contracts into an FMA. w and b are read as stored,
// f32 or bf16. The only freedom taken is the order in which a row's two sums
// are added; ops/layernorm.py's plain version adds in the same order, and on
// the card the kernel equals it bit for bit.
//
// Bound on the card: bytes. x is read once, the shortcut once, the output
// written once (EVA02-L/448 at batch 32: 134 MB at C = 1024, 358 MB at the
// SwiGLU's C = 2730; SwinV2-B/448's stage-0 post-norm 308 MB), against a few
// operations an element. So:
//
// * A thread owns chunks of E consecutive columns, E as wide as one 16-byte
//   load holds where C, the rows' addresses and their pitch allow it, and 8,
//   4 or 2 bytes, or one element, otherwise (EVA02's 2730-column bf16 rows:
//   4-byte loads). Neighbouring threads read neighbouring chunks.
// * The output's rows may lie further apart than C (EVA02's SwiGLU hidden is
//   written at a 2752-column pitch, so the product after it runs on
//   16-byte-aligned rows): the columns past C are written 0. Only epilogue 0
//   with x in the output's type has such instances (PAD below): the SwiGLU's
//   case, and no other caller's.
// * T threads a row, K chunks a thread (thread t owns chunks t, t + T, ...):
//   T = 16 or 32 (a half warp or a warp; 128-thread blocks) for rows of up
//   to 256 chunks, a block a row beyond: 128 threads with up to 12 chunks
//   each, 256 past 1536 chunks. EVA02's 2730 columns (1365 chunks) ran in
//   0.136 ms on 128 threads with 11 chunks each, 0.159 ms on 256 with 6,
//   0.153 ms on 64 with 22, and 0.204 ms on a warp with 43 (on one H100).
// * Every load of x and of the shortcut is issued before the first sum, so
//   a row makes one trip to device memory; the row stays in registers as
//   loaded and is unpacked where it is used.
//
// The sums: each thread adds its values in column order (its chunks in
// order, each chunk's values in order), then a butterfly of xor shuffles
// over min(T, 32) lanes (every lane ends with the same bits: a + b == b + a);
// a block's warp sums are then added in warp order from shared memory.
// The body is chosen from C, the dtypes and the alignment alone
// (ops/layernorm.layout); the launch refuses a layout that does not fit them.
//
// Plain C entry for ctypes: returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "xla_rsqrt.cuh"

namespace {

constexpr int kWarpBodyThreads = 128;  // block size of the (half-)warp-a-row bodies
constexpr int kMaxCols = 4096;

struct Args {
  const void* x;
  long long x_pitch;  // elements between rows
  const void* shortcut;  // epilogue 1 only: the output's dtype
  long long shortcut_pitch;
  const void* w;
  const void* b;
  void* out;  // (rows, cols) of the output's dtype, out_pitch apart
  long long out_pitch;  // elements between output rows; columns cols .. out_pitch - 1 are written 0
  long long rows;
  int cols;
  int post;  // 0: vit.LayerNorm; 1: ResidualPostNorm (adds the shortcut)
  int w_bf16;
  int b_bf16;
  float eps;
};

// BYTES of consecutive memory as one load brings them: 32-bit words, the
// first element in the low bits.
template <int BYTES>
struct Words {
  static constexpr int N = BYTES >= 4 ? BYTES / 4 : 1;
  uint32_t w[N];
};

template <int BYTES>
__device__ __forceinline__ void load(Words<BYTES>& d, const void* p) {
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      d.w[4 * i] = u.x;
      d.w[4 * i + 1] = u.y;
      d.w[4 * i + 2] = u.z;
      d.w[4 * i + 3] = u.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    d.w[0] = u.x;
    d.w[1] = u.y;
  } else if constexpr (BYTES == 4) {
    d.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    d.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

template <int BYTES>
__device__ __forceinline__ void zero(Words<BYTES>& d) {
#pragma unroll
  for (int i = 0; i < Words<BYTES>::N; ++i) d.w[i] = 0u;
}

template <int BYTES>
__device__ __forceinline__ void store(void* p, const Words<BYTES>& d) {
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(d.w[4 * i], d.w[4 * i + 1], d.w[4 * i + 2], d.w[4 * i + 3]);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(d.w[0], d.w[1]);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<unsigned int*>(p) = d.w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)d.w[0];
  }
}

// element i of the chunk, as f32 (a bf16 is the upper half of its f32)
template <typename T, int BYTES>
__device__ __forceinline__ float get(const Words<BYTES>& d, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(d.w[i]);
  } else {
    const uint32_t word = d.w[i >> 1];
    return __uint_as_float((i & 1) ? (word & 0xffff0000u) : (word << 16));
  }
}

// E values rounded to T (to nearest even, as torch's casts on the card) and packed
template <typename T, int E>
__device__ __forceinline__ void pack(Words<E * (int)sizeof(T)>& d, const float (&v)[E]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < E; ++i) d.w[i] = __float_as_uint(v[i]);
  } else if constexpr (E == 1) {
    d.w[0] = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  } else {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      d.w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// E consecutive parameters from offset c, f32 or bf16 as stored (the base a
// multiple of 16 bytes, c a multiple of E)
template <int E>
__device__ __forceinline__ void load_params(float (&v)[E], const void* p, int bf16, int c) {
  if (bf16) {
    Words<E * 2> d;
    load(d, static_cast<const __nv_bfloat16*>(p) + c);
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = get<__nv_bfloat16>(d, i);
  } else {
    Words<E * 4> d;
    load(d, static_cast<const float*>(p) + c);
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = get<float>(d, i);
  }
}

// TX: x's type; TO: the output's (and the shortcut's); E values a chunk; T
// threads a row; K chunks a thread (C <= T * K * E); PAD: the output's rows
// lie out_pitch > C apart, zeros past C, epilogue 0 only (its own instance,
// so a launch at pitch C runs the unpadded body untouched, and one without
// the shortcut's code).
template <typename TX, typename TO, int E, int T, int K, bool PAD>
__global__ void __launch_bounds__(T > 32 ? T : kWarpBodyThreads)
layernorm_rows_kernel(const Args a) {
  constexpr int kBlock = T > 32 ? T : kWarpBodyThreads;
  constexpr int kLanes = T < 32 ? T : 32;  // lanes of one butterfly
  constexpr int XB = E * (int)sizeof(TX);
  constexpr int OB = E * (int)sizeof(TO);
  const int t = threadIdx.x % T;
  const long long row = (long long)blockIdx.x * (kBlock / T) + threadIdx.x / T;
  // a thread past the last row loads nothing and adds zeros: it stays for
  // the shuffles, which name the whole warp
  if constexpr (PAD) {
    // layernorm_launch refuses a shortcut at a wider pitch, so these
    // instances are compiled without epilogue 1 (fewer registers)
    if (a.post) return;
  }
  const bool live = row < a.rows;
  const int chunks = a.cols / E;
  const TX* xr = static_cast<const TX*>(a.x) + (live ? row : 0) * a.x_pitch;
  const TO* sr = a.post ? static_cast<const TO*>(a.shortcut) + (live ? row : 0) * a.shortcut_pitch : nullptr;

  Words<XB> xc[K];
  Words<OB> sc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t + T * k;
    if (live && j < chunks) {
      load(xc[k], xr + (long long)j * E);
    } else {
      zero(xc[k]);
    }
  }
  if (a.post) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = t + T * k;
      if (live && j < chunks) load(sc[k], sr + (long long)j * E);
    }
  }

  float s = 0.f, q = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float v = get<TX>(xc[k], i);
      s = __fadd_rn(s, v);
      q = __fadd_rn(q, __fmul_rn(v, v));
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {  // stays inside the row's lanes
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, o));
  }
  if constexpr (T > 32) {
    constexpr int kWarps = T / 32;
    __shared__ float part_s[kWarps], part_q[kWarps];
    if ((threadIdx.x & 31) == 0) {
      part_s[threadIdx.x >> 5] = s;
      part_q[threadIdx.x >> 5] = q;
    }
    __syncthreads();
    s = part_s[0];
    q = part_q[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s = __fadd_rn(s, part_s[w]);
      q = __fadd_rn(q, part_q[w]);
    }
  }

  const float inv_c = __frcp_rn((float)a.cols);
  const float mean = __fmul_rn(s, inv_c);
  float var = __fsub_rn(__fmul_rn(q, inv_c), __fmul_rn(mean, mean));
  if (!a.post && var < 0.f) var = 0.f;  // torch.clamp(min=0): a NaN stays NaN
  const float inv = xla_rsqrt(__fadd_rn(var, a.eps));

  TO* orow = static_cast<TO*>(a.out) + (live ? row : 0) * (PAD ? a.out_pitch : (long long)a.cols);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t + T * k;
    if (live && j < chunks) {
      float w[E], b[E], o[E];
      load_params(w, a.w, a.w_bf16, j * E);
      load_params(b, a.b, a.b_bf16, j * E);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float d = __fsub_rn(get<TX>(xc[k], i), mean);
        if (a.post) {
          const float y = __fadd_rn(__fmul_rn(__fmul_rn(d, inv), w[i]), b[i]);
          o[i] = __fadd_rn(get<TO>(sc[k], i), round_to<TO>(y));
        } else {
          o[i] = __fadd_rn(__fmul_rn(d, __fmul_rn(inv, w[i])), b[i]);
        }
      }
      Words<OB> out;
      pack<TO, E>(out, o);
      store(orow + (long long)j * E, out);
    }
  }
  if constexpr (PAD) {
    // a padded output row (EVA02's SwiGLU hidden at a 16-byte pitch): zeros
    // past the last column, so a product over the pitch adds nothing there
    const int out_chunks = (int)(a.out_pitch / E);
    if (live) {
      for (int j = chunks + t; j < out_chunks; j += T) {
        Words<OB> z;
        zero(z);
        store(orow + (long long)j * E, z);
      }
    }
  }
}

template <typename TX, typename TO, int E, int T, int K>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kBlock = T > 32 ? T : kWarpBodyThreads;
  constexpr int kRows = kBlock / T;
  const long long blocks = (a.rows + kRows - 1) / kRows;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (a.out_pitch == a.cols) {
    layernorm_rows_kernel<TX, TO, E, T, K, false><<<(unsigned)blocks, kBlock, 0, stream>>>(a);
  } else if constexpr (sizeof(TX) == sizeof(TO)) {
    layernorm_rows_kernel<TX, TO, E, T, K, true><<<(unsigned)blocks, kBlock, 0, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the bodies ops/layernorm.layout chooses: T 16 or 32 with K 1..8 up to 256
// chunks a row, T 128 with K 4, 8 or 12 up to 1536, T 256 with K 8 or 16
template <typename TX, typename TO, int E>
cudaError_t launch_body(const Args& a, int t, int k, cudaStream_t st) {
  if (t == 16 && k == 1) return launch<TX, TO, E, 16, 1>(a, st);
  if (t == 32 && k == 1) return launch<TX, TO, E, 32, 1>(a, st);
  if (t == 32 && k == 2) return launch<TX, TO, E, 32, 2>(a, st);
  if (t == 32 && k == 4) return launch<TX, TO, E, 32, 4>(a, st);
  if (t == 32 && k == 8) return launch<TX, TO, E, 32, 8>(a, st);
  if (t == 128 && k == 4) return launch<TX, TO, E, 128, 4>(a, st);
  if constexpr (E <= 4) {  // the bodies below hold more chunks than C <= 4096 makes for E = 8
    if (t == 128 && k == 8) return launch<TX, TO, E, 128, 8>(a, st);
  }
  if constexpr (E <= 2) {
    if (t == 128 && k == 12) return launch<TX, TO, E, 128, 12>(a, st);
    if (t == 256 && k == 8) return launch<TX, TO, E, 256, 8>(a, st);
  }
  if constexpr (E == 1) {
    if (t == 256 && k == 16) return launch<TX, TO, E, 256, 16>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename TX, typename TO>
cudaError_t launch_types(const Args& a, int e, int t, int k, cudaStream_t st) {
  if constexpr (sizeof(TX) == 2) {
    if (e == 8) return launch_body<TX, TO, 8>(a, t, k, st);
  }
  if (e == 4) return launch_body<TX, TO, 4>(a, t, k, st);
  if (e == 2) return launch_body<TX, TO, 2>(a, t, k, st);
  if (e == 1) return launch_body<TX, TO, 1>(a, t, k, st);
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, long long bytes) { return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0; }

}  // namespace

// x_code / out_code: 0 = float32, 1 = bfloat16 (x bf16 with an f32 output is
// refused); w_code, b_code likewise. shortcut: null for epilogue 0, else
// (rows, cols) rows of the output's dtype at shortcut_pitch. out: rows
// out_pitch elements apart, out_pitch == cols or a multiple of 16 bytes above
// it (the columns past cols written 0), the latter only without a shortcut
// and with x_code == out_code. The layout: e values a chunk, t threads a row,
// k chunks a thread; refused unless cols <= t * k * e, cols % e == 0, every
// row of x and of the shortcut starts at a multiple of a chunk's bytes, and
// w, b and out at multiples of 16 bytes. rsqrt_table: the host's 2048 rsqrt
// estimates (xla_rsqrt.cuh), copied to the device at its first launch there.
extern "C" int layernorm_launch(const void* x, long long x_pitch, const void* shortcut,
                                long long shortcut_pitch, const void* w, const void* b, void* out,
                                long long out_pitch, long long rows, int cols, int x_code, int out_code,
                                int w_code, int b_code, int e, int t, int k, float eps,
                                const void* rsqrt_table, void* stream) {
  if (rows <= 0 || cols <= 0 || cols > kMaxCols || e <= 0 || cols % e != 0 || (long long)t * k * e < cols)
    return (int)cudaErrorInvalidValue;
  const long long out_size = out_code ? 2 : 4;
  if (out_pitch < cols || out_pitch > INT_MAX) return (int)cudaErrorInvalidValue;
  if (out_pitch != cols && (shortcut != nullptr || x_code != out_code || out_pitch * out_size % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if ((x_code != 0 && x_code != 1) || (out_code != 0 && out_code != 1) || (x_code == 1 && out_code == 0))
    return (int)cudaErrorInvalidValue;
  if ((w_code != 0 && w_code != 1) || (b_code != 0 && b_code != 1)) return (int)cudaErrorInvalidValue;
  const long long xb = (long long)e * (x_code ? 2 : 4);
  const long long ob = (long long)e * (out_code ? 2 : 4);
  if (!aligned(x, xb) || (x_pitch * (x_code ? 2 : 4)) % xb != 0) return (int)cudaErrorInvalidValue;
  if (shortcut != nullptr && (!aligned(shortcut, ob) || (shortcut_pitch * (out_code ? 2 : 4)) % ob != 0))
    return (int)cudaErrorInvalidValue;
  if (!aligned(w, 16) || !aligned(b, 16) || !aligned(out, 16)) return (int)cudaErrorInvalidValue;
  const cudaError_t table_err = xla_rsqrt_ensure_table(rsqrt_table);
  if (table_err != cudaSuccess) return (int)table_err;
  const Args a{x, x_pitch, shortcut, shortcut_pitch, w, b, out, out_pitch, rows, cols,
               shortcut != nullptr ? 1 : 0, w_code, b_code, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_code == 0 && out_code == 0) return (int)launch_types<float, float>(a, e, t, k, st);
  if (x_code == 0) return (int)launch_types<float, __nv_bfloat16>(a, e, t, k, st);
  return (int)launch_types<__nv_bfloat16, __nv_bfloat16>(a, e, t, k, st);
}
