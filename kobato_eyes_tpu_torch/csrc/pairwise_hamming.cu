// All-pairs Hamming distances: out[i, j] = popcount(a[i] ^ b[j]).
//
// Replaces the JAX package's tiled Hamming Pallas kernel
// (kobato_eyes_tpu/ops/pallas_hamming.py: _hamming_tile_kernel via
// _pairwise_kernel / pairwise_hamming). The TPU program pads both sides to
// 256 and streams (256, 256) tiles through VMEM with a SWAR popcount over
// two uint32 lanes per hash. Here each 64-bit hash is read as one int64 (the
// uint64 bits) and the distance is __popcll(a ^ b).
//
// Bound on the card: bytes, and almost all of them stores. The call reads
// (Na + Nb) * 8 bytes and writes Na * Nb * 4: at the cluster audit's
// 4096 x 4096 batch that is 67.1 MB out against 66 KB in, 0.0200 ms at
// 3.35 TB/s; the XOR and popcount are a few integer operations per 4 bytes
// written. So the design is about the stores:
//   * a block owns kCols = 4 * 256 consecutive columns and kRows rows;
//     thread t owns columns t, t + 256, t + 512 and t + 768 of each row, so
//     each of its four stores is part of a warp's 128 consecutive bytes;
//   * each thread keeps its four b[j] in registers and the block stages its
//     kRows a[i] in shared memory, then walks the rows. The ragged edge is
//     masked here, with no padding of the inputs.
// (An int4-store variant, thread t owning columns 4t .. 4t+3 where
// Nb % 4 == 0, measured slower on an H100: 0.053 ms at 4096 x 4096 against
// 0.037 ms for this layout at 4095 x 4095.)
// Rows beyond 65535 blocks of kRows are taken by a grid-stride loop.
//
// Plain C entry for ctypes: returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                     // columns per thread
constexpr int kCols = kThreads * kVec;      // columns per block
constexpr int kRows = 16;                   // rows per block
constexpr long long kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
pairwise_hamming_kernel(const long long* __restrict__ a, const long long* __restrict__ b,
                        int* __restrict__ out, long long na, long long nb) {
  __shared__ unsigned long long a_tile[kRows];
  // column of this thread's v-th distance: j0 + v * kThreads
  const long long j0 = (long long)blockIdx.x * kCols + threadIdx.x;

  unsigned long long bj[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const long long j = j0 + v * kThreads;
    bj[v] = j < nb ? (unsigned long long)b[j] : 0ull;
  }

  for (long long row0 = (long long)blockIdx.y * kRows; row0 < na;
       row0 += (long long)gridDim.y * kRows) {
    __syncthreads();  // the previous pass is done reading a_tile
    if (threadIdx.x < kRows) {
      const long long i = row0 + threadIdx.x;
      a_tile[threadIdx.x] = i < na ? (unsigned long long)a[i] : 0ull;
    }
    __syncthreads();
    if (j0 >= nb) continue;  // no columns for this thread; stay for the barriers
    const int rows = (int)(na - row0 < kRows ? na - row0 : kRows);
    for (int r = 0; r < rows; ++r) {
      const unsigned long long ai = a_tile[r];
      int* dst = out + (row0 + r) * nb + j0;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        if (j0 + v * kThreads < nb) dst[v * kThreads] = __popcll(ai ^ bj[v]);
      }
    }
  }
}

}  // namespace

// a: (na,) int64, b: (nb,) int64, out: (na, nb) int32, all contiguous on the
// device.
extern "C" int pairwise_hamming_launch(const void* a, const void* b, void* out, long long na,
                                       long long nb, void* stream) {
  if (na <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks_x = (nb + kCols - 1) / kCols;
  if (blocks_x > INT_MAX) return (int)cudaErrorInvalidValue;
  long long blocks_y = (na + kRows - 1) / kRows;
  if (blocks_y > kMaxGridY) blocks_y = kMaxGridY;
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  pairwise_hamming_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(a), static_cast<const long long*>(b), static_cast<int*>(out),
      na, nb);
  return (int)cudaGetLastError();
}
