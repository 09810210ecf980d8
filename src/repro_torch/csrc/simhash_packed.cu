// SimHash sign bits packed 32 to a word, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/simhash.py::simhash_packed
// (body _simhash_kernel): bit j of word k of row i is
// sign(<x_i, proj[:, 32 k + j]>) > 0, little-endian within the word, for
// any m (the tail bits of the last word are zero, as pack_bits gives).
// The products are summed in fp64: an fp32 x fp32 product is exact there,
// so the sign agrees with the plain version (core/lsh.simhash_bits, also
// fp64) whatever order either sums in, and CUDA and CPU builds sketch
// alike.
//
// What bounds it on the H100: operations.  At (n, d, m) = (2**20, 128, 64)
// it reads 0.54 GB (0.16 ms at 3.35 TB/s) but does 17.2 GFLOP of fp64
// FMA, about 0.26 ms at the card's 67 TFLOP/s for fp64 on the tensor
// cores (DMMA, IEEE fp64 FMA).  This design runs on the fp64 units outside
// the tensor cores (34 TFLOP/s), so it leaves the tensor-core fp64 rate
// unused and cannot come nearer than twice that bound.
//
// Design: a block of 8 warps owns 64 rows and one 32-bit word; lane j of
// every warp computes column 32 k + j for 8 rows, so the warp's
// __ballot_sync of the 32 signs is the packed word.  The rows' x values
// and the word's 32 projection columns are staged in shared memory as
// fp64, in chunks of 32 along d (zero padded); x is read as double2 along
// d, a broadcast to the whole warp, and each projection value feeds 8
// accumulators.  Consecutive blocks take the words of one row tile, so a
// row tile is read from device memory once and then from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;     // 64 rows per block
constexpr int kChunk = 32;                       // d staged per step

__global__ void __launch_bounds__(kThreads)
simhash_packed_kernel(const float* __restrict__ x,
                      const float* __restrict__ proj,
                      uint32_t* __restrict__ out, long long n, int d, int m,
                      int n_words) {
  __shared__ double2 s_x[kRows][kChunk / 2];
  __shared__ double s_p[kChunk][32];

  const int word = static_cast<int>(blockIdx.x % n_words);
  const long long row0 = static_cast<long long>(blockIdx.x / n_words) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = word * 32 + lane;
  double* s_xd = reinterpret_cast<double*>(s_x);

  double acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.0;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    __syncthreads();                    // previous chunk fully consumed
    for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i - r * kChunk;
      const long long row = row0 + r;
      s_xd[i] = row < n && k0 + c < d
          ? static_cast<double>(x[row * d + k0 + c]) : 0.0;
    }
    for (int i = threadIdx.x; i < kChunk * 32; i += kThreads) {
      const int k = i / 32, j = i - k * 32;
      const int pc = word * 32 + j;
      s_p[k][j] = k0 + k < d && pc < m
          ? static_cast<double>(proj[static_cast<size_t>(k0 + k) * m + pc])
          : 0.0;
    }
    __syncthreads();
#pragma unroll 4
    for (int k2 = 0; k2 < kChunk / 2; ++k2) {
      const double p0 = s_p[2 * k2][lane], p1 = s_p[2 * k2 + 1][lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const double2 xv = s_x[warp * kRowsPerWarp + r][k2];
        acc[r] = fma(xv.x, p0, acc[r]);
        acc[r] = fma(xv.y, p1, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const uint32_t bits = __ballot_sync(0xffffffffu, col < m && acc[r] > 0.0);
    const long long row = row0 + warp * kRowsPerWarp + r;
    if (lane == 0 && row < n) out[row * n_words + word] = bits;
  }
}

}  // namespace

// Launch on `stream`; out is (n, ceil(m / 32)) words.  Returns
// cudaGetLastError() (0 on success).
extern "C" int simhash_packed_launch(const float* x, const float* proj,
                                     uint32_t* out, long long n, int d, int m,
                                     void* stream) {
  if (n == 0 || m == 0) return 0;
  const int n_words = (m + 31) / 32;
  const long long blocks = (n + kRows - 1) / kRows * n_words;
  simhash_packed_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, proj, out, n, d, m, n_words);
  return static_cast<int>(cudaGetLastError());
}
