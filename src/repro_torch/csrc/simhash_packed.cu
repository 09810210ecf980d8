// SimHash sign bits packed 32 to a word, for Hopper (sm_90a), with the
// product on the fp64 tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/simhash.py::simhash_packed
// (body _simhash_kernel): bit j of word k of row i is
// sign(<x_i, proj[:, 32 k + j]>) > 0, little-endian within the word, for
// any (n, d, m) (the tail bits of the last word are zero, as pack_bits
// gives).  The products are summed in fp64: an fp32 x fp32 product is
// exact there, so only the order of the fp64 additions differs from the
// plain version's (core/lsh.simhash_bits, also fp64), and a sign can
// differ only where |sum| lies within about d * 2**-53 * sum |x_i p_i| of
// zero.
//
// What bounds it on the H100: operations.  At (n, d, m) = (2**20, 128, 64)
// it reads 0.54 GB (0.16 ms at 3.35 TB/s) but does 8.6 G fp64 FMAs (17.2
// GFLOP), 0.26 ms at the 67 TFLOP/s of fp64 on the tensor cores (DMMA,
// IEEE fp64 FMA).  The FMA units outside the tensor cores run fp64 at
// half that rate, so this design takes the product to DMMA:
// mma.sync.m16n8k16 with fp64 operands.
//
// Design: persistent blocks of 8 warps, one a SM (196 KB of shared
// memory).  A block owns one group of up to 64 columns (two words) and
// walks 128-row tiles of x, each read from device memory once.  The
// group's projection columns are converted to fp64 and staged in the
// order of the B fragments (two k values a 16-byte read), once per block
// when d fits one chunk of 128 (else once per chunk).  x goes fp32 into a
// ring of two stages by cp.async (16 bytes where d % 4 == 0, else 4),
// zero filled past d and n, so the next tile loads while this one is
// multiplied; an A fragment is converted to fp64 as it is read.  A warp
// owns 16 rows: per k block of 16 it reads 8 A values and 16 pairs of B
// values for 8 DMMAs into 8 accumulator tiles of 16 x 8.  In the C
// fragment lane l holds rows l / 4 and l / 4 + 8, columns 2 (l % 4) and
// 2 (l % 4) + 1, so a row's word is ORed from the four lanes of a quad
// by two shuffles.  Zero padding in d and in m is exact; a padded column
// sums to +-0 and gives bit 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 16;                  // one m16 tile a warp
constexpr int kK = 16;                         // depth of one DMMA
constexpr int kRows = kWarps * kWarpRows;      // 128 rows a tile
constexpr int kChunk = 128;                    // d staged per step
constexpr int kXStride = kChunk + 4;           // floats: A reads hit 32 banks
constexpr int kCols = 64;                      // columns of a group
constexpr int kNTiles = kCols / 8;             // 8 n-tiles of 8 columns
constexpr int kStages = 2;
constexpr int kSmemProj = kChunk * kNTiles * 8 * 8;        // 64 KB
constexpr int kSmemX = kRows * kXStride * 4;                // 66 KB a stage
constexpr int kSmem = kSmemProj + kStages * kSmemX;

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// c += a * b on one 16 x 8 x kK tile, fp64, A row-major, B column-major.
// Fragments (g = lane / 4, t = lane % 4): a[i] = A[g + 8 (i % 2)]
// [t + 4 (i / 2)], b[i] = B[t + 4 i][g]; c[0], c[1] = C[g][2 t], C[g][2 t
// + 1] and c[2], c[3] the same of row g + 8.
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[8],
                                     const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

struct Params {
  const float* x;           // (n, d)
  const float* proj;        // (d, m)
  uint32_t* out;            // (n, n_words)
  long long n;
  int d, m, n_words, n_groups, n_chunks, vec;
};

// Stage columns [64 g, 64 g + 64) x rows [k0, k0 + kChunk) of proj as
// fp64 B fragments: entry (kb, nt, j, lane) holds b[2 j] and b[2 j + 1]
// of n-tile nt at k block kb, for columns 64 g + 8 nt + lane / 4.
__device__ void stage_proj(double2* s_p, const Params& p, int g, int k0) {
  constexpr int kPairs = kK / 8;
  for (int e = threadIdx.x; e < kChunk * kNTiles * 4; e += kThreads) {
    const int lane = e & 31, f = e >> 5;
    const int j = f % kPairs, nt = f / kPairs % kNTiles,
              kb = f / kPairs / kNTiles;
    const int k = k0 + kb * kK + (lane & 3) + 8 * j;
    const int c = g * kCols + 8 * nt + (lane >> 2);
    const bool ok = c < p.m;
    s_p[e] = make_double2(
        ok && k < p.d ? static_cast<double>(p.proj[size_t(k) * p.m + c]) : 0.0,
        ok && k + 4 < p.d
            ? static_cast<double>(p.proj[size_t(k + 4) * p.m + c]) : 0.0);
  }
}

// Start copying rows [r0, r0 + kRows) x columns [k0, k0 + kChunk) of x
// into a stage, zero filled past n and d.
__device__ void issue_x(float* s_x, const Params& p, long long r0, int k0) {
  if (p.vec) {
    for (int e = threadIdx.x; e < kRows * kChunk / 4; e += kThreads) {
      const int r = e >> 5, c = 4 * (e & 31);
      const bool ok = r0 + r < p.n && k0 + c < p.d;
      cp_async(s_x + r * kXStride + c,
               ok ? p.x + (r0 + r) * p.d + k0 + c : p.x, true, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
      const int r = e >> 7, c = e & (kChunk - 1);
      const bool ok = r0 + r < p.n && k0 + c < p.d;
      cp_async(s_x + r * kXStride + c,
               ok ? p.x + (r0 + r) * p.d + k0 + c : p.x, false, ok);
    }
  }
}

// Items (row tile, chunk), chunk minor; block b serves column group
// b % n_groups and row tiles b / n_groups, + grid / n_groups, ...
__global__ void __launch_bounds__(kThreads, 1)
simhash_packed_kernel(Params p) {
  extern __shared__ double2 smem2[];
  double2* s_p = smem2;
  float* s_x = reinterpret_cast<float*>(smem2 + kSmemProj / 16);
  const int g = static_cast<int>(blockIdx.x % p.n_groups);
  const long long first = blockIdx.x / p.n_groups;
  const long long step = gridDim.x / p.n_groups;
  const long long n_tiles = (p.n + kRows - 1) / kRows;
  const long long tiles = first < n_tiles
      ? (n_tiles - first + step - 1) / step : 0;
  const long long items = tiles * p.n_chunks;

  auto issue = [&](long long it) {
    if (it < items) {
      const long long tile = first + it / p.n_chunks * step;
      const int chunk = static_cast<int>(it % p.n_chunks);
      issue_x(s_x + static_cast<int>(it % kStages) * (kSmemX / 4), p,
              tile * kRows, chunk * kChunk);
    }
    cp_async_commit();
  };
  if (p.n_chunks == 1) stage_proj(s_p, p, g, 0);
  issue(0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double acc[kNTiles][4];
  for (long long it = 0; it < items; ++it) {
    issue(it + 1);
    cp_async_wait<1>();
    const int chunk = static_cast<int>(it % p.n_chunks);
    if (p.n_chunks > 1) stage_proj(s_p, p, g, chunk * kChunk);
    __syncthreads();                    // item it's x and proj are staged

    if (chunk == 0) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0;
    }
    const float* xa = s_x + static_cast<int>(it % kStages) * (kSmemX / 4)
        + (warp * kWarpRows + (lane >> 2)) * kXStride + (lane & 3);
    const int k_blocks = (min(kChunk, p.d - chunk * kChunk) + kK - 1) / kK;
    for (int kb = 0; kb < k_blocks; ++kb) {
      double a[kK / 2];
#pragma unroll
      for (int i = 0; i < kK / 2; ++i)
        a[i] = static_cast<double>(
            xa[(i % 2) * 8 * kXStride + kb * kK + 4 * (i / 2)]);
      const double2* b = s_p + kb * kNTiles * (kK / 8) * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        double bv[kK / 4];
#pragma unroll
        for (int j = 0; j < kK / 8; ++j) {
          const double2 v = b[(nt * (kK / 8) + j) * 32];
          bv[2 * j] = v.x;
          bv[2 * j + 1] = v.y;
        }
        dmma(acc[nt], a, bv);
      }
    }

    if (chunk == p.n_chunks - 1) {
      const long long tile = first + it / p.n_chunks * step;
      const int q = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {      // rows g and g + 8 of the tile
        const long long row = tile * kRows + warp * kWarpRows + 8 * h
            + (lane >> 2);
#pragma unroll
        for (int wi = 0; wi < kCols / 32; ++wi) {
          uint32_t bits = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const double* c = acc[4 * wi + j] + 2 * h;
            bits |= (c[0] > 0.0 ? 1u : 0u) << (8 * j + 2 * q);
            bits |= (c[1] > 0.0 ? 1u : 0u) << (8 * j + 2 * q + 1);
          }
          bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
          bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
          const int word = g * (kCols / 32) + wi;
          if (q == wi && row < p.n && word < p.n_words)
            p.out[row * p.n_words + word] = bits;
        }
      }
    }
    __syncthreads();                    // stage (and proj) consumed
  }
  cp_async_wait<0>();
}

}  // namespace

// Launch on `stream`; out is (n, ceil(m / 32)) words.  Returns
// cudaGetLastError() (0 on success).
extern "C" int simhash_packed_launch(const float* x, const float* proj,
                                     uint32_t* out, long long n, int d, int m,
                                     void* stream) {
  if (n == 0 || m == 0) return 0;
  const int n_words = (m + 31) / 32;
  Params p{x, proj, out, n, d, m, n_words, (m + kCols - 1) / kCols,
           d > 0 ? (d + kChunk - 1) / kChunk : 1,
           d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0};
  cudaError_t err = cudaFuncSetAttribute(
      simhash_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(
              &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  // one block a SM, in whole sets of column groups, no more than the work
  const long long n_tiles = (n + kRows - 1) / kRows;
  long long per_group = sms / p.n_groups > 0 ? sms / p.n_groups : 1;
  if (per_group > n_tiles) per_group = n_tiles;
  simhash_packed_kernel<<<static_cast<unsigned>(per_group * p.n_groups),
                          kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
