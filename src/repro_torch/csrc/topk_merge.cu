// Per-node top-k degree-slab merge for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_merge.py::topk_merge
// (body _topk_merge_kernel).  Per row: join the k slab entries and the kin
// incoming entries, drop repeated neighbours keeping the heaviest instance
// (the earlier position on an exact tie), rank the survivors by (weight
// desc, nbr asc) and write the top k, with a -1 / -inf tail.  It computes
// kernels/ref.py::topk_merge_ref exactly and assumes nothing of the caller:
// rows need not be sorted or deduplicated.
//
// What bounds it on the H100: a row reads (k + kin) 8-byte entries and
// writes k, so the main path's merge (n = 2**20, k = kin = 250) moves 6.3
// GB, 1.9 ms at 3.35 TB/s; its comparisons are few next to that, so bytes
// bound the function.  This first version does not reach that bound: its
// two shared-memory bitonic sorts of K = next_pow2(k + kin) 64-bit keys
// (512 at the main path) take 2 * log2(K) * (log2(K) + 1) / 2 stages with
// a block barrier each, so it is bound by those barriers and shared-memory
// traffic.  The TPU kernel's K x K comparison matrices are not carried
// over: at K = 500 and a million rows they are 2.5e11 compares per call.
//
// Design: one block per row.  Entries are keyed in shared memory as
// (nbr << 32 | order-preserving weight bits) plus their position, which
// makes every key distinct, so the sort order is total and exact.  Pass 1
// sorts by (nbr asc, -w asc, position) and keeps the first instance of
// each neighbour; pass 2 re-keys the survivors as (-w, nbr) and sorts
// again; the first k are written back, their weights read from the input
// by position so that every bit is the input's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kBig = 0x7FFFFFFFu;   // empty-slot neighbour key

// Orders like the float values, as lax.sort compares them: -0.0 equals
// 0.0 and NaN sorts after +inf.
__device__ __forceinline__ uint32_t f32_key(float x) {
  if (x == 0.f) x = 0.f;
  uint32_t b = __float_as_uint(x);
  if (isnan(x)) b = 0x7FC00000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ void bitonic_sort(uint64_t* key, uint16_t* pos, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const uint64_t a = key[lo], b = key[hi];
        const uint16_t pa = pos[lo], pb = pos[hi];
        const bool a_after_b = a > b || (a == b && pa > pb);
        if (a_after_b == up) {
          key[lo] = b;
          key[hi] = a;
          pos[lo] = pb;
          pos[hi] = pa;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const int32_t* __restrict__ slab_nbr,
                  const float* __restrict__ slab_w,
                  const int32_t* __restrict__ inc_nbr,
                  const float* __restrict__ inc_w, int32_t* out_nbr,
                  float* out_w, int k, int kin, int P) {
  extern __shared__ uint64_t s_key[];
  uint16_t* s_pos = reinterpret_cast<uint16_t*>(s_key + P);
  const size_t row = blockIdx.x;
  const int K = k + kin;
  const uint32_t inf_key = f32_key(INFINITY);
  auto weight = [&](int i) {
    return i < k ? slab_w[row * k + i] : inc_w[row * kin + (i - k)];
  };

  for (int i = threadIdx.x; i < P; i += kThreads) {
    uint32_t nk = kBig, wk = inf_key;
    if (i < K) {
      const int nb = i < k ? slab_nbr[row * k + i]
                           : inc_nbr[row * kin + (i - k)];
      if (nb >= 0) {
        nk = static_cast<uint32_t>(nb);
        wk = f32_key(-weight(i));
      }
    }
    s_key[i] = (static_cast<uint64_t>(nk) << 32) | wk;
    s_pos[i] = static_cast<uint16_t>(i);
  }
  __syncthreads();
  bitonic_sort(s_key, s_pos, P);

  // keep the first (heaviest) instance of each neighbour; re-key as
  // (-w, nbr) so that survivors rank by weight desc, nbr asc
  constexpr int kPer = 16;            // P <= kThreads * kPer
  uint64_t rekey[kPer];
  for (int r = 0, i = threadIdx.x; i < P; ++r, i += kThreads) {
    const uint32_t nk = static_cast<uint32_t>(s_key[i] >> 32);
    const bool first = i == 0
        || nk != static_cast<uint32_t>(s_key[i - 1] >> 32);
    rekey[r] = first && nk != kBig
        ? (static_cast<uint64_t>(static_cast<uint32_t>(s_key[i])) << 32) | nk
        : (static_cast<uint64_t>(inf_key) << 32) | kBig;
  }
  __syncthreads();
  for (int r = 0, i = threadIdx.x; i < P; ++r, i += kThreads)
    s_key[i] = rekey[r];
  __syncthreads();
  bitonic_sort(s_key, s_pos, P);

  for (int i = threadIdx.x; i < k; i += kThreads) {
    const uint32_t wk = static_cast<uint32_t>(s_key[i] >> 32);
    const bool valid = wk != inf_key;
    out_nbr[row * k + i] = valid
        ? static_cast<int32_t>(static_cast<uint32_t>(s_key[i])) : -1;
    out_w[row * k + i] = valid ? weight(s_pos[i]) : -INFINITY;
  }
}

}  // namespace

// Largest k + kin one block merges (positions are 16-bit, and the keys of
// a row fit the 48 KB of static shared memory).
extern "C" int topk_merge_max_entries() { return kThreads * 16; }

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int topk_merge_launch(const int32_t* slab_nbr, const float* slab_w,
                                 const int32_t* inc_nbr, const float* inc_w,
                                 int32_t* out_nbr, float* out_w, int n, int k,
                                 int kin, void* stream) {
  if (n == 0) return 0;
  int P = 2;
  while (P < k + kin) P <<= 1;
  if (P > topk_merge_max_entries()) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(P) * (sizeof(uint64_t) + sizeof(uint16_t));
  topk_merge_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      slab_nbr, slab_w, inc_nbr, inc_w, out_nbr, out_w, k, kin, P);
  return static_cast<int>(cudaGetLastError());
}
