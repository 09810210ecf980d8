// Fused Stars window scoring for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/window_score.py::window_score
// (body _window_score_kernel): per window, L2-normalise the s leader and W
// member rows (x / sqrt(sum x^2 + 1e-12), a division as in the oracle, not
// an rsqrt multiply), take the s x W fp32 dot tile, write -inf outside
// leader_ok & member_ok, build the emit mask (self slot, upper triangle if
// allpairs, same bucket, new_from, refresh_below + keep, sims > r1) and
// count comparisons / emitted pairs per window.
//
// What bounds it on the H100: at the main path's shapes (s=25, W=250,
// d=128) a window reads 12.8 KB of leaders and 128 KB of members and
// writes 25 KB of sims and 6 KB of emit bytes, for 1.6 MFLOP: about 9
// FLOP per byte against the card's 20 (67 TFLOP/s fp32 over 3.35 TB/s),
// so device-memory bytes bound it.
//
// Design: one block per window, so each feature row is read from device
// memory once and the (s, W) results are written once, coalesced.  The
// similarity tiles are tiles.cuh's score_window (staged, normalised tiles
// in shared memory, 8 leader accumulators a thread, fp32 FMA).  The mask
// chain is built in registers and the two counters reduce through warp
// shuffles and one shared-memory atomic per warp.  The leader and member
// row gathers stay outside the kernel, as in the JAX package.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using tiles::kAcc;
using tiles::kThreads;

struct Params {
  const float* leaders;         // (nw, s, d)
  const float* members;         // (nw, w, d)
  const int32_t* leader_slot;   // (nw, s)
  const int32_t* lead_gid;      // (nw, s)
  const int32_t* gid;           // (nw, w)
  const uint8_t* leader_ok;     // (nw, s) bool
  const uint8_t* member_ok;     // (nw, w) bool
  const int32_t* lead_bucket;   // (nw, s) uint32 bit patterns
  const int32_t* bucket;        // (nw, w)
  const uint8_t* keep;          // (nw,) bool
  float* sims;                  // (nw, s, w)
  uint8_t* emit;                // (nw, s, w) bool
  int32_t* comparisons;         // (nw,)
  int32_t* emitted;             // (nw,)
  int s, w, d, stride;
  int normalized, allpairs, match_bucket, new_from, refresh_below, has_r1;
  float r1;
};

template <bool kChunked>
__global__ void __launch_bounds__(kThreads)
window_score_kernel(Params p) {
  extern __shared__ float4 smem4[];
  __shared__ int s_comp, s_emit;

  const int win = blockIdx.x;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_comp = 0;
    s_emit = 0;
  }
  const bool keep = p.refresh_below > 0 ? p.keep[win] != 0 : true;
  int my_comp = 0, my_emit = 0;

  tiles::score_window<kChunked>(
      p.leaders + static_cast<size_t>(win) * p.s * p.d,
      p.members + static_cast<size_t>(win) * p.w * p.d, p.s, p.w, p.d,
      p.stride, p.normalized, reinterpret_cast<float*>(smem4),
      [&](int m, int lb, int nl, const float (&acc)[kAcc]) {
        const size_t mi = static_cast<size_t>(win) * p.w + m;
        const bool mok = p.member_ok[mi] != 0;
        const int mgid = p.gid[mi];
        const int mbucket = p.bucket[mi];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int jl = tiles::tile_leader(i);
          if (jl >= nl) continue;
          const int j = lb + jl;
          const size_t li = static_cast<size_t>(win) * p.s + j;
          const bool mask0 = (p.leader_ok[li] != 0) && mok;
          const int lslot = p.leader_slot[li];
          bool mask = mask0 && lslot != m;
          if (p.allpairs) mask = mask && lslot < m;
          if (p.match_bucket) mask = mask && p.lead_bucket[li] == mbucket;
          if (p.new_from > 0) {
            const int lg = p.lead_gid[li];
            mask = mask && (lg >= p.new_from || mgid >= p.new_from);
          }
          if (p.refresh_below > 0) {
            const int lg = p.lead_gid[li];
            mask = mask && keep && lg < p.refresh_below
                   && mgid < p.refresh_below;
          }
          const bool emit = mask && (!p.has_r1 || acc[i] > p.r1);
          const size_t o = li * p.w + m;
          p.sims[o] = mask0 ? acc[i] : -INFINITY;
          p.emit[o] = emit;
          my_comp += mask;
          my_emit += emit;
        }
      });
  for (int o = 16; o > 0; o >>= 1) {
    my_comp += __shfl_xor_sync(0xffffffffu, my_comp, o);
    my_emit += __shfl_xor_sync(0xffffffffu, my_emit, o);
  }
  if (lane == 0) {
    atomicAdd(&s_comp, my_comp);
    atomicAdd(&s_emit, my_emit);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    p.comparisons[win] = s_comp;
    p.emitted[win] = s_emit;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int window_score_launch(
    const float* leaders, const float* members, const int32_t* leader_slot,
    const int32_t* lead_gid, const int32_t* gid, const uint8_t* leader_ok,
    const uint8_t* member_ok, const int32_t* lead_bucket,
    const int32_t* bucket, const uint8_t* keep, float* sims, uint8_t* emit,
    int32_t* comparisons, int32_t* emitted, int nw, int s, int w, int d,
    int normalized, int allpairs, int match_bucket, int new_from,
    int refresh_below, int has_r1, float r1, void* stream) {
  if (nw == 0) return 0;
  Params p{leaders, members, leader_slot, lead_gid, gid, leader_ok,
           member_ok, lead_bucket, bucket, keep, sims, emit, comparisons,
           emitted, s, w, d, tiles::row_stride(d), normalized,
           allpairs, match_bucket, new_from, refresh_below, has_r1, r1};
  const int smem = tiles::smem_bytes(d);
  auto kernel = d > tiles::kMaxChunk ? window_score_kernel<true>
                                     : window_score_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nw, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
