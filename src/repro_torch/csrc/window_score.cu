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
// memory once and the (s, W) results are written once, coalesced.  Leader
// tiles of up to 32 rows and member tiles of 64 rows are staged, zero
// padded and normalised in shared memory (the row stride is an odd number
// of float4s, so the float4 reads below are free of bank conflicts).  Each
// warp owns 32 members and one of four leader groups; a thread keeps up
// to 8 leader accumulators in registers, so one float4 member read feeds
// up to 32 FMAs.  Products are plain fp32 FMA (no TF32), which keeps the
// similarities within an ulp or two of the oracle's.  The mask chain is
// built in registers and the two counters reduce through warp shuffles
// and one shared-memory atomic per warp.  The leader and member row
// gathers stay outside the kernel, as in the JAX package.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLeaderTile = 32;
constexpr int kMemberTile = 64;
constexpr int kLeaderGroups = kThreads / kMemberTile;    // 4
constexpr int kAcc = kLeaderTile / kLeaderGroups;        // 8

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

// Copy `rows` rows of width d into shared memory with row stride `stride`
// (zero padded past d) and, if asked, divide each row by its L2 norm.
__device__ void stage_rows(float* dst, const float* src, int rows, int d,
                           int stride, bool normalized) {
  __syncthreads();                      // previous tile fully consumed
  for (int i = threadIdx.x; i < rows * stride; i += kThreads) {
    int r = i / stride;
    int c = i - r * stride;
    dst[i] = c < d ? src[static_cast<size_t>(r) * d + c] : 0.f;
  }
  __syncthreads();
  if (normalized) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* row = dst + r * stride;
      float ss = 0.f;
      for (int c = lane; c < d; c += 32) ss = fmaf(row[c], row[c], ss);
      for (int o = 16; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float nrm = sqrtf(ss + 1e-12f);
      for (int c = lane; c < d; c += 32) row[c] = row[c] / nrm;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
window_score_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* s_lead = reinterpret_cast<float*>(smem4);
  float* s_memb = s_lead + kLeaderTile * p.stride;
  __shared__ int s_comp, s_emit;

  const int win = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mm = (warp & 1) * 32 + lane;     // member within the tile
  const int grp = warp >> 1;                 // leader group
  const int q = (p.d + 3) / 4;               // float4s covering a row
  if (threadIdx.x == 0) {
    s_comp = 0;
    s_emit = 0;
  }
  const bool keep = p.refresh_below > 0 ? p.keep[win] != 0 : true;
  const float* lead = p.leaders + static_cast<size_t>(win) * p.s * p.d;
  const float* memb = p.members + static_cast<size_t>(win) * p.w * p.d;
  int my_comp = 0, my_emit = 0;

  for (int lb = 0; lb < p.s; lb += kLeaderTile) {
    const int nl = min(kLeaderTile, p.s - lb);
    stage_rows(s_lead, lead + static_cast<size_t>(lb) * p.d, nl, p.d,
               p.stride, p.normalized);
    for (int mb = 0; mb < p.w; mb += kMemberTile) {
      const int nm = min(kMemberTile, p.w - mb);
      stage_rows(s_memb, memb + static_cast<size_t>(mb) * p.d, nm, p.d,
                 p.stride, p.normalized);
      if (mm >= nm) continue;
      float acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      const float4* mrow = reinterpret_cast<const float4*>(
          s_memb + mm * p.stride);
      for (int k4 = 0; k4 < q; ++k4) {
        const float4 mv = mrow[k4];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int jl = grp + kLeaderGroups * i;
          if (jl < nl) {               // uniform across the warp
            const float4 lv = reinterpret_cast<const float4*>(
                s_lead + jl * p.stride)[k4];
            acc[i] = fmaf(lv.x, mv.x, acc[i]);
            acc[i] = fmaf(lv.y, mv.y, acc[i]);
            acc[i] = fmaf(lv.z, mv.z, acc[i]);
            acc[i] = fmaf(lv.w, mv.w, acc[i]);
          }
        }
      }
      const int m = mb + mm;
      const size_t mi = static_cast<size_t>(win) * p.w + m;
      const bool mok = p.member_ok[mi] != 0;
      const int mgid = p.gid[mi];
      const int mbucket = p.bucket[mi];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int jl = grp + kLeaderGroups * i;
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
    }
  }
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

// Row stride (floats) of a staged tile: an odd number of float4s >= d.
extern "C" int window_score_row_stride(int d) {
  const int q = (d + 3) / 4;
  return 4 * (q % 2 ? q : q + 1);
}

extern "C" int window_score_smem_bytes(int d) {
  return (kLeaderTile + kMemberTile) * window_score_row_stride(d)
         * static_cast<int>(sizeof(float));
}

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
           emitted, s, w, d, window_score_row_stride(d), normalized,
           allpairs, match_bucket, new_from, refresh_below, has_r1, r1};
  const int smem = window_score_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      window_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_score_kernel<<<nw, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
