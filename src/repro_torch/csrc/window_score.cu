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
// Two designs; kernels/window_score.py::_design picks one from the shape
// alone and passes it to the launcher:
//
//   * pipe (s * W >= 256, d % 4 == 0, d <= 512; the main path's 25 x 250
//     at d = 128): pipe.cuh's staging, shared with leader_score.cu
//     (persistent blocks walking (window, 32-leader tile, 128-member tile)
//     items, 64-member tiles past d = 128; TMA into a ring of two stages;
//     four normalising warps beside eight scoring warps; d summed in two
//     halves).  The normalising warps also stage each item's mask inputs
//     (ok bytes, slots, gids, buckets of its rows) into a ring of three
//     slots in shared memory, so the scoring warps' epilogue runs the
//     mask chain without waiting on device memory.  A window's items may
//     fall to several blocks, so its two counters are zeroed before the
//     launch and each scoring warp adds its item's counts, reduced over
//     the warp, with one atomic each.
//   * tile (the other shapes: d not a multiple of 4, d > 512 as the LM
//     path's d = 1,152, or s * W < 256): one block per window, so each
//     feature row is read from device memory once and the (s, W) results
//     are written once, coalesced.  The similarity tiles are tiles.cuh's
//     score_window (staged, normalised tiles in shared memory, 8 leader
//     accumulators a thread, fp32 FMA); the mask chain is built in
//     registers and the counters reduce through warp shuffles and one
//     shared-memory atomic a warp.
//
// Both run the mask chain in the same order.  The pipe design's
// similarities follow pipe.cuh's order of operations (modelled on the CPU
// by tests/test_torch_window_pipe.py), so they may differ from the tile
// design's by an ulp or two; an emit decision can flip only for a
// similarity that close to r1.  The leader and member row gathers stay
// outside the kernel, as in the JAX package.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pipe.cuh"
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

// The pipe design's epilogue.  Each item's mask inputs are fetched by the
// normalising threads (a member and a leader row a thread) one item
// ahead, into registers, and staged into slot u % kSlots of shared
// memory; with kSlots = NS + 1 a slot is written again only after every
// scoring warp has finished the item that used it (pipe.cuh, run()).
template <int NS, int kB>
struct WindowEpilogue {
  static constexpr int kSlots = NS + 1;
  static constexpr int kMembers = 32 * kB;
  struct Meta {
    int32_t m_gid[kSlots][kMembers], m_bucket[kSlots][kMembers];
    int32_t l_slot[kSlots][pipe::kLeaders], l_gid[kSlots][pipe::kLeaders];
    int32_t l_bucket[kSlots][pipe::kLeaders];
    uint8_t m_ok[kSlots][kMembers], l_ok[kSlots][pipe::kLeaders];
  };

  const Params& p;
  Meta& meta;
  bool keep;
  int comp, emitted;
  // a normalising thread's fetch: its member row's and leader row's inputs
  int32_t mgid, mbucket, lslot, lgid, lbucket;
  uint8_t mok, lok;
  // a scoring warp's: its members' and leaders' inputs, its leaders' rows
  int32_t w_gid[kB], w_bucket[kB], v_slot[pipe::kStore], v_gid[pipe::kStore];
  int32_t v_bucket[pipe::kStore];
  uint8_t w_ok[kB], v_ok[pipe::kStore];
  float* s_out[pipe::kStore];            // leader i's outputs at member lane
  uint8_t* e_out[pipe::kStore];

  __device__ __forceinline__ void load(const pipe::Item& it, int tid) {
    if (tid < it.nm) {
      const size_t mi = it.win * p.w + it.m0 + tid;
      mok = p.member_ok[mi];
      mgid = p.gid[mi];
      mbucket = p.bucket[mi];
    }
    if (tid < it.nl) {
      const size_t li = it.win * p.s + it.l0 + tid;
      lok = p.leader_ok[li];
      lslot = p.leader_slot[li];
      lgid = p.lead_gid[li];
      lbucket = p.lead_bucket[li];
    }
  }

  __device__ __forceinline__ void stage(const pipe::Item& it, int tid) {
    const int slot = static_cast<int>(it.u % kSlots);
    if (tid < it.nm) {
      meta.m_ok[slot][tid] = mok;
      meta.m_gid[slot][tid] = mgid;
      meta.m_bucket[slot][tid] = mbucket;
    }
    if (tid < it.nl) {
      meta.l_ok[slot][tid] = lok;
      meta.l_slot[slot][tid] = lslot;
      meta.l_gid[slot][tid] = lgid;
      meta.l_bucket[slot][tid] = lbucket;
    }
  }

  __device__ __forceinline__ void prefetch(const pipe::Item& it, int, int) {
    keep = p.refresh_below > 0 ? p.keep[it.win] != 0 : true;
    comp = 0;
    emitted = 0;
  }

  // the mask inputs of the warp's members (lane + 32 b) and leaders
  // (8 g + 4 h + i), and where its lane's outputs go, into registers
  __device__ __forceinline__ void begin(const pipe::Item& it, int g, int h) {
    const int slot = static_cast<int>(it.u % kSlots);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int jm = lane + 32 * b;
      w_ok[b] = meta.m_ok[slot][jm];
      w_gid[b] = meta.m_gid[slot][jm];
      w_bucket[b] = meta.m_bucket[slot][jm];
    }
#pragma unroll
    for (int i = 0; i < pipe::kStore; ++i) {
      const int jl = pipe::kA * g + pipe::kStore * h + i;
      v_ok[i] = meta.l_ok[slot][jl];
      v_slot[i] = meta.l_slot[slot][jl];
      v_gid[i] = meta.l_gid[slot][jl];
      v_bucket[i] = meta.l_bucket[slot][jl];
      const long long row = (it.win * p.s + it.l0 + jl) * p.w + it.m0 + lane;
      s_out[i] = p.sims + row;
      e_out[i] = p.emit + row;
    }
  }

  // window_score_kernel's mask chain, in its order
  __device__ __forceinline__ void put(const pipe::Item& it, int i, int,
                                      int b, int jm, float v) {
    // (branch-free: the flags are the launch's, the inputs in registers)
    const int m = it.m0 + jm;
    const bool mask0 = (v_ok[i] & w_ok[b]) != 0;
    bool mask = mask0 & (v_slot[i] != m);
    mask &= !p.allpairs | (v_slot[i] < m);
    mask &= !p.match_bucket | (v_bucket[i] == w_bucket[b]);
    mask &= (p.new_from <= 0) | (v_gid[i] >= p.new_from)
            | (w_gid[b] >= p.new_from);
    mask &= (p.refresh_below <= 0)
            | (keep & (v_gid[i] < p.refresh_below)
               & (w_gid[b] < p.refresh_below));
    const bool emit = mask & (!p.has_r1 | (v > p.r1));
    s_out[i][32 * b] = mask0 ? v : -INFINITY;
    e_out[i][32 * b] = emit;
    comp += mask;
    emitted += emit;
  }

  __device__ __forceinline__ void finish(const pipe::Item& it) {
    const int c = __reduce_add_sync(0xffffffffu, comp);
    const int e = __reduce_add_sync(0xffffffffu, emitted);
    if ((threadIdx.x & 31) == 0) {
      if (c) atomicAdd(&p.comparisons[it.win], c);
      if (e) atomicAdd(&p.emitted[it.win], e);
    }
  }
};

template <int NS, int kB>
__global__ void __launch_bounds__(pipe::kThreads + pipe::kNorm, 1)
window_score_pipe_kernel(const __grid_constant__ CUtensorMap tm_lead,
                         const __grid_constant__ CUtensorMap tm_memb,
                         long long total, int n_lt, int n_mt, Params p) {
  __shared__ typename WindowEpilogue<NS, kB>::Meta meta;
  const pipe::Geom g{p.leaders, p.members, p.s, p.w, p.d, p.normalized};
  WindowEpilogue<NS, kB> epi{p, meta, true, 0, 0};
  pipe::run<NS, kB>(&tm_lead, &tm_memb, g, total, n_lt, n_mt, epi);
}

// Whether the pipe design's NS stages of 32 kB-member items fit a block
// at row width d, beside the epilogue's static slots.
template <int NS, int kB>
bool pipe_fits(int d) {
  return pipe::smem_bytes(d, NS, kB)
      + static_cast<int>(sizeof(typename WindowEpilogue<NS, kB>::Meta))
      <= pipe::kMaxSmem;
}

template <int NS, int kB>
int launch_pipe(const Params& p, long long nw, cudaStream_t st) {
  const pipe::Geom g{p.leaders, p.members, p.s, p.w, p.d, p.normalized};
  return pipe::launch<NS, kB>(window_score_pipe_kernel<NS, kB>, g, nw, st,
                              p);
}

}  // namespace

// Designs, as kernels/window_score.py numbers them.
enum Design { kTile = 1, kPipe = 2 };

// Launch `design` on `stream`; returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a design or width the kernel does not take.
extern "C" int window_score_launch(
    const float* leaders, const float* members, const int32_t* leader_slot,
    const int32_t* lead_gid, const int32_t* gid, const uint8_t* leader_ok,
    const uint8_t* member_ok, const int32_t* lead_bucket,
    const int32_t* bucket, const uint8_t* keep, float* sims, uint8_t* emit,
    int32_t* comparisons, int32_t* emitted, int nw, int s, int w, int d,
    int normalized, int allpairs, int match_bucket, int new_from,
    int refresh_below, int has_r1, float r1, int design, void* stream) {
  if (nw == 0) return 0;
  Params p{leaders, members, leader_slot, lead_gid, gid, leader_ok,
           member_ok, lead_bucket, bucket, keep, sims, emit, comparisons,
           emitted, s, w, d, tiles::row_stride(d), normalized,
           allpairs, match_bucket, new_from, refresh_below, has_r1, r1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == kPipe) {
    if (d % 4 != 0 || d > pipe::kMaxD || s == 0 || w == 0)
      return static_cast<int>(cudaErrorInvalidValue);
    // the items of a window add to its counters
    const size_t bytes = static_cast<size_t>(nw) * sizeof(int32_t);
    cudaError_t err = cudaMemsetAsync(comparisons, 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(emitted, 0, bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 128-member items with two stages where they fit (d <= 128), else
    // 64-member items, with two stages where they fit (d <= 256)
    if (pipe_fits<2, 4>(d)) return launch_pipe<2, 4>(p, nw, st);
    return pipe_fits<2, 2>(d) ? launch_pipe<2, 2>(p, nw, st)
                              : launch_pipe<1, 2>(p, nw, st);
  }
  if (design != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = tiles::smem_bytes(d);
  auto kernel = d > tiles::kMaxChunk ? window_score_kernel<true>
                                     : window_score_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nw, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
