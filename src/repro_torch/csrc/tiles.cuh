// Staged similarity tiles shared by window_score.cu and leader_score.cu.
//
// One block of kThreads threads scores one window: leader tiles of up to
// 32 rows and member tiles of 64 rows are staged, zero padded and (if
// asked) normalised in shared memory, x / sqrt(sum x^2 + 1e-12) as a
// division, as in the oracles.  The row stride is an odd number of
// float4s, so the float4 reads are free of bank conflicts.  Each warp owns
// 32 members and one of four leader groups; a thread keeps up to 8 leader
// accumulators in registers, so one float4 member read feeds up to 32
// FMAs.  Products are plain fp32 FMA (no TF32), which keeps a similarity
// within an ulp or two of the oracle's.
//
// Rows wider than kMaxChunk floats do not fit the 227 KB of shared memory
// whole (d = 1152, an LM embedding, would need 434 KB), so they are
// staged kMaxChunk columns at a time, and the norms are taken first from
// device memory in the order the one-chunk staging sums them; each
// similarity is then the same sequence of FMAs either way.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {
namespace tiles {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLeaderTile = 32;
constexpr int kMemberTile = 64;
constexpr int kLeaderGroups = kThreads / kMemberTile;    // 4
constexpr int kAcc = kLeaderTile / kLeaderGroups;        // 8

constexpr int kMaxChunk = 512;          // widest slice of a row staged

// Row stride (floats) of a staged tile: an odd number of float4s >= the
// staged width min(d, kMaxChunk).
inline int row_stride(int d) {
  const int q = ((d < kMaxChunk ? d : kMaxChunk) + 3) / 4;
  return 4 * (q % 2 ? q : q + 1);
}

// Dynamic shared memory of one block (bytes): the two tiles and their
// rows' norms.
inline int smem_bytes(int d) {
  return ((kLeaderTile + kMemberTile) * (row_stride(d) + 1))
         * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Leader (within its tile) of the thread's accumulator i.
__device__ __forceinline__ int tile_leader(int i) {
  return (threadIdx.x >> 6) + kLeaderGroups * i;
}

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
    for (int r = warp; r < rows; r += kWarps) {
      float* row = dst + r * stride;
      float ss = 0.f;
      for (int c = lane; c < d; c += 32) ss = fmaf(row[c], row[c], ss);
      const float nrm = sqrtf(warp_sum(ss) + 1e-12f);
      for (int c = lane; c < d; c += 32) row[c] = row[c] / nrm;
    }
    __syncthreads();
  }
}

// Norms sqrt(sum x^2 + 1e-12) of `rows` rows of width d, from device
// memory, one warp a row, summed as stage_rows sums them.
__device__ void row_norms(float* dst, const float* src, int rows, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* row = src + static_cast<size_t>(r) * d;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) ss = fmaf(row[c], row[c], ss);
    const float nrm = sqrtf(warp_sum(ss) + 1e-12f);
    if (lane == 0) dst[r] = nrm;
  }
}

// Copy columns [c0, c0 + kMaxChunk) of `rows` rows of width d into shared
// memory with row stride `stride` (zero padded), divided by `norms[r]`
// unless norms is null.
__device__ void stage_chunk(float* dst, const float* src, int rows, int d,
                            int c0, int stride, const float* norms) {
  __syncthreads();                      // previous chunk fully consumed
  for (int i = threadIdx.x; i < rows * stride; i += kThreads) {
    const int r = i / stride;
    const int c = i - r * stride;
    const float x = c < kMaxChunk && c0 + c < d
        ? src[static_cast<size_t>(r) * d + c0 + c] : 0.f;
    dst[i] = norms != nullptr ? x / norms[r] : x;
  }
  __syncthreads();
}

// Score the s x w tile of one window (rows `lead`, `memb`, width d) in
// shared memory `smem` of smem_bytes(d).  For each member tile the thread
// serves, calls epi(m, lb, nl, acc): member m of the window, the leader
// tile's first row lb and its row count nl; acc[i] is the similarity of
// leader lb + tile_leader(i) when tile_leader(i) < nl.  kChunked (for
// d > kMaxChunk) stages the rows a chunk at a time; it is a template
// parameter so that the one-chunk kernels keep their registers.
template <bool kChunked, class Epilogue>
__device__ __forceinline__ void score_window(
    const float* lead, const float* memb, int s, int w, int d, int stride,
    bool normalized, float* smem, Epilogue&& epi) {
  float* s_lead = smem;
  float* s_memb = s_lead + kLeaderTile * stride;
  float* s_nlead = s_memb + kMemberTile * stride;
  float* s_nmemb = s_nlead + kLeaderTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mm = (warp & 1) * 32 + lane;     // member within the tile
  for (int lb = 0; lb < s; lb += kLeaderTile) {
    const int nl = min(kLeaderTile, s - lb);
    const float* lsrc = lead + static_cast<size_t>(lb) * d;
    if constexpr (!kChunked)
      stage_rows(s_lead, lsrc, nl, d, stride, normalized);
    else if (normalized)
      row_norms(s_nlead, lsrc, nl, d);
    for (int mb = 0; mb < w; mb += kMemberTile) {
      const int nm = min(kMemberTile, w - mb);
      const float* msrc = memb + static_cast<size_t>(mb) * d;
      if constexpr (!kChunked)
        stage_rows(s_memb, msrc, nm, d, stride, normalized);
      else if (normalized)
        row_norms(s_nmemb, msrc, nm, d);
      float acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int c0 = 0; c0 < (kChunked ? d : 1); c0 += kMaxChunk) {
        if constexpr (kChunked) {
          stage_chunk(s_lead, lsrc, nl, d, c0, stride,
                      normalized ? s_nlead : nullptr);
          stage_chunk(s_memb, msrc, nm, d, c0, stride,
                      normalized ? s_nmemb : nullptr);
        }
        if (mm >= nm) continue;
        const int q = (min(d - c0, kMaxChunk) + 3) / 4;   // float4s of it
        const float4* mrow = reinterpret_cast<const float4*>(
            s_memb + mm * stride);
        for (int k4 = 0; k4 < q; ++k4) {
          const float4 mv = mrow[k4];
#pragma unroll
          for (int i = 0; i < kAcc; ++i) {
            const int jl = tile_leader(i);
            if (jl < nl) {             // uniform across the warp
              const float4 lv = reinterpret_cast<const float4*>(
                  s_lead + jl * stride)[k4];
              acc[i] = fmaf(lv.x, mv.x, acc[i]);
              acc[i] = fmaf(lv.y, mv.y, acc[i]);
              acc[i] = fmaf(lv.z, mv.z, acc[i]);
              acc[i] = fmaf(lv.w, mv.w, acc[i]);
            }
          }
        }
      }
      if (mm < nm) epi(mb + mm, lb, nl, acc);
    }
  }
}

}  // namespace tiles
}  // namespace
