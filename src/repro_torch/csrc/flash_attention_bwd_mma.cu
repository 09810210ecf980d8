// The backward of blocked GQA attention on the H100's tensor cores
// (mma.sync m16n8k8 in TF32), for fp32 and bf16 inputs at head dims 64,
// 128 and 256: dq, dk and dv from q, k, v, the forward's output o, the
// output's gradient do and the forward's row log-sum-exp.
//
// Replaces no TPU kernel: the JAX package differentiates ref.mha_ref.  It
// is the tensor-core design of kernels/flash_attention.py's backward
// (`_bwd_design`); csrc/flash_attention_bwd.cu (fp32 FMA) stays the design
// for every other head dim up to 256.  The contract is ref.mha_bwd_ref's:
// q, o and do (b, hq, sq, d), k and v (b, hkv, sk, d), hq % hkv == 0, all
// fp32 or all bf16; lse fp32 (b, hq, sq).  Query row i sits at key
// position sk - sq + i; key j is visible to row i iff j <= pos(i) (causal)
// and j > pos(i) - window.  With P = exp(S * scale - lse) on visible pairs
// (0 elsewhere), delta = rowsum(do * o) and dS = P * (do V^T - delta):
//   dq = dS K * scale,  dk = dS^T Q * scale,  dv = P^T do,
// dk and dv summed over the g = hq / hkv query heads of a KV head.
// Accumulation is fp32; outputs are in q's type.
//
// What bounds it: operations.  Five products of 2 d FLOP per visible pair
// and query head (S, dP, dV, dK, dQ): at the training path's shape
// (b, hq, hkv, s, d) = (2, 4, 1, 2048, 256) that is 43.0 GFLOP causal and
// 18.8 GFLOP with window 512, 0.087 / 0.038 ms at the card's 495 TFLOP/s
// in TF32, against 84 MB of inputs and outputs (0.025 ms at 3.35 TB/s).
//
// The fp32 contract on TF32 tensor cores: a TF32 product keeps about
// three decimal digits, so each fp32 operand x is split into hi = x
// rounded to TF32 (to nearest, ties away from zero, as cvt.rna) and
// lo = x - hi (the tensor core reads lo's top 19 bits: within 2^-21 of x
// together), and a product is lo*hi + hi*lo + hi*hi (the lo*lo term is
// about 2^-22 relative), three mma.sync a fragment, accumulated in fp32.
// Tiles stay fp32 in shared memory and are split as each fragment is
// loaded, so the split costs no shared memory.  bf16 values are exact in
// TF32 (8 exponent bits, 8 significant bits), so with bf16 inputs S and
// dP take one term, and only P and dS (computed fp32 values) take two.
// The split triples the tensor work: 0.260 ms (global) and 0.114 ms
// (local) at the path's shape.  mma.sync and not wgmma: wgmma takes TF32
// operands only K-major, so dV = P^T dO, dK = dS^T Q and dQ = dS K would
// each need a transposed copy of a tile; mma.sync fragments load from
// shared memory in any layout.
//
// Five launches on one stream, no floating-point atomics anywhere, every
// sum in a fixed order, so a training step is deterministic:
//   1. delta: one warp a row, rowsum(do * o) in fp32 (attention_delta.cuh,
//      shared with the FMA design).
//   2. dK / dV over a work list that the wrapper builds on the host
//      (kernels/flash_attention.py::bwd_work_list) and caches on the
//      device per (shape, mask).  A key block's tiles (query head, query
//      block of kBQ rows), visible ones only, laid end to end over every
//      (batch, KV head, key block of kBK keys), are cut into as many
//      equal runs as the card holds blocks at once; a block of kThreads
//      threads takes one run (a "part"), a list of segments each of one
//      key block and at most 16 tiles (BWD_MMA_SEGMENT_TILES: a longer
//      chain of tensor-core accumulation drifts further from fp32 sums
//      rounded to nearest).  Every part has the same number of visible
//      tiles (within one), whatever the causal mask does to a key
//      block's length.  A segment stages K and V (unless its part's last
//      segment had the same key block), then for each of its tiles
//      stages Q and dO, computes S^T = K Q^T and dP^T = V dO^T (keys as
//      rows), forms P^T and dS^T in shared memory, writes dS to a stash
//      in device memory (visible tiles only), and accumulates
//      dV += P^T dO and dK += dS^T Q in registers.  It writes its
//      partial dK and dV to an fp32 scratch slot of its own; a second
//      launch sums each key block's slots in the list's order and writes
//      dk and dv in q's type (zeros for a key block no row can see).
//   3. dQ += dS K from the stash over a second list, cut the same way:
//      query blocks of 2 kBQ rows, each with the key blocks its rows see,
//      end to end over every (batch, query head, query block).  A block
//      of kQThreads threads takes a part; each segment writes a partial
//      dQ to its own slot, and a last launch sums each query block's
//      slots in order, times scale, in q's type.  Five products in all,
//      not seven: S and dP are not recomputed.

// Registers and shared memory.  At d = 256 in fp32 a 64-row tile is
// 64 KB, so K and V of a 64-key block take 128 KB of the 227 KB a block
// may have; the query tiles are therefore 32 rows (Q and dO 64 KB), and
// with P^T and dS^T (20 KB) a dK / dV block takes 215 KB, one block an
// SM.  dK and dV of a 64-key block are 32,768 fp32 accumulators: 64 a
// thread at 512 threads (16 warps), each warp owning 32 keys x d / 8
// columns of both (two m16 tiles share each B fragment's split).  S^T and
// dP^T are 16 x 8 a warp.  The dQ
// block (256 threads, 64 query rows, 32 rows x d / 4 columns a warp)
// holds 64 accumulators a thread and 84 KB of shared memory, two blocks
// an SM.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32; g = lane / 4,
// t = lane % 4): A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8) b0 (t, g), b1 (t + 4, g); C (16 x 8)
// c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, 2t, 2t + 1).  S^T and dP^T load
// both operands with ldmatrix (an 8 x 8 b16 matrix is an 8 x 4 fp32 one,
// delivered in exactly the (g, t) pattern).  The products over the query
// or key dimension permute their k index within each 8-chunk (logical t
// -> physical 2t, t + 4 -> 2t + 1), which is free since the sum runs over
// it: A then loads as float2 pairs (row g, columns 2t, 2t + 1) and B as
// (rows 2t, 2t + 1, column g).  Row strides: kSP = d + 4 floats (16 B mod
// 128: ldmatrix rows and the (2t, g) scalar loads are free of bank
// conflicts), kPS = kBQ + 8 and kDS = kBK + 8 (8 mod 32: the float2
// (g, 2t) accesses are).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_delta.cuh"
#include "tf32_split.cuh"

#include <type_traits>

namespace {

constexpr int kBK = 64;                 // keys a block
constexpr int kBQ = 32;                 // query rows a dK / dV tile
constexpr int kWarps = 16;              // dK / dV block
constexpr int kThreads = kWarps * 32;
constexpr int kPS = kBQ + 8;            // P^T and dS^T row stride
constexpr int kQWarps = 8;              // dQ block
constexpr int kQThreads = kQWarps * 32;
constexpr int kQRows = 2 * kBQ;         // query rows a dQ block
constexpr int kDS = kBK + 8;            // dS row stride in the dQ block
constexpr int kRowThreads = 256;        // reduce blocks
constexpr int kReduceRows = 8;          // rows a reduce block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* stash;                         // dS of the visible tiles
  float* partial;                       // (segments, 2, kBK, d) dK, dV
  float* dq_partial;                    // (dQ segments, kQRows, d)
  const int* segs;                      // (segments, 6): bkv, kb, t0, t1,
                                        // first query block, query blocks
  const int* part_off;                  // (parts + 1) segment offsets
  const int* unit_off;                  // (b hkv nkb + 1) segment offsets
  const int* q_kblo;                    // (nqb) first visible key block
  const int* q_kbhi;                    // (nqb) last (< first if none)
  const int* q_off;                     // (nqb) stash tiles before it
  const int* dq_segs;                   // (dQ segments, 6): bh, qb2, t0,
                                        // t1, first key block, 0
  const int* dq_part_off;               // (dQ parts + 1)
  const int* dq_unit_off;               // (b hq nqb2 + 1)
  int hq, hkv, g, sq, sk, nkb, nqb, nqb2, tiles_per_head;
  float scale;
  int causal, has_window, window;
};

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Four consecutive elements as fp32 (16-byte or 8-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Stage rows [r0, r0 + R) of a (n, D) matrix into smem as fp32 with row
// stride D + 4, zero past n.
template <typename T, int D, int R, int NT>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int n) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < R * C4; i += NT) {
    const int r = i / C4, c = (i - r * C4) * 4;
    const int row = r0 + r;
    const float4 x = row < n
        ? load4(src + static_cast<size_t>(row) * D + c)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    store4(dst + r * (D + 4) + c, x);
  }
}

template <int D>
constexpr int dkdv_smem() {
  return static_cast<int>(sizeof(float))
         * (2 * kBK * (D + 4) + 2 * kBQ * (D + 4) + 2 * kBK * kPS + 2 * kBQ);
}

template <int D>
constexpr int dq_smem() {
  return static_cast<int>(sizeof(float))
         * (kBK * (D + 4) + kQRows * kDS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(Params p) {
  constexpr bool kSplitIn = std::is_same<T, float>::value;
  constexpr int SP = D + 4;
  constexpr int MW = 2;                 // m16 tiles a warp in dK / dV
  constexpr int NC = D / 8;             // columns a warp in dK / dV
  constexpr int NT = NC / 8;            // their n8 tiles
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;                    // kBK x SP
  float* s_v = s_k + kBK * SP;          // kBK x SP
  float* s_q = s_v + kBK * SP;          // kBQ x SP
  float* s_do = s_q + kBQ * SP;         // kBQ x SP
  float* s_pt = s_do + kBQ * SP;        // kBK x kPS, P^T [key][row]
  float* s_dst = s_pt + kBK * kPS;      // kBK x kPS, dS^T
  float* s_lse = s_dst + kBK * kPS;     // kBQ
  float* s_delta = s_lse + kBQ;         // kBQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tg = lane % 4;
  // phase 1: the warp's 16 x 8 tile of S^T and dP^T
  const int m1 = (warp / 4) * 16, n1 = (warp % 4) * 8;
  // phase 2: the warp's 32 keys x NC columns of dK and dV
  const int m2 = (warp % 2) * 32, c2 = (warp / 2) * NC;

  const int seg_lo = p.part_off[blockIdx.x];
  const int seg_hi = p.part_off[blockIdx.x + 1];
  int staged = -1;                      // the key block in s_k and s_v
  for (int seg = seg_lo; seg < seg_hi; ++seg) {
    const int* sd = p.segs + 6 * seg;
    const int bkv = sd[0], kb = sd[1], t0 = sd[2], t1 = sd[3];
    const int qlo = sd[4], nq = sd[5];
    const int bb = bkv / p.hkv, kvh = bkv - bb * p.hkv;
    const int k0 = kb * kBK;
    const size_t kv_base = static_cast<size_t>(bkv) * p.sk;
    if (bkv * p.nkb + kb != staged) {
      staged = bkv * p.nkb + kb;
      __syncthreads();                  // the last segment is done
      stage<T, D, kBK, kThreads>(s_k, static_cast<const T*>(p.k)
                                 + kv_base * D, k0, p.sk);
      stage<T, D, kBK, kThreads>(s_v, static_cast<const T*>(p.v)
                                 + kv_base * D, k0, p.sk);
    }
    float dk[MW][NT][4], dv[MW][NT][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mi][n][e] = dv[mi][n][e] = 0.0f;

    for (int t = t0; t < t1; ++t) {
      const int hh = t / nq;
      const int qb = qlo + (t - hh * nq);
      const int h = kvh * p.g + hh;
      const int q0 = qb * kBQ;
      const size_t q_base = (static_cast<size_t>(bb) * p.hq + h) * p.sq;
      __syncthreads();                  // the last tile is consumed
      stage<T, D, kBQ, kThreads>(s_q, static_cast<const T*>(p.q)
                                 + q_base * D, q0, p.sq);
      stage<T, D, kBQ, kThreads>(s_do, static_cast<const T*>(p.dout)
                                 + q_base * D, q0, p.sq);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        s_lse[threadIdx.x] = row < p.sq ? p.lse[q_base + row] : 0.0f;
        s_delta[threadIdx.x] = row < p.sq ? p.delta[q_base + row] : 0.0f;
      }
      __syncthreads();

      // Phase 1: S^T = K Q^T and dP^T = V dO^T for keys m1.., rows n1..
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      {
        const int ar = m1 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ac = (lane >> 4) * 4;
        const int br = n1 + (lane & 7);
        const int bc = (lane >> 3) * 4;
#pragma unroll 2
        for (int e = 0; e < D; e += 16) {
          uint32_t rq[4], rdo[4];
          ldmatrix_x4(rq, s_q + br * SP + e + bc);
          ldmatrix_x4(rdo, s_do + br * SP + e + bc);
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {
            uint32_t rk[4], rv[4];
            ldmatrix_x4(rk, s_k + ar * SP + e + 8 * h8 + ac);
            ldmatrix_x4(rv, s_v + ar * SP + e + 8 * h8 + ac);
            Frag<4> fk, fv;
            split<kSplitIn>(fk, rk);
            split<kSplitIn>(fv, rv);
            const uint32_t bq[2] = {rq[2 * h8], rq[2 * h8 + 1]};
            const uint32_t bd[2] = {rdo[2 * h8], rdo[2 * h8 + 1]};
            Frag<2> fq, fd;
            split<kSplitIn>(fq, bq);
            split<kSplitIn>(fd, bd);
            mma_split<kSplitIn, kSplitIn>(s, fk, fq);
            mma_split<kSplitIn, kSplitIn>(dp, fv, fd);
          }
        }
      }
      // P^T and dS^T into shared memory, dS into the stash
      {
        const size_t tile = (static_cast<size_t>(bb) * p.hq + h)
                                * p.tiles_per_head
                            + p.q_off[qb] + (kb - p.q_kblo[qb]);
        float* st = p.stash + tile * (kBQ * kBK);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = m1 + gr + 8 * half;
          float pv[2], dsv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int row = n1 + 2 * tg + c;
            pv[c] = dsv[c] = 0.0f;
            if (visible(q0 + row, k0 + key, p)) {
              pv[c] = expf(s[2 * half + c] * p.scale - s_lse[row]);
              dsv[c] = pv[c] * (dp[2 * half + c] - s_delta[row]);
            }
            st[row * kBK + key] = dsv[c];
          }
          store2(s_pt + key * kPS + n1 + 2 * tg, pv[0], pv[1]);
          store2(s_dst + key * kPS + n1 + 2 * tg, dsv[0], dsv[1]);
        }
      }
      __syncthreads();

      // Phase 2: dV += P^T dO and dK += dS^T Q over the tile's rows
#pragma unroll
      for (int kc = 0; kc < kBQ; kc += 8) {
        Frag<4> fp[MW], fs[MW];
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          const int r0 = m2 + 16 * mi + gr;
          const float2 p0 = *reinterpret_cast<const float2*>(
              s_pt + r0 * kPS + kc + 2 * tg);
          const float2 p1 = *reinterpret_cast<const float2*>(
              s_pt + (r0 + 8) * kPS + kc + 2 * tg);
          const float2 d0 = *reinterpret_cast<const float2*>(
              s_dst + r0 * kPS + kc + 2 * tg);
          const float2 d1 = *reinterpret_cast<const float2*>(
              s_dst + (r0 + 8) * kPS + kc + 2 * tg);
          const uint32_t ap[4] = {
              __float_as_uint(p0.x), __float_as_uint(p1.x),
              __float_as_uint(p0.y), __float_as_uint(p1.y)};
          const uint32_t as[4] = {
              __float_as_uint(d0.x), __float_as_uint(d1.x),
              __float_as_uint(d0.y), __float_as_uint(d1.y)};
          split<true>(fp[mi], ap);
          split<true>(fs[mi], as);
        }
        const float* dor = s_do + (kc + 2 * tg) * SP + c2 + gr;
        const float* qr = s_q + (kc + 2 * tg) * SP + c2 + gr;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t bd[2] = {__float_as_uint(dor[8 * n]),
                                  __float_as_uint(dor[SP + 8 * n])};
          const uint32_t bq[2] = {__float_as_uint(qr[8 * n]),
                                  __float_as_uint(qr[SP + 8 * n])};
          Frag<2> fd, fq;
          split<kSplitIn>(fd, bd);
          split<kSplitIn>(fq, bq);
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            mma_split<true, kSplitIn>(dv[mi][n], fp[mi], fd);
            mma_split<true, kSplitIn>(dk[mi][n], fs[mi], fq);
          }
        }
      }
    }

    // the segment's partial dK (times scale) and dV into its slot
    float* out = p.partial + static_cast<size_t>(seg) * 2 * kBK * D;
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = c2 + 8 * n + 2 * tg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = m2 + 16 * mi + gr + 8 * half;
        store2(out + key * D + col, dk[mi][n][2 * half] * p.scale,
               dk[mi][n][2 * half + 1] * p.scale);
        store2(out + (kBK + key) * D + col, dv[mi][n][2 * half],
               dv[mi][n][2 * half + 1]);
      }
    }
  }
}

// Sum a key block's segment slots in the list's order; zeros if none.
// One block a key block's kReduceRows rows.
template <typename T, int D>
__global__ void __launch_bounds__(kRowThreads) reduce_kernel(Params p) {
  const int unit = blockIdx.x;
  const int bkv = unit / p.nkb, kb = unit - bkv * p.nkb;
  const int lo = p.unit_off[unit], hi = p.unit_off[unit + 1];
  const size_t base = (static_cast<size_t>(bkv) * p.sk) * D;
  T* dk = static_cast<T*>(p.dk) + base;
  T* dv = static_cast<T*>(p.dv) + base;
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < kReduceRows * C4; i += kRowThreads) {
    const int r = blockIdx.y * kReduceRows + i / C4;
    const int c = (i % C4) * 4;
    const int key = kb * kBK + r;
    if (key >= p.sk) continue;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    for (int s = lo; s < hi; ++s) {
      const float* slot = p.partial + static_cast<size_t>(s) * 2 * kBK * D;
      const float4 x = load4(slot + r * D + c);
      const float4 y = load4(slot + (kBK + r) * D + c);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
    }
    store4(dk + static_cast<size_t>(key) * D + c, a);
    store4(dv + static_cast<size_t>(key) * D + c, b);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kQThreads, 2) dq_kernel(Params p) {
  constexpr bool kSplitIn = std::is_same<T, float>::value;
  constexpr int SP = D + 4;
  constexpr int NC = D / 4;             // columns a warp
  constexpr int NT = NC / 8;
  constexpr int MW = 2;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;                    // kBK x SP
  float* s_ds = s_k + kBK * SP;         // kQRows x kDS, dS [row][key]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tg = lane % 4;
  const int m = (warp % 2) * 32, c0 = (warp / 2) * NC;

  const int seg_lo = p.dq_part_off[blockIdx.x];
  const int seg_hi = p.dq_part_off[blockIdx.x + 1];
  for (int seg = seg_lo; seg < seg_hi; ++seg) {
    const int* sd = p.dq_segs + 6 * seg;
    const int bh = sd[0], qb2 = sd[1];
    const int kb_lo = sd[4] + sd[2], kb_hi = sd[4] + sd[3] - 1;
    const int bb = bh / p.hq, h = bh - bb * p.hq;
    const size_t kv_base =
        (static_cast<size_t>(bb) * p.hkv + h / p.g) * p.sk;
    const T* k = static_cast<const T*>(p.k) + kv_base * D;
    const size_t head_tiles = static_cast<size_t>(bh) * p.tiles_per_head;
    // the two query blocks of kBQ rows and the key blocks they see
    int qbs[2], lo[2], hi[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      qbs[x] = 2 * qb2 + x;
      const bool real = qbs[x] < p.nqb;
      lo[x] = real ? p.q_kblo[qbs[x]] : 0;
      hi[x] = real ? p.q_kbhi[qbs[x]] : -1;
    }

    float acc[MW][NT][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.0f;

    for (int kb = kb_lo; kb <= kb_hi; ++kb) {
      __syncthreads();                  // the last tiles are consumed
      stage<T, D, kBK, kQThreads>(s_k, k, kb * kBK, p.sk);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const bool have = kb >= lo[x] && kb <= hi[x];
        const float* st = have
            ? p.stash + (head_tiles + p.q_off[qbs[x]] + (kb - lo[x]))
                            * (kBQ * kBK)
            : nullptr;
        for (int i = threadIdx.x; i < kBQ * kBK / 4; i += kQThreads) {
          const int r = i / (kBK / 4), c = (i - r * (kBK / 4)) * 4;
          const float4 v = have ? load4(st + r * kBK + c)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          store4(s_ds + (x * kBQ + r) * kDS + c, v);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int kc = 0; kc < kBK; kc += 8) {
        Frag<4> fa[MW];
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          const int r0 = m + 16 * mi + gr;
          const float2 a0 = *reinterpret_cast<const float2*>(
              s_ds + r0 * kDS + kc + 2 * tg);
          const float2 a1 = *reinterpret_cast<const float2*>(
              s_ds + (r0 + 8) * kDS + kc + 2 * tg);
          const uint32_t av[4] = {__float_as_uint(a0.x),
                                  __float_as_uint(a1.x),
                                  __float_as_uint(a0.y),
                                  __float_as_uint(a1.y)};
          split<true>(fa[mi], av);
        }
        const float* kr = s_k + (kc + 2 * tg) * SP + c0 + gr;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t bk[2] = {__float_as_uint(kr[8 * n]),
                                  __float_as_uint(kr[SP + 8 * n])};
          Frag<2> fb;
          split<kSplitIn>(fb, bk);
#pragma unroll
          for (int mi = 0; mi < MW; ++mi)
            mma_split<true, kSplitIn>(acc[mi][n], fa[mi], fb);
        }
      }
    }

    // the segment's partial dQ into its slot
    float* out = p.dq_partial + static_cast<size_t>(seg) * kQRows * D;
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m + 16 * mi + gr + 8 * half;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        store2(out + row * D + c0 + 8 * n + 2 * tg, acc[mi][n][2 * half],
               acc[mi][n][2 * half + 1]);
    }
  }
}

// Sum a query block's dQ slots in the list's order, times scale; zeros
// for rows that see no key.
template <typename T, int D>
__global__ void __launch_bounds__(kRowThreads) dq_reduce_kernel(Params p) {
  const int unit = blockIdx.x;
  const int bh = unit / p.nqb2, qb2 = unit - bh * p.nqb2;
  const int lo = p.dq_unit_off[unit], hi = p.dq_unit_off[unit + 1];
  T* dq = static_cast<T*>(p.dq) + static_cast<size_t>(bh) * p.sq * D;
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < kReduceRows * C4; i += kRowThreads) {
    const int r = blockIdx.y * kReduceRows + i / C4;
    const int c = (i % C4) * 4;
    const int row = qb2 * kQRows + r;
    if (row >= p.sq) continue;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = lo; s < hi; ++s) {
      const float4 x = load4(p.dq_partial
                             + (static_cast<size_t>(s) * kQRows + r) * D + c);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    }
    a.x *= p.scale; a.y *= p.scale; a.z *= p.scale; a.w *= p.scale;
    store4(dq + static_cast<size_t>(row) * D + c, a);
  }
}

template <typename T, int D>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem<D>());
}

template <typename T, int D>
int launch(const Params& p, int b, int parts, int dq_parts,
           cudaStream_t stream) {
  static_assert(dkdv_smem<D>() <= 232448, "dK / dV block shared memory");
  static_assert(D % 64 == 0 && kWarps == 16, "warp layout");
  cudaError_t err = set_smem<T, D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attn::launch_delta<T>(p.o, p.dout, p.delta,
                             static_cast<size_t>(b) * p.hq * p.sq, D,
                             stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (parts > 0) {
    dkdv_kernel<T, D><<<parts, kThreads, dkdv_smem<D>(), stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  reduce_kernel<T, D><<<dim3(b * p.hkv * p.nkb, kBK / kReduceRows),
                        kRowThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dq_parts > 0) {
    dq_kernel<T, D><<<dq_parts, kQThreads, dq_smem<D>(), stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dq_reduce_kernel<T, D><<<dim3(b * p.hq * p.nqb2, kQRows / kReduceRows),
                           kRowThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Params& p, int b, int d, int parts, int dq_parts,
             cudaStream_t s) {
  if (d == 64) return launch<T, 64>(p, b, parts, dq_parts, s);
  if (d == 128) return launch<T, 128>(p, b, parts, dq_parts, s);
  return launch<T, 256>(p, b, parts, dq_parts, s);
}

template <typename T, int D>
int blocks_per_sm(int which) {
  if (set_smem<T, D>() != cudaSuccess) return -1;
  int n = 0;
  const cudaError_t err = which == 0
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, dkdv_kernel<T, D>, kThreads, dkdv_smem<D>())
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, dq_kernel<T, D>, kQThreads, dq_smem<D>());
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// The tile sizes the work list must be cut to: keys a key block, query
// rows a dK / dV tile.
extern "C" int flash_attention_bwd_mma_block_keys() { return kBK; }
extern "C" int flash_attention_bwd_mma_block_rows() { return kBQ; }

// Blocks of the dK / dV kernel (which = 0) or the dQ kernel (which = 1)
// that one SM holds at once at head dim d (64, 128 or 256) for fp32
// (bf16 = 0) or bf16 inputs; -1 on a CUDA error or another d.
extern "C" int flash_attention_bwd_mma_blocks_per_sm(int d, int bf16,
                                                     int which) {
  if (d == 64) return bf16 ? blocks_per_sm<__nv_bfloat16, 64>(which)
                           : blocks_per_sm<float, 64>(which);
  if (d == 128) return bf16 ? blocks_per_sm<__nv_bfloat16, 128>(which)
                            : blocks_per_sm<float, 128>(which);
  if (d == 256) return bf16 ? blocks_per_sm<__nv_bfloat16, 256>(which)
                            : blocks_per_sm<float, 256>(which);
  return -1;
}

// Launch on `stream`: q, o, dout and dq (b, hq, sq, d); k, v, dk and dv
// (b, hkv, sk, d); lse and the scratch `delta` fp32 (b, hq, sq); all
// contiguous and 16-byte aligned; `bf16` selects __nv_bfloat16 over float
// for every tensor but lse, delta and the scratch.  The work list
// (`segs` .. `dq_unit_off`, `parts`, `dq_parts`, `tiles_per_head`) is
// kernels/flash_attention.py::bwd_work_list cut to this kernel's tiles;
// `stash` holds b hq tiles_per_head kBQ x kBK floats, `partial`
// (segments, 2, kBK, d) and `dq_partial` (dQ segments, 2 kBQ, d).  Returns
// cudaGetLastError() (0 on success); d not 64, 128 or 256, or hq not a
// multiple of hkv, returns cudaErrorInvalidValue without launching.
extern "C" int flash_attention_bwd_mma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* stash, float* partial, float* dq_partial,
    const int* segs, const int* part_off, const int* unit_off,
    const int* q_kblo, const int* q_kbhi, const int* q_off,
    const int* dq_segs, const int* dq_part_off, const int* dq_unit_off,
    int parts, int dq_parts, int tiles_per_head, int b, int hq, int hkv,
    int sq, int sk, int d, float scale, int causal, int has_window,
    int window, int bf16, void* stream) {
  if ((d != 64 && d != 128 && d != 256) || hkv < 1 || hq % hkv != 0
      || parts < 0 || dq_parts < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 0 || hq == 0) return 0;
  const size_t elt = bf16 ? 2 : 4;
  if (sq == 0 || sk == 0) {             // no pair: every gradient is 0
    cudaError_t err = cudaMemsetAsync(
        dq, 0, static_cast<size_t>(b) * hq * sq * d * elt, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dk, 0, static_cast<size_t>(b) * hkv * sk * d
                            * elt, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dv, 0, static_cast<size_t>(b) * hkv * sk * d
                            * elt, s);
    return static_cast<int>(err);
  }
  const int nkb = (sk + kBK - 1) / kBK, nqb = (sq + kBQ - 1) / kBQ;
  const Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, stash, partial,
                 dq_partial, segs, part_off, unit_off, q_kblo, q_kbhi, q_off,
                 dq_segs, dq_part_off, dq_unit_off, hq, hkv, hq / hkv, sq, sk,
                 nkb, nqb, (nqb + 1) / 2, tiles_per_head, scale, causal,
                 has_window, window};
  return bf16 ? launch_d<__nv_bfloat16>(p, b, d, parts, dq_parts, s)
              : launch_d<float>(p, b, d, parts, dq_parts, s);
}
