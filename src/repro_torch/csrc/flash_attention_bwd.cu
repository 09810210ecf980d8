// The backward of blocked GQA attention with causal and sliding-window
// masks, for Hopper (sm_90a): dq, dk and dv from q, k, v, the forward's
// output o, the output's gradient do and the forward's row log-sum-exp.
//
// Replaces no TPU kernel: the JAX package has no backward kernel (no
// custom_vjp around its Pallas flash_attention) and differentiates the
// plain ref.mha_ref.  On the card the forward is the port's own kernel
// (flash_attention.cu or flash_attention_wgmma.cu), whose output has no
// autograd history, so kernels/flash_attention.py::FlashAttention pairs it
// with this kernel.  The contract is ref.mha_bwd_ref's: q, o and do are
// (b, hq, sq, d), k and v (b, hkv, sk, d) with hq % hkv == 0, all fp32 or
// all bf16, d <= 256; lse is fp32 (b, hq, sq).  Positions are
// right-aligned (query row i sits at key position sk - sq + i); key j is
// visible to row i iff j <= pos(i) (causal) and j > pos(i) - window.  With
// P = exp(S * scale - lse) on visible pairs (0 elsewhere),
// delta = rowsum(do * o) and dS = P * (do V^T - delta):
//   dq = dS K * scale,  dk = dS^T Q * scale,  dv = P^T do,
// dk and dv summed over the g = hq / hkv query heads of a KV head.
// Accumulation is fp32; outputs are in q's type.
//
// What bounds it on the H100: operations.  The contract is five products
// of 2 d FLOP per visible (query, key) pair and query head (S, dP, dV, dK,
// dQ).  At the training path's shape (b, hq, hkv, s, d) = (2, 4, 1, 2048,
// 256) in fp32 that is 43.0 GFLOP causal and 18.8 GFLOP with window 512,
// 0.64 and 0.28 ms at the card's 67 TFLOP/s fp32 rate, against 84 MB of
// inputs and outputs (0.025 ms at 3.35 TB/s).  This design runs fp32 FMA
// outside the tensor cores and recomputes S and dP in both of its passes
// (seven products where the contract counts five), so it cannot come
// nearer than 1.4x that bound.  It is the FMA design: for fp32 and bf16
// at head dims 64, 128 and 256 kernels/flash_attention.py::_bwd_design
// picks the tensor-core design (flash_attention_bwd_mma.cu) instead.
//
// Design: three launches on one stream, no floating-point atomics, every
// sum in a fixed order, so that a training step is deterministic.
//   1. delta: one warp a row, rowsum(do * o) in fp32 (attention_delta.cuh).
//   2. dK / dV: one block of 256 threads per (key block of 32 keys, KV
//      head, batch row).  K and V are staged once; the block loops over
//      the group's g query heads and, for each, the query blocks of 32
//      rows that can see a key of the block.  For each it stages Q * scale
//      and dO, recomputes S and dP (thread (r, c) = (tid / 16, tid % 16)
//      owns rows 2r, 2r + 1 and keys c, c + 16 of the 32 x 32 tile), forms
//      P and dS into shared memory, then accumulates dV += P^T dO and
//      dK += dS^T (Q * scale), the thread owning keys 2r, 2r + 1 and
//      columns c + 16 m of both (2 x 2 x d / 16 registers: 64 at d = 256).
//   3. dQ: one block per (query block of 32 rows, query head, batch row),
//      looping over the key blocks its rows can see: the same S, dP and
//      dS, then dQ += dS K, times scale at the end.
// Tiles are staged as fp32 zero-padded to DP columns (the head dim rounded
// up to a power of two, 16 to 256) with a row stride of DP + 4 floats, so
// the float4 reads of the score loop are free of bank conflicts, as in
// flash_attention.cu.  Shared memory at d = 256: 138 KB a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_delta.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;              // threads that share a row pair
constexpr int kB = 32;                  // query rows or keys a tile

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
  int hq, g, sq, sk, d;
  float scale;
  int causal, has_window, window;
};

using attn::to_f32;
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage rows [r0, r0 + kB) of a (n, d) matrix into smem as fp32 with row
// stride DP + 4, times `mul`, zero outside n x d.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int n, int d, float mul) {
  for (int i = threadIdx.x; i < kB * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    const int row = r0 + r;
    dst[r * (DP + 4) + c] = row < n && c < d
        ? to_f32(src[static_cast<size_t>(row) * d + c]) * mul : 0.0f;
  }
}

// Stage the lse and delta of rows [r0, r0 + kB) (0 past sq).
__device__ __forceinline__ void stage_rows(float* s_lse, float* s_delta,
                                           const Params& p, size_t q_base,
                                           int r0) {
  if (threadIdx.x < kB) {
    const int row = r0 + threadIdx.x;
    s_lse[threadIdx.x] = row < p.sq ? p.lse[q_base + row] : 0.0f;
    s_delta[threadIdx.x] = row < p.sq ? p.delta[q_base + row] : 0.0f;
  }
}

__device__ __forceinline__ bool visible(int i, int j, const Params& p) {
  if (i >= p.sq || j >= p.sk) return false;
  const int qpos = i + p.sk - p.sq;
  if (p.causal && j > qpos) return false;
  if (p.has_window && j <= qpos - p.window) return false;
  return true;
}

// P and dS of the tile at (query row q0, key k0) for this thread's rows
// 2r, 2r + 1 and keys c, c + 16 (r = tid / 16, c = tid % 16), written to
// s_p (if non-null) and s_ds at [row * PS + key].
template <int DP, int PS>
__device__ __forceinline__ void tile_grads(
    const float* s_q, const float* s_do, const float* s_k, const float* s_v,
    const float* s_lse, const float* s_delta, float* s_p, float* s_ds,
    int q0, int k0, const Params& p) {
  constexpr int S = DP + 4;
  const int r = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
  float s[2][2], dp[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) s[a][b] = dp[a][b] = 0.0f;
#pragma unroll 2
  for (int e = 0; e < DP; e += 4) {
    float4 qv[2], dov[2], kv[2], vv[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      qv[a] = *reinterpret_cast<const float4*>(s_q + (2 * r + a) * S + e);
      dov[a] = *reinterpret_cast<const float4*>(s_do + (2 * r + a) * S + e);
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      kv[b] = *reinterpret_cast<const float4*>(s_k + (c + kLanes * b) * S + e);
      vv[b] = *reinterpret_cast<const float4*>(s_v + (c + kLanes * b) * S + e);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        s[a][b] = fmaf(qv[a].x, kv[b].x, s[a][b]);
        s[a][b] = fmaf(qv[a].y, kv[b].y, s[a][b]);
        s[a][b] = fmaf(qv[a].z, kv[b].z, s[a][b]);
        s[a][b] = fmaf(qv[a].w, kv[b].w, s[a][b]);
        dp[a][b] = fmaf(dov[a].x, vv[b].x, dp[a][b]);
        dp[a][b] = fmaf(dov[a].y, vv[b].y, dp[a][b]);
        dp[a][b] = fmaf(dov[a].z, vv[b].z, dp[a][b]);
        dp[a][b] = fmaf(dov[a].w, vv[b].w, dp[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = 2 * r + a, j = c + kLanes * b;
      float pv = 0.0f, dsv = 0.0f;
      if (visible(q0 + i, k0 + j, p)) {
        pv = expf(s[a][b] - s_lse[i]);
        dsv = pv * (dp[a][b] - s_delta[i]);
      }
      if (s_p != nullptr) s_p[i * PS + j] = pv;
      s_ds[i * PS + j] = dsv;
    }
}

template <int DP>
constexpr int dkdv_smem() {
  return static_cast<int>(sizeof(float))
         * (4 * kB * (DP + 4) + 2 * kB * kB + 2 * kB);
}

template <int DP>
constexpr int dq_smem() {
  return static_cast<int>(sizeof(float))
         * (4 * kB * (DP + 4) + kB * (kB + 1) + 2 * kB);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(Params p) {
  constexpr int S = DP + 4;
  constexpr int CPT = DP / kLanes;      // columns a thread
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                    // kB x S, Q * scale
  float* s_do = s_q + kB * S;           // kB x S
  float* s_k = s_do + kB * S;           // kB x S
  float* s_v = s_k + kB * S;            // kB x S
  float* s_p = s_v + kB * S;            // kB x kB, [row][key]
  float* s_ds = s_p + kB * kB;          // kB x kB
  float* s_lse = s_ds + kB * kB;        // kB
  float* s_delta = s_lse + kB;          // kB

  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int hkv = p.hq / p.g;
  const int k0 = kb * kB;
  const size_t kv_base = (static_cast<size_t>(b) * hkv + kvh) * p.sk;
  stage<T, DP>(s_k, static_cast<const T*>(p.k) + kv_base * p.d, k0, p.sk,
               p.d, 1.0f);
  stage<T, DP>(s_v, static_cast<const T*>(p.v) + kv_base * p.d, k0, p.sk,
               p.d, 1.0f);

  // Query rows that can see a key of this block.
  const int off = p.sk - p.sq;
  const int k_last = min(k0 + kB, p.sk) - 1;
  int i_lo = 0, i_hi = p.sq - 1;
  if (p.causal) i_lo = max(i_lo, k0 - off);
  if (p.has_window) i_hi = min(i_hi, k_last + p.window - 1 - off);

  const int r = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
  float dk[2][CPT], dv[2][CPT];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int m = 0; m < CPT; ++m) dk[a][m] = dv[a][m] = 0.0f;

  if (i_lo <= i_hi) {
    for (int hh = 0; hh < p.g; ++hh) {
      const size_t q_base =
          (static_cast<size_t>(b) * p.hq + kvh * p.g + hh) * p.sq;
      const T* q = static_cast<const T*>(p.q) + q_base * p.d;
      const T* dout = static_cast<const T*>(p.dout) + q_base * p.d;
      for (int qb = i_lo / kB; qb <= i_hi / kB; ++qb) {
        const int q0 = qb * kB;
        __syncthreads();                // the last tiles are consumed
        stage<T, DP>(s_q, q, q0, p.sq, p.d, p.scale);
        stage<T, DP>(s_do, dout, q0, p.sq, p.d, 1.0f);
        stage_rows(s_lse, s_delta, p, q_base, q0);
        __syncthreads();
        tile_grads<DP, kB>(s_q, s_do, s_k, s_v, s_lse, s_delta, s_p, s_ds,
                           q0, k0, p);
        __syncthreads();
        // dV += P^T dO and dK += dS^T (Q * scale) for keys 2r, 2r + 1
#pragma unroll 4
        for (int i = 0; i < kB; ++i) {
          const float2 pp = *reinterpret_cast<const float2*>(
              s_p + i * kB + 2 * r);
          const float2 dd = *reinterpret_cast<const float2*>(
              s_ds + i * kB + 2 * r);
          const float* dor = s_do + i * S + c;
          const float* qr = s_q + i * S + c;
#pragma unroll
          for (int m = 0; m < CPT; ++m) {
            const float x = dor[kLanes * m], y = qr[kLanes * m];
            dv[0][m] = fmaf(pp.x, x, dv[0][m]);
            dv[1][m] = fmaf(pp.y, x, dv[1][m]);
            dk[0][m] = fmaf(dd.x, y, dk[0][m]);
            dk[1][m] = fmaf(dd.y, y, dk[1][m]);
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk) + kv_base * p.d;
  T* dv_out = static_cast<T*>(p.dv) + kv_base * p.d;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int j = k0 + 2 * r + a;
    if (j >= p.sk) continue;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int col = c + kLanes * m;
      if (col < p.d) {
        store(dk_out + static_cast<size_t>(j) * p.d + col, dk[a][m]);
        store(dv_out + static_cast<size_t>(j) * p.d + col, dv[a][m]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Params p) {
  constexpr int S = DP + 4;
  constexpr int CPT = DP / kLanes;
  constexpr int PS = kB + 1;            // dS row stride: the two rows a
                                        // warp reads fall in other banks
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_do = s_q + kB * S;
  float* s_k = s_do + kB * S;
  float* s_v = s_k + kB * S;
  float* s_ds = s_v + kB * S;           // kB x PS, [row][key]
  float* s_lse = s_ds + kB * PS;
  float* s_delta = s_lse + kB;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hkv = p.hq / p.g;
  const int q0 = qb * kB;
  const size_t q_base = (static_cast<size_t>(b) * p.hq + h) * p.sq;
  const size_t kv_base = (static_cast<size_t>(b) * hkv + h / p.g) * p.sk;
  const T* k = static_cast<const T*>(p.k) + kv_base * p.d;
  const T* v = static_cast<const T*>(p.v) + kv_base * p.d;
  stage<T, DP>(s_q, static_cast<const T*>(p.q) + q_base * p.d, q0, p.sq,
               p.d, p.scale);
  stage<T, DP>(s_do, static_cast<const T*>(p.dout) + q_base * p.d, q0,
               p.sq, p.d, 1.0f);
  stage_rows(s_lse, s_delta, p, q_base, q0);

  // Key blocks that a row of this block can see, on right-aligned
  // positions (as the forward kernels walk them).
  const int off = p.sk - p.sq;
  const int pos_lo = off + q0;
  const int pos_hi = off + min(q0 + kB, p.sq) - 1;
  int kb_hi = (p.sk + kB - 1) / kB - 1;
  if (p.causal) kb_hi = pos_hi < 0 ? -1 : min(kb_hi, pos_hi / kB);
  int kb_lo = 0;
  if (p.has_window) kb_lo = max(0, pos_lo - p.window + 1) / kB;

  const int r = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
  float dq[2][CPT];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int m = 0; m < CPT; ++m) dq[a][m] = 0.0f;

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();                    // the last tiles are consumed
    stage<T, DP>(s_k, k, k0, p.sk, p.d, 1.0f);
    stage<T, DP>(s_v, v, k0, p.sk, p.d, 1.0f);
    __syncthreads();
    tile_grads<DP, PS>(s_q, s_do, s_k, s_v, s_lse, s_delta, nullptr, s_ds,
                       q0, k0, p);
    __syncthreads();
    // dQ += dS K for rows 2r, 2r + 1
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      const float d0 = s_ds[(2 * r) * PS + j];
      const float d1 = s_ds[(2 * r + 1) * PS + j];
      const float* kr = s_k + j * S + c;
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const float x = kr[kLanes * m];
        dq[0][m] = fmaf(d0, x, dq[0][m]);
        dq[1][m] = fmaf(d1, x, dq[1][m]);
      }
    }
  }

  T* dq_out = static_cast<T*>(p.dq) + q_base * p.d;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = q0 + 2 * r + a;
    if (i >= p.sq) continue;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int col = c + kLanes * m;
      if (col < p.d)
        store(dq_out + static_cast<size_t>(i) * p.d + col,
              dq[a][m] * p.scale);
    }
  }
}

template <typename T, int DP>
int launch(const Params& p, int b, cudaStream_t stream) {
  static_assert(kThreads == (kB / 2) * kLanes, "two rows a thread");
  constexpr int smem_kv = dkdv_smem<DP>();
  constexpr int smem_q = dq_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attn::launch_delta<T>(p.o, p.dout, p.delta,
                             static_cast<size_t>(b) * p.hq * p.sq, p.d,
                             stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((p.sk + kB - 1) / kB, p.hq / p.g, b);
  dkdv_kernel<T, DP><<<grid_kv, kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((p.sq + kB - 1) / kB, p.hq, b);
  dq_kernel<T, DP><<<grid_q, kThreads, smem_q, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dp(const Params& p, int b, cudaStream_t stream) {
  if (p.d <= 16) return launch<T, 16>(p, b, stream);
  if (p.d <= 32) return launch<T, 32>(p, b, stream);
  if (p.d <= 64) return launch<T, 64>(p, b, stream);
  if (p.d <= 128) return launch<T, 128>(p, b, stream);
  return launch<T, 256>(p, b, stream);
}

}  // namespace

// Launch on `stream`: q, o, dout and dq (b, hq, sq, d); k, v, dk and dv
// (b, hkv, sk, d); lse and the scratch `delta` fp32 (b, hq, sq); all
// contiguous; `bf16` selects __nv_bfloat16 over float for every tensor
// but lse and delta.  Returns cudaGetLastError() (0 on success); a head
// dim outside 1..256 or hq not a multiple of hkv returns
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int hq, int hkv, int sq, int sk, int d, float scale,
    int causal, int has_window, int window, int bf16, void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0)
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
  const Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, hq, hq / hkv, sq,
                 sk, d, scale, causal, has_window, window};
  return bf16 ? launch_dp<__nv_bfloat16>(p, b, s) : launch_dp<float>(p, b, s);
}
