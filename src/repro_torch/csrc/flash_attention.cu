// Blocked online-softmax attention with GQA, causal and sliding-window
// masks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel).  q is (b, hq, sq, d), k and v are
// (b, hkv, sk, d), hq % hkv == 0, all fp32 or all bf16; query head h reads
// KV head h / (hq / hkv).  Positions are right-aligned: query row i sits
// at key position sk - sq + i (prefill after a cached prefix).  Key j is
// visible to row i iff j <= pos(i) (causal) and j > pos(i) - window
// (sliding window).  As in the Pallas kernel, q is cast to fp32 and
// multiplied by `scale` before the product; scores, the running max m,
// the normaliser l and the output accumulator are fp32; masked scores are
// -inf; p = 0 while the running max is still -inf and alpha = 0 where the
// previous max was -inf; the output is acc / max(l, 1e-30) in q's type.
// A row with no visible key therefore gives 0, as the Pallas kernel does,
// where the plain version (ref.mha_ref, a softmax over -inf) gives NaN;
// the callers' shapes (sq <= sk, causal) have no such row.  Given a
// non-null `lse` (fp32, (b, hq, sq)), the kernel also writes each row's
// log-sum-exp of the scaled, masked scores, m + log(l) (-inf for a row
// with no visible key), which flash_attention_bwd.cu reads; with a null
// pointer nothing else changes.
//
// What bounds it on the H100: operations.  At the LM path's shape
// (b, hq, hkv, s, d) = (64, 4, 1, 2048, 256) in bf16 it moves 0.40 GB
// (0.12 ms at 3.35 TB/s) for 4 d FLOP per visible (query, key) pair: 0.55
// TFLOP causal, 0.24 TFLOP with window 512, 0.56 ms and 0.24 ms at the
// card's 989 TFLOP/s bf16 dense tensor-core rate.  This design runs fp32
// FMA outside the tensor cores (67 TFLOP/s), so it cannot come nearer
// than about 15x that bound.  It serves fp32 and bf16 at head dims other
// than 64, 128 and 256; at those, bf16 runs on the tensor cores in
// flash_attention_wgmma.cu and fp32 in flash_attention_mma.cu
// (kernels/flash_attention.py::_design picks).
//
// Design: one block of 256 threads per (q block of BQ rows, query head,
// batch row), looping over the key blocks of BK keys that are not wholly
// in the future (causal) or wholly stale (window): the others are never
// loaded, which makes the sliding-window layers O(s * window).  The
// scaled q tile and each K and V tile are staged in shared memory as
// fp32, zero padded to DP columns (DP the head dim rounded up to a power
// of two, 16 to 512).  Thread (rg, cl) = (tid / 16, tid % 16) owns rows
// rg * RPT .. + RPT - 1 and, of the score tile, keys cl + 16 c; the 16
// lanes that share a row group are one half-warp, so the row max and sum
// reduce through shuffles and P passes through shared memory with only a
// warp barrier.  For P @ V the same thread owns columns cl + 16 q of its
// rows, RPT x DP / 16 accumulators in registers (64 at d = 256).  The
// staged rows have a stride of DP + 4 floats, so the float4 reads of the
// score loop are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;              // threads that share a row group

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;                           // (b, hq, sq) or null
  int hq, g, sq, sk, d;
  float scale;
  int causal, has_window, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage rows [r0, r0 + rows) of a (n, d) matrix into smem as fp32 with
// row stride `stride`, times `mul`, zero outside n x d.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, int stride,
                                      const T* __restrict__ src, int r0,
                                      int rows, int n, int d, float mul) {
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    const int row = r0 + r;
    dst[r * stride + c] = row < n && c < d
        ? to_f32(src[static_cast<size_t>(row) * d + c]) * mul : 0.0f;
  }
}

template <int N>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(Params p) {
  constexpr int RPT = BQ / kLanes;      // rows per thread
  constexpr int KPT = BK / kLanes;      // keys per thread (score tile)
  constexpr int CPT = DP / kLanes;      // output columns per thread
  constexpr int QS = DP + 4;            // staged q / k row stride
  constexpr int PS = BQ + 4;            // staged P row stride (P is BK x BQ)
  static_assert(kThreads == (BQ / RPT) * kLanes, "row groups");

  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                    // BQ x QS
  float* s_k = s_q + BQ * QS;           // BK x QS
  float* s_v = s_k + BK * QS;           // BK x DP
  float* s_p = s_v + BK * DP;           // BK x PS

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hkv = p.hq / p.g;
  const int kvh = h / p.g;
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
  const int row0 = qb * BQ;
  const size_t q_base = (static_cast<size_t>(b) * p.hq + h) * p.sq;
  const size_t kv_base = (static_cast<size_t>(b) * hkv + kvh) * p.sk;
  const T* q = static_cast<const T*>(p.q) + q_base * p.d;
  const T* k = static_cast<const T*>(p.k) + kv_base * p.d;
  const T* v = static_cast<const T*>(p.v) + kv_base * p.d;
  T* out = static_cast<T*>(p.out) + q_base * p.d;

  // Key positions of this block's first and last real rows.
  const int offset = p.sk - p.sq;
  const int pos_lo = offset + row0;
  const int pos_hi = offset + min(row0 + BQ, p.sq) - 1;
  const int nkb = (p.sk + BK - 1) / BK;
  int kb_hi = nkb - 1;
  if (p.causal) kb_hi = pos_hi < 0 ? -1 : min(kb_hi, pos_hi / BK);
  int kb_lo = 0;
  if (p.has_window) kb_lo = max(0, pos_lo - p.window + 1) / BK;

  stage<T, DP>(s_q, QS, q, row0, BQ, p.sq, p.d, p.scale);

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                    // the last tile is fully consumed
    stage<T, DP>(s_k, QS, k, k0, BK, p.sk, p.d, 1.0f);
    stage<T, DP>(s_v, DP, v, k0, BK, p.sk, p.d, 1.0f);
    __syncthreads();

    // Scores of rows rg * RPT + i against keys cl + 16 c.
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < KPT; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int e = 0; e < DP; e += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            s_q + (rg * RPT + i) * QS + e);
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        kv[c] = *reinterpret_cast<const float4*>(
            s_k + (cl + kLanes * c) * QS + e);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }

    // Mask, online softmax, P into shared memory (keys x rows).
    float alpha[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = offset + row0 + rg * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const int kpos = k0 + cl + kLanes * c;
        bool ok = kpos < p.sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.has_window) ok = ok && kpos > qpos - p.window;
        if (!ok) s[i][c] = -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_cur = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        s[i][c] = m_cur == -INFINITY ? 0.0f : expf(s[i][c] - m_cur);
        sum += s[i][c];
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      alpha[i] = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_cur);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_cur;
    }
#pragma unroll
    for (int c = 0; c < KPT; ++c)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        s_p[(cl + kLanes * c) * PS + rg * RPT + i] = s[i][c];
    __syncwarp();                       // P rows come from this half-warp

    // acc = acc * alpha + P @ V over this tile's keys.
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha[i];
    // keys past sk have p = 0 and zero-staged V rows
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
      load_rows<RPT>(s_p + j * PS + rg * RPT, pv);
      const float* vr = s_v + j * DP + cl;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float x = vr[kLanes * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], x, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + rg * RPT + i;
    if (row >= p.sq) continue;
    const float inv_den = 1.0f / fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && cl == 0)    // m and l agree across the lanes
      p.lse[q_base + row] = m[i] == -INFINITY ? -INFINITY : m[i] + logf(l[i]);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = cl + kLanes * c;
      if (col < p.d)
        store(out + static_cast<size_t>(row) * p.d + col,
              acc[i][c] * inv_den);
    }
  }
}

template <int DP, int BQ, int BK>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float))
         * (BQ * (DP + 4) + BK * (DP + 4) + BK * DP + BK * (BQ + 4));
}

template <typename T, int DP>
int launch(const Params& p, int b, cudaStream_t stream) {
  // Up to d = 256 a block takes 64 rows and 64 keys; at 512, 32 and 32,
  // so that the accumulators stay 64 registers and the tiles fit.
  constexpr int BQ = DP <= 256 ? 64 : 32;
  constexpr int BK = BQ;
  constexpr int smem = smem_bytes<DP, BQ, BK>();
  auto kernel = flash_attention_kernel<T, DP, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, p.hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dp(const Params& p, int b, cudaStream_t stream) {
  if (p.d <= 16) return launch<T, 16>(p, b, stream);
  if (p.d <= 32) return launch<T, 32>(p, b, stream);
  if (p.d <= 64) return launch<T, 64>(p, b, stream);
  if (p.d <= 128) return launch<T, 128>(p, b, stream);
  if (p.d <= 256) return launch<T, 256>(p, b, stream);
  return launch<T, 512>(p, b, stream);
}

}  // namespace

// Largest head dim the kernel takes.
extern "C" int flash_attention_max_head_dim() { return 512; }

// Launch on `stream`; `bf16` selects __nv_bfloat16 over float for q, k, v
// and out; `lse` (fp32 (b, hq, sq)) may be null.  Returns
// cudaGetLastError() (0 on success); an unsupported head dim returns
// cudaErrorInvalidValue.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int b, int hq, int hkv, int sq, int sk, int d, float scale, int causal,
    int has_window, int window, int bf16, void* stream) {
  if (d < 1 || d > 512 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || hq == 0 || sq == 0) return 0;
  Params p{q, k, v, out, lse, hq, hq / hkv, sq, sk, d, scale, causal,
           has_window, window};
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dp<__nv_bfloat16>(p, b, s) : launch_dp<float>(p, b, s);
}
