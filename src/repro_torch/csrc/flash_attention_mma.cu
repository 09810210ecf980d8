// Blocked online-softmax GQA attention on the H100's tensor cores
// (mma.sync m16n8k8 in TF32) for fp32 inputs at head dims 64, 128 and
// 256, with the row log-sum-exp on request.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel) for those calls; it is the fp32
// design of kernels/flash_attention.py (`_design`), beside the bf16
// tensor-core design (flash_attention_wgmma.cu) and the FMA design
// (flash_attention.cu) for every other call.  Its contract is the FMA
// design's: q is (b, hq, sq, d), k and v are (b, hkv, sk, d), hq % hkv ==
// 0, all fp32; query head h reads KV head h / (hq / hkv).  Query row i
// sits at key position sk - sq + i; key j is visible to row i iff
// j <= pos(i) (causal) and j > pos(i) - window (sliding window).  q is
// multiplied by `scale` in fp32 before the product; scores, the running
// max m, the normaliser l and the output accumulator are fp32; masked
// scores are -inf; p = 0 while the running max is still -inf and
// alpha = 0 where the previous max was -inf; the output is
// acc / max(l, 1e-30), so a row with no visible key gives 0.  Given a
// non-null `lse` (fp32, (b, hq, sq)) the kernel also writes each row's
// m + log(l) (-inf for a row with no visible key), which the backward
// reads; with a null pointer nothing else changes.
//
// What bounds it: operations.  4 d FLOP per visible (query, key) pair and
// query head: at the training path's shape (b, hq, hkv, s, d) =
// (2, 4, 1, 2048, 256) that is 17.2 GFLOP causal and 7.5 GFLOP with
// window 512, 0.257 / 0.112 ms in fp32 FMA at 67 TFLOP/s, against 42 MB of
// inputs and outputs (0.013 ms at 3.35 TB/s).  On the tensor cores with
// the split below (three TF32 products a product) the bound is
// 0.104 / 0.046 ms at 495 TFLOP/s.
//
// The fp32 contract on TF32 tensor cores (tf32_split.cuh, as in the
// backward): each fp32 operand x is split into hi (x rounded to TF32) and
// lo = x - hi, and a product is lo*hi + hi*lo + hi*hi, three mma.sync a
// fragment accumulated in fp32.  S = (q scale) K^T splits q and k; O =
// P V splits P (a computed fp32 value) and v.  mma.sync and not wgmma:
// wgmma takes TF32 operands only K-major, which suits S but not P V
// without a transposed copy of each V tile.
//
// Design: one block of 8 warps a (query tile of kBQ = 64 rows, query
// head, batch row), in the order of a host-built list that puts the
// query tiles with the most visible key blocks first
// (kernels/flash_attention.py::fwd_tile_order), so that the last wave on
// the 132 SMs is not the longest.  The block walks the key blocks of
// kBK = 64 keys that are not wholly in the future (causal) or wholly
// stale (window); the others are never loaded, which keeps the
// sliding-window layers O(s * window).  The scaled q tile stays in shared
// memory; K and V tiles are staged fp32 by cp.async, each into one
// buffer, so that V of a key block loads while S is computed and K of the
// next block loads while P V is (no room for two buffers at d = 256:
// q, K, V and P take 219 KB of the 227 KB, one block an SM).  Warp w
// owns query rows 16 (w % 4) .. + 15; the pair w, w + 4 splits the key
// block for S (32 keys each, both row maxima exchanged through shared
// memory, each warp keeping the partial normaliser of its own keys) and
// the head dim for P V (d / 2 columns each, P read back from shared
// memory).  Each key block's P V accumulates into zeroed fragments and is
// folded into the running output with an fp32 alpha * O + block, so no
// tensor-core accumulation chain is longer than one key block (a long
// chain drifts from fp32 sums rounded to nearest: the backward's dK
// 3e-5 relative over 64 tiles).  exp is __expf (ex2.approx of x log2 e,
// as the bf16 design's): expf took 5 % longer at the training path's
// global call, and the outputs stay within 6e-6 of the plain version
// (scripts/flash_attention_variants.py --design mma).  No atomics: every
// sum has a fixed order, so a call is deterministic.
//
// Fragment layouts as in flash_attention_bwd_mma.cu (PTX ISA,
// mma.m16n8k8 .tf32; g = lane / 4, t = lane % 4).  S's operands load with
// ldmatrix (an 8 x 8 b16 matrix is an 8 x 4 fp32 one).  P V permutes its
// k index (the key) within each 8-chunk (t -> 2t, t + 4 -> 2t + 1), which
// is free since the sum runs over it: P's A fragment is then a float2 of
// the row, and V's B fragment the rows 2t and 2t + 1.  Row strides:
// SP = d + 4 floats for q, K and V (16 B mod 128: ldmatrix rows and the
// (2t, g) scalar loads of V are free of bank conflicts), kPS = kBK + 8 for
// P (8 mod 32: its float2 stores and loads are).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_split.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows a block
constexpr int kBK = 64;                 // keys a key block
constexpr int kSplit = 2;               // warps that share a row group
constexpr int kWarps = 4 * kSplit;
constexpr int kThreads = kWarps * 32;
constexpr int kPS = kBK + 8;            // P row stride

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;                           // (b, hq, sq) or null
  const int* order;                     // tiles in launch order
  int bhq, hq, g, sq, sk;
  float scale;
  int causal, has_window, window;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start copying rows [r0, r0 + kBK) of a (n, D) fp32 matrix into smem
// with row stride D + 4, zeros past n; one commit group.
template <int D>
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int r0, int n) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < kBK * C4; i += kThreads) {
    const int r = i / C4, c = (i - r * C4) * 4;
    const int row = r0 + r;
    const bool ok = row < n;
    cp_async16(dst + r * (D + 4) + c,
               src + static_cast<size_t>(ok ? row : 0) * D + c, ok);
  }
  cp_async_commit();
}

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float))
         * (kBQ * (D + 4) + 2 * kBK * (D + 4) + kBQ * kPS
            + 2 * kSplit * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(Params p) {
  constexpr int SP = D + 4;
  constexpr int NS = kBK / kSplit / 8;  // n8 tiles of a warp's S keys
  constexpr int NT = D / kSplit / 8;    // n8 tiles of its P V columns
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                    // kBQ x SP, q * scale
  float* s_k = s_q + kBQ * SP;          // kBK x SP
  float* s_v = s_k + kBK * SP;          // kBK x SP
  float* s_p = s_v + kBK * SP;          // kBQ x kPS, P [row][key]
  float* s_red = s_p + kBQ * kPS;       // 2 x kSplit x kBQ: maxima, l

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tg = lane % 4;
  const int wr = warp % 4, wc = warp / 4;
  const int m0 = 16 * wr;               // the warp's rows
  const int n0 = (kBK / kSplit) * wc;   // its keys of S
  const int c0 = (D / kSplit) * wc;     // its columns of P V

  const int tile = p.order[blockIdx.x];
  const int qt = tile / p.bhq, bh = tile - qt * p.bhq;
  const int bb = bh / p.hq, h = bh - bb * p.hq;
  const int hkv = p.hq / p.g;
  const int q0 = qt * kBQ;
  const size_t q_base = static_cast<size_t>(bh) * p.sq;
  const size_t kv_base = (static_cast<size_t>(bb) * hkv + h / p.g) * p.sk;
  const float* q = p.q + q_base * D;
  const float* k = p.k + kv_base * D;
  const float* v = p.v + kv_base * D;

  // key blocks not wholly hidden from the tile's rows
  const int offset = p.sk - p.sq;
  const int rows = min(kBQ, p.sq - q0);
  const int pos_lo = offset + q0, pos_hi = offset + q0 + rows - 1;
  int kb_hi = (p.sk + kBK - 1) / kBK - 1;
  if (p.causal) kb_hi = pos_hi < 0 ? -1 : min(kb_hi, pos_hi / kBK);
  const int kb_lo = p.has_window ? max(0, pos_lo - p.window + 1) / kBK : 0;

  if (kb_lo <= kb_hi) stage_async<D>(s_k, k, kb_lo * kBK, p.sk);
  {
    constexpr int C4 = D / 4;
    for (int i = threadIdx.x; i < kBQ * C4; i += kThreads) {
      const int r = i / C4, c = (i - r * C4) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows) {
        x = *reinterpret_cast<const float4*>(
            q + static_cast<size_t>(q0 + r) * D + c);
        x.x *= p.scale; x.y *= p.scale; x.z *= p.scale; x.w *= p.scale;
      }
      *reinterpret_cast<float4*>(s_q + r * SP + c) = x;
    }
  }

  // rows m0 + gr + 8 * half of the thread's fragments
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * kBK;
    cp_async_wait<0>();                 // K of this block
    __syncthreads();                    // ... for every thread; s_v, s_p free
    stage_async<D>(s_v, v, k0, p.sk);

    // S = (q scale) K^T: the warp's 16 rows x kBK / kSplit keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    {
      const int ar = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int ac = (lane >> 4) * 4;
      const int br = n0 + (lane & 7);
      const int bc = (lane >> 3) * 4;
#pragma unroll 4
      for (int e = 0; e < D; e += 16) {
        Frag<4> fa[2];
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          uint32_t ra[4];
          ldmatrix_x4(ra, s_q + ar * SP + e + 8 * h8 + ac);
          split<true>(fa[h8], ra);
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          uint32_t rb[4];
          ldmatrix_x4(rb, s_k + (br + 8 * n) * SP + e + bc);
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {
            const uint32_t b2[2] = {rb[2 * h8], rb[2 * h8 + 1]};
            Frag<2> fb;
            split<true>(fb, b2);
            mma_split<true, true>(s[n], fa[h8], fb);
          }
        }
      }
    }

    // masks, then the row maxima over the whole key block
    const bool whole = q0 + kBQ <= p.sq && k0 + kBK <= p.sk
        && (!p.causal || k0 + kBK - 1 <= pos_lo)
        && (!p.has_window || k0 > offset + q0 + kBQ - 1 - p.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        if (!whole && !visible(q0 + m0 + gr + 8 * half,
                               k0 + n0 + 8 * n + 2 * tg + (e & 1), p))
          s[n][e] = -INFINITY;
        mx[half] = fmaxf(mx[half], s[n][e]);
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      if (tg == 0) s_red[wc * kBQ + m0 + gr + 8 * half] = mx[half];
    }
    __syncthreads();
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + gr + 8 * half;
      float m_cur = m[half];
#pragma unroll
      for (int w = 0; w < kSplit; ++w)
        m_cur = fmaxf(m_cur, s_red[w * kBQ + row]);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * half + c];
          x = m_cur == -INFINITY ? 0.0f : __expf(x - m_cur);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[half] = m[half] == -INFINITY ? 0.0f : __expf(m[half] - m_cur);
      l[half] = l[half] * alpha[half] + sum;
      m[half] = m_cur;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        *reinterpret_cast<float2*>(s_p + row * kPS + n0 + 8 * n + 2 * tg) =
            make_float2(s[n][2 * half], s[n][2 * half + 1]);
    }
    cp_async_wait<0>();                 // V of this block
    __syncthreads();                    // V and P whole; s_k free
    if (kb < kb_hi) stage_async<D>(s_k, k, k0 + kBK, p.sk);

    // this block's P V into zeroed fragments: its 16 rows x d / kSplit
    float part[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < kBK; kc += 8) {
      const float2 p0 = *reinterpret_cast<const float2*>(
          s_p + (m0 + gr) * kPS + kc + 2 * tg);
      const float2 p1 = *reinterpret_cast<const float2*>(
          s_p + (m0 + gr + 8) * kPS + kc + 2 * tg);
      const uint32_t ap[4] = {__float_as_uint(p0.x), __float_as_uint(p1.x),
                              __float_as_uint(p0.y), __float_as_uint(p1.y)};
      Frag<4> fp;
      split<true>(fp, ap);
      const float* vr = s_v + (kc + 2 * tg) * SP + c0 + gr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t b2[2] = {__float_as_uint(vr[8 * n]),
                                __float_as_uint(vr[SP + 8 * n])};
        Frag<2> fv;
        split<true>(fv, b2);
        mma_split<true, true>(part[n], fp, fv);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(alpha[e / 2], o[n][e], part[n][e]);
  }

  // l = the warps' partial normalisers, in a fixed order
  float* s_l = s_red + kSplit * kBQ;
#pragma unroll
  for (int half = 0; half < 2; ++half)
    if (tg == 0) s_l[wc * kBQ + m0 + gr + 8 * half] = l[half];
  __syncthreads();
  float* out = p.out + q_base * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gr + 8 * half;
    if (r >= rows) continue;
    float lt = s_l[r];
#pragma unroll
    for (int w = 1; w < kSplit; ++w) lt += s_l[w * kBQ + r];
    if (p.lse != nullptr && wc == 0 && tg == 0)
      p.lse[q_base + q0 + r] =
          m[half] == -INFINITY ? -INFINITY : m[half] + logf(lt);
    const float inv_den = 1.0f / fmaxf(lt, 1e-30f);
    float* orow = out + static_cast<size_t>(q0 + r) * D + c0 + 2 * tg;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * half] * inv_den, o[n][2 * half + 1] * inv_den);
  }
}

template <int D>
int launch(const Params& p, int tiles, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  auto kernel = fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int blocks_per_sm() {
  constexpr int smem = smem_bytes<D>();
  auto kernel = fwd_kernel<D>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// The tile sizes, which kernels/flash_attention.py's tile order assumes,
// and the warps that split a row group's keys (a row's partial
// normalisers, summed in warp order).
extern "C" int flash_attention_mma_block_rows() { return kBQ; }
extern "C" int flash_attention_mma_block_keys() { return kBK; }
extern "C" int flash_attention_mma_key_splits() { return kSplit; }

// Blocks an SM holds at head dim d (64, 128 or 256), -1 on an error.
extern "C" int flash_attention_mma_blocks_per_sm(int d) {
  switch (d) {
    case 64: return blocks_per_sm<64>();
    case 128: return blocks_per_sm<128>();
    case 256: return blocks_per_sm<256>();
    default: return -1;
  }
}

// Launch on `stream`: q, k, v and out fp32, 16-byte aligned; `lse` (fp32
// (b, hq, sq)) may be null; `order` (int32, b * hq * ceil(sq / 64)
// entries, on the device) lists every tile (query tile * b * hq +
// batch * hq + head) once.  Returns cudaGetLastError() (0 on success); a
// head dim other than 64, 128 and 256 returns cudaErrorInvalidValue.
extern "C" int flash_attention_mma_launch(
    const float* q, const float* k, const float* v, float* out, float* lse,
    const int* order, int b, int hq, int hkv, int sq, int sk, int d,
    float scale, int causal, int has_window, int window, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || (d != 64 && d != 128 && d != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || hq == 0 || sq == 0) return 0;
  const Params p{q, k, v, out, lse, order, b * hq, hq, hq / hkv, sq, sk,
                 scale, causal, has_window, window};
  const int tiles = b * hq * ((sq + kBQ - 1) / kBQ);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(p, tiles, s);
    case 128: return launch<128>(p, tiles, s);
    default: return launch<256>(p, tiles, s);
  }
}
