// Split-TF32 tensor-core products and fragment loads shared by the
// attention kernels on mma.sync m16n8k8 (flash_attention_mma.cu, the
// forward, and flash_attention_bwd_mma.cu, the backward): the fp32
// operand split into two TF32 terms, the three-term product, ldmatrix of
// fp32 rows, and the masks' visibility rule.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A fragment or B fragment: hi terms, and lo terms when split.
template <int N>
struct Frag {
  uint32_t hi[N];
  uint32_t lo[N];
};

// Split raw fp32 values (as bits) into hi and lo TF32 terms; a value that
// is exact in TF32 (a bf16 input) keeps its bits as hi and needs no lo.
// hi is x rounded to nearest, ties away from zero, at 10 explicit mantissa
// bits (cvt.rna.tf32.f32's result for finite x, in two integer operations
// where cvt takes four with its inf / NaN checks); lo = x - hi is exact in
// fp32, and the tensor core reads its top 19 bits (ref.tf32_split models
// both).  The split is most of the kernels' non-tensor instructions: with
// cvt for both terms the backward took 1.35x as long at the training
// path's global call.
template <bool Split, int N>
__device__ __forceinline__ void split(Frag<N>& f, const uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (Split) {
      f.hi[i] = (x[i] + 0x1000u) & 0xffffe000u;
      f.lo[i] = __float_as_uint(__uint_as_float(x[i])
                                - __uint_as_float(f.hi[i]));
    } else {
      f.hi[i] = x[i];
    }
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with the split terms: the small ones first.
template <bool SplitA, bool SplitB>
__device__ __forceinline__ void mma_split(float (&c)[4], const Frag<4>& a,
                                          const Frag<2>& b) {
  if (SplitA) mma(c, a.lo, b.hi[0], b.hi[1]);
  if (SplitB) mma(c, a.hi, b.lo[0], b.lo[1]);
  mma(c, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Whether key j is visible to query row i (right-aligned positions: row i
// sits at key position sk - sq + i); p has sq, sk, causal, has_window and
// window.
template <typename P>
__device__ __forceinline__ bool visible(int i, int j, const P& p) {
  if (i >= p.sq || j >= p.sk) return false;
  const int qpos = i + p.sk - p.sq;
  if (p.causal && j > qpos) return false;
  if (p.has_window && j <= qpos - p.window) return false;
  return true;
}

}  // namespace
