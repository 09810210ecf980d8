// The first launch of both attention backward designs
// (flash_attention_bwd.cu and flash_attention_bwd_mma.cu):
// delta = rowsum(do * o) in fp32, one warp a row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {
namespace attn {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int kDeltaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads) delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, size_t rows, int d) {
  const size_t row = blockIdx.x * static_cast<size_t>(kDeltaThreads / 32)
                     + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;              // uniform over the warp
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Launch delta_kernel over `rows` rows of d elements on `stream`.
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         size_t rows, int d, cudaStream_t stream) {
  constexpr size_t kRowsPerBlock = kDeltaThreads / 32;
  delta_kernel<T><<<static_cast<unsigned>((rows + kRowsPerBlock - 1)
                                          / kRowsPerBlock),
                    kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
      d);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace
