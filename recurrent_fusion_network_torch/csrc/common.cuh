// Helpers shared by the hand-written kernels of csrc/: bf16 <-> f32 loads and
// stores, and a block-wide reduction.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rfnet {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// Block-wide max (kMax) or sum over kThreads threads; every thread gets the
// result. The leading barrier lets `red` be reused by back-to-back calls. The
// order of the additions is fixed, so the result is the same on every run.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(kFullMask, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < kWarps ? red[lane] : (kMax ? -INFINITY : 0.f);
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(kFullMask, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

}  // namespace rfnet
