// additive_attention_fwd: the additive-attention read, written by hand for
// Hopper (sm_90a) and bound to Python through a plain C interface (ctypes).
//
// Replaces on the TPU side: recurrent_fusion_network_tpu/ops/attention.py::
// attend (the XLA-fused jnp read every RFNet cell runs) and the attention
// half of the Pallas kernel ops/pallas_kernels.py::fused_att_lstm_step that
// the JAX package deleted in e397367.
//
// For row n of head group g = n / N (rows = G * N):
//   s[a]   = sum_h tanh(keys[n,a,h] + q[n,h]) * v[g,h] + bv[g]
//   s[a]   = NEG_INF where mask[n,a] == 0          (only when a mask is given)
//   w[n,:] = softmax_a(s)
//   z[n,:] = sum_a w[n,a] * values[n,a,:]
//
// What bounds it: bytes. A row reads A*H keys and A*D values once and does
// about 4 operations per key element and 2 per value element, far below the
// card's operations-per-byte balance point, so the floor is
// (|keys| + |values|) / HBM bandwidth.
//
// What the design does about it: one block per row, and every key and value
// element is read from device memory exactly once, coalesced (neighbouring
// threads on neighbouring h or d). q, v, the scores and the softmax weights
// live in shared memory; all sums accumulate in f32 and only z and w are
// written back, in the input dtype. Vectorised 16-byte loads, several rows
// per block and TMA pipelining are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

using rfnet::block_reduce;
using rfnet::from_f32;
using rfnet::kFullMask;
using rfnet::kThreads;
using rfnet::kWarps;
using rfnet::to_f32;

constexpr float kNegInf = -1e9f;  // ops/attention.py NEG_INF

template <typename T>
__global__ void __launch_bounds__(kThreads)
additive_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ keys,
                              const T* __restrict__ v, const T* __restrict__ bv,
                              const T* __restrict__ values,
                              const uint8_t* __restrict__ mask,
                              T* __restrict__ z, T* __restrict__ w,
                              int N, int A, int H, int D) {
  extern __shared__ float smem[];
  float* q_s = smem;     // H
  float* v_s = q_s + H;  // H
  float* p_s = v_s + H;  // A: scores, then softmax weights
  __shared__ float red[kWarps];

  const int64_t n = blockIdx.x;
  const int g = static_cast<int>(n / N);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qn = q + n * H;
  const T* vg = v + static_cast<int64_t>(g) * H;
  for (int h = tid; h < H; h += kThreads) {
    q_s[h] = to_f32(qn[h]);
    v_s[h] = to_f32(vg[h]);
  }
  __syncthreads();

  // scores: one warp per position a, lanes stride over h (coalesced)
  const float b = to_f32(bv[g]);
  const T* kn = keys + n * A * H;
  const uint8_t* mn = mask == nullptr ? nullptr : mask + n * A;
  for (int a = warp; a < A; a += kWarps) {
    const T* ka = kn + static_cast<int64_t>(a) * H;
    float acc = 0.f;
    for (int h = lane; h < H; h += 32) acc += tanhf(to_f32(ka[h]) + q_s[h]) * v_s[h];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
    if (lane == 0) p_s[a] = (mn != nullptr && mn[a] == 0) ? kNegInf : acc + b;
  }
  __syncthreads();

  // softmax over a, in f32
  float m = -INFINITY;
  for (int a = tid; a < A; a += kThreads) m = fmaxf(m, p_s[a]);
  m = block_reduce<true>(m, red);
  float sum = 0.f;
  for (int a = tid; a < A; a += kThreads) {
    const float e = expf(p_s[a] - m);
    p_s[a] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  const float inv = 1.f / sum;
  T* wn = w + n * A;
  for (int a = tid; a < A; a += kThreads) {
    const float p = p_s[a] * inv;
    p_s[a] = p;
    wn[a] = from_f32<T>(p);
  }
  __syncthreads();

  // context: threads stride over d (coalesced), loop over a
  const T* vn = values + n * A * D;
  T* zn = z + n * D;
  for (int d = tid; d < D; d += kThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int a = 0; a < A; ++a) acc += p_s[a] * to_f32(vn[static_cast<int64_t>(a) * D + d]);
    zn[d] = from_f32<T>(acc);
  }
}

template <typename T>
void launch(const void* q, const void* keys, const void* v, const void* bv,
            const void* values, const void* mask, void* z, void* w, int rows,
            int N, int A, int H, int D, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(H) + A) * sizeof(float);
  additive_attention_fwd_kernel<T><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(keys), static_cast<const T*>(v),
      static_cast<const T*>(bv), static_cast<const T*>(values),
      static_cast<const uint8_t*>(mask), static_cast<T*>(z), static_cast<T*>(w), N, A,
      H, D);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null. Returns cudaGetLastError()
// after the launch (0 = cudaSuccess); the Python wrapper raises on anything else.
extern "C" int additive_attention_fwd(const void* q, const void* keys, const void* v,
                                      const void* bv, const void* values,
                                      const void* mask, void* z, void* w, int rows,
                                      int N, int A, int H, int D, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(q, keys, v, bv, values, mask, z, w, rows, N, A, H, D, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, keys, v, bv, values, mask, z, w, rows, N, A, H, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
