// additive_attention_bwd: the gradient of the additive-attention read, written
// by hand for Hopper (sm_90a) and bound to Python through a plain C interface
// (ctypes). The forward is csrc/additive_attention.cu.
//
// Replaces on the TPU side: the gradient XLA derives for recurrent_fusion_
// network_tpu/ops/attention.py::attend under jax.value_and_grad in
// training/train_loop.py::make_train_step (the deleted Pallas kernel
// ops/pallas_kernels.py::fused_att_lstm_step had no gradient rule).
//
// For row n of head group g = n / N (rows = G * N), with e = tanh(keys + q)
// recomputed from the inputs and w the forward's softmax weights:
//   dw[a]        = sum_d dz[n,d] * values[n,a,d]  (+ the incoming grad of w)
//   ds[a]        = w[a] * (dw[a] - sum_a' w[a'] dw[a']), 0 where mask == 0
//   dkeys[n,a,h] = ds[a] * v[g,h] * (1 - e[a,h]^2)
//   dq[n,h]      = sum_a dkeys[n,a,h]
//   dvalues      = w[a] * dz[n,d]                  (only when asked for)
//   dv[g,h]      = sum over the group's rows and a of ds[a] * e[a,h]
//   dbv[g]       = sum over the group's rows and a of ds[a]
//
// What bounds it: bytes. A row reads A*H keys and A*D values and writes A*H
// dkeys (and A*D dvalues where they are needed), with a few operations per
// element, far below the card's operations-per-byte balance point.
//
// What the design does about it: one block per row, as in the forward. Each
// key and value element is read once, coalesced; each dkeys and dvalues
// element is written once. dz, w, ds, q and v live in shared memory and every
// sum accumulates in f32. dv and dbv, which sum over rows, are reduced in a
// second small kernel from per-row f32 partials in a fixed order (no float
// atomics), so two runs give bit-identical gradients.

#include <stdint.h>

#include "common.cuh"

namespace {

using rfnet::block_reduce;
using rfnet::from_f32;
using rfnet::kThreads;
using rfnet::kWarps;
using rfnet::to_f32;
using rfnet::warp_sum;

template <typename T>
__global__ void __launch_bounds__(kThreads)
additive_attention_bwd_rows(const T* __restrict__ dz, const T* __restrict__ dw_in,
                            const T* __restrict__ q, const T* __restrict__ keys,
                            const T* __restrict__ v, const T* __restrict__ values,
                            const T* __restrict__ w, const uint8_t* __restrict__ mask,
                            T* __restrict__ dq, T* __restrict__ dkeys,
                            T* __restrict__ dvalues, float* __restrict__ dv_part,
                            float* __restrict__ dbv_part, int N, int A, int H, int D) {
  extern __shared__ float smem[];
  float* dz_s = smem;       // D
  float* w_s = dz_s + D;    // A
  float* ds_s = w_s + A;    // A: dw, then ds
  float* q_s = ds_s + A;    // H
  float* v_s = q_s + H;     // H
  __shared__ float red[kWarps];

  const int64_t n = blockIdx.x;
  const int g = static_cast<int>(n / N);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int d = tid; d < D; d += kThreads) dz_s[d] = to_f32(dz[n * D + d]);
  for (int a = tid; a < A; a += kThreads) w_s[a] = to_f32(w[n * A + a]);
  for (int h = tid; h < H; h += kThreads) {
    q_s[h] = to_f32(q[n * H + h]);
    v_s[h] = to_f32(v[static_cast<int64_t>(g) * H + h]);
  }
  __syncthreads();

  // dw[a] = dz . values[n, a, :]: one warp per position a, lanes stride over
  // d (coalesced); dvalues[n, a, :] = w[a] * dz is written in the same pass
  const T* vn = values + n * A * D;
  T* dvn = dvalues == nullptr ? nullptr : dvalues + n * A * D;
  for (int a = warp; a < A; a += kWarps) {
    const T* va = vn + static_cast<int64_t>(a) * D;
    const float wa = w_s[a];
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) {
      acc += dz_s[d] * to_f32(va[d]);
      if (dvn != nullptr) dvn[static_cast<int64_t>(a) * D + d] = from_f32<T>(wa * dz_s[d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) ds_s[a] = acc + (dw_in == nullptr ? 0.f : to_f32(dw_in[n * A + a]));
  }
  __syncthreads();

  // softmax backward: ds = w * (dw - sum_a w dw), zero where masked
  float t = 0.f;
  for (int a = tid; a < A; a += kThreads) t += w_s[a] * ds_s[a];
  t = block_reduce<false>(t, red);
  const uint8_t* mn = mask == nullptr ? nullptr : mask + n * A;
  float bsum = 0.f;
  for (int a = tid; a < A; a += kThreads) {
    const float ds = (mn != nullptr && mn[a] == 0) ? 0.f : w_s[a] * (ds_s[a] - t);
    ds_s[a] = ds;
    bsum += ds;
  }
  bsum = block_reduce<false>(bsum, red);  // its barriers also publish ds_s

  // keys side: threads stride over h (coalesced), loop over a; dq and the
  // row's dv partial accumulate in registers in a fixed order
  const T* kn = keys + n * A * H;
  T* dkn = dkeys + n * A * H;
  for (int h = tid; h < H; h += kThreads) {
    const float qh = q_s[h];
    const float vh = v_s[h];
    float dqh = 0.f, dvh = 0.f;
    for (int a = 0; a < A; ++a) {
      const int64_t i = static_cast<int64_t>(a) * H + h;
      const float e = tanhf(to_f32(kn[i]) + qh);
      const float ds = ds_s[a];
      const float dpre = ds * vh * (1.f - e * e);
      dkn[i] = from_f32<T>(dpre);
      dqh += dpre;
      dvh += ds * e;
    }
    dq[n * H + h] = from_f32<T>(dqh);
    dv_part[n * H + h] = dvh;
  }
  if (tid == 0) dbv_part[n] = bsum;
}

// dv[g, h] and dbv[g]: sums of the per-row partials over the N rows of group
// g. Block (32, 8) per (g, 32 columns of h): the 8 row-strided partial sums
// are added in a fixed order.
template <typename T>
__global__ void __launch_bounds__(256)
additive_attention_bwd_groups(const float* __restrict__ dv_part,
                              const float* __restrict__ dbv_part, T* __restrict__ dv,
                              T* __restrict__ dbv, int N, int H) {
  __shared__ float part[8][33];
  const int g = blockIdx.x;
  const int x = threadIdx.x, y = threadIdx.y;
  const int h = blockIdx.y * 32 + x;
  const int64_t row0 = static_cast<int64_t>(g) * N;

  float acc = 0.f;
  if (h < H)
    for (int r = y; r < N; r += 8) acc += dv_part[(row0 + r) * H + h];
  part[y][x] = acc;
  __syncthreads();
  if (y == 0 && h < H) {
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += part[k][x];
    dv[static_cast<int64_t>(g) * H + h] = from_f32<T>(s);
  }
  if (blockIdx.y != 0) return;  // one block per group writes dbv
  __syncthreads();
  const int i = y * 32 + x;
  float b = 0.f;
  for (int r = i; r < N; r += 256) b += dbv_part[row0 + r];
  b = rfnet::warp_sum(b);
  if (x == 0) part[y][0] = b;
  __syncthreads();
  if (i == 0) {
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += part[k][0];
    dbv[g] = from_f32<T>(s);
  }
}

template <typename T>
void launch(const void* dz, const void* dw, const void* q, const void* keys,
            const void* v, const void* values, const void* w, const void* mask,
            void* dq, void* dkeys, void* dvalues, void* dv, void* dbv, float* dv_part,
            float* dbv_part, int rows, int N, int A, int H, int D, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(D) + 2 * A + 2 * H) * sizeof(float);
  additive_attention_bwd_rows<T><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(dz), static_cast<const T*>(dw), static_cast<const T*>(q),
      static_cast<const T*>(keys), static_cast<const T*>(v),
      static_cast<const T*>(values), static_cast<const T*>(w),
      static_cast<const uint8_t*>(mask), static_cast<T*>(dq), static_cast<T*>(dkeys),
      static_cast<T*>(dvalues), dv_part, dbv_part, N, A, H, D);
  const dim3 grid(rows / N, (H + 31) / 32);
  additive_attention_bwd_groups<T><<<grid, dim3(32, 8), 0, stream>>>(
      dv_part, dbv_part, static_cast<T*>(dv), static_cast<T*>(dbv), N, H);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dw (the incoming grad of w), mask and
// dvalues may be null. dv_part (rows, H) and dbv_part (rows,) are f32 scratch.
// Returns cudaGetLastError() after the launches (0 = cudaSuccess); the Python
// wrapper raises on anything else.
extern "C" int additive_attention_bwd(const void* dz, const void* dw, const void* q,
                                      const void* keys, const void* v,
                                      const void* values, const void* w,
                                      const void* mask, void* dq, void* dkeys,
                                      void* dvalues, void* dv, void* dbv,
                                      void* dv_part, void* dbv_part, int rows, int N,
                                      int A, int H, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dvp = static_cast<float*>(dv_part);
  float* dbp = static_cast<float*>(dbv_part);
  if (dtype == 0) {
    launch<float>(dz, dw, q, keys, v, values, w, mask, dq, dkeys, dvalues, dv, dbv, dvp,
                  dbp, rows, N, A, H, D, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(dz, dw, q, keys, v, values, w, mask, dq, dkeys, dvalues, dv,
                          dbv, dvp, dbp, rows, N, A, H, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
