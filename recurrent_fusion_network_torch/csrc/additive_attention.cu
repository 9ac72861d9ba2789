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
// What the design does about it (common.cuh describes the ring):
//  - A producer warp streams the row's A key rows, then its A value rows,
//    through a ring of shared-memory stages with 1-D bulk copies completing on
//    mbarriers: about 32 KB in flight per block, several blocks per SM. The
//    value stages are in flight while the consumers finish the keys and the
//    softmax, so the values pass does not start cold.
//  - Consumers read the stages 16 bytes a lane (8 bf16 or 4 f32) and write z
//    16 bytes a lane. Keys pass: one warp per position, lanes over h, a warp
//    shuffle for the score. Values pass: each thread keeps up to 16 f32 sums
//    of z over its 16-byte groups of d and loops over the positions.
//  - R rows per block (R = 4 when A <= 8: stage II and the decoder), each
//    row a team of 8 / R warps with its own named barrier and ring stages.
//    A block may straddle a head-group boundary; each team reads its own
//    row's v[g] and bv[g].
//  - kVec = false is the kernel's scalar path, for widths that are not a
//    multiple of 16 bytes or keys / values not 16-byte aligned: the producer
//    copies element by element and the consumers read and write scalars.
//  - tanh: tanhf in f32; tanh.approx.f32 in bf16 (common.cuh::tanh_t).
//  - Sums accumulate in f32; z and w are written in the input dtype.

#include <stdint.h>

#include "common.cuh"

namespace {

using rfnet::from_f32;
using rfnet::kBlock;
using rfnet::kThreads;
using rfnet::kWarps;
using rfnet::load_f32;
using rfnet::load_vec;
using rfnet::mbar_arrive;
using rfnet::mbar_wait;
using rfnet::pad4;
using rfnet::pad8;
using rfnet::Ring;
using rfnet::store_vec;
using rfnet::tanh_t;
using rfnet::team_reduce;
using rfnet::team_sync;
using rfnet::to_f32;
using rfnet::Vec;
using rfnet::warp_sum;

constexpr float kNegInf = -1e9f;  // ops/attention.py NEG_INF
constexpr int kAccFloats = 16;    // f32 sums of z per thread (D <= 16 * threads)

template <typename T, bool kVec>
__global__ void __launch_bounds__(kBlock, 4)  // 4 blocks per SM: 512 rows in one wave
additive_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ keys,
                              const T* __restrict__ v, const T* __restrict__ bv,
                              const T* __restrict__ values,
                              const uint8_t* __restrict__ mask,
                              T* __restrict__ z, T* __restrict__ w, int64_t rows,
                              int N, int A, int H, int D, int R, int n_stages,
                              int stage_bytes) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring ring = rfnet::ring_layout(smem, R, n_stages, stage_bytes);
  const int W = kWarps / R;  // warps per row
  const int TT = W * 32;     // threads per row
  rfnet::ring_init(ring, W);

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int Pk = stage_bytes / (H * static_cast<int>(sizeof(T)));  // key rows per stage
  const int Pv = stage_bytes / (D * static_cast<int>(sizeof(T)));  // value rows per stage
  const int warp = threadIdx.x >> 5;
  if (warp == kWarps) {
    rfnet::ring_produce<T, kVec>(ring, row0, rows, A, keys, H, Pk, values, D, Pv);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int team = warp / W;
  const int wt = warp % W;
  const int ttid = threadIdx.x % TT;
  const int bar = 1 + team;
  const int64_t n = row0 + team;
  if (n >= rows) return;
  const int g = static_cast<int>(n / N);

  float* q_s = ring.floats + team * (2 * pad8(H) + pad4(A) + kWarps);  // common.cuh f32_slot
  float* v_s = q_s + pad8(H);
  float* p_s = v_s + pad8(H);  // A: scores, then softmax weights
  float* red = p_s + pad4(A);  // W
  rfnet::load_row_f32(q_s, q + n * H, H, ttid, TT);
  rfnet::load_row_f32(v_s, v + static_cast<int64_t>(g) * H, H, ttid, TT);
  team_sync(bar, TT);

  // keys pass: one warp per position a, lanes over 16-byte groups of h
  const float b = to_f32(bv[g]);
  const uint8_t* mn = mask == nullptr ? nullptr : mask + n * A;
  const int Ck = (A + Pk - 1) / Pk;
  int i = 0;  // chunk of the row's stream
  for (int c = 0; c < Ck; ++c, ++i) {
    const int s = i % n_stages;
    mbar_wait(ring.full(team, s), (i / n_stages) & 1);
    const T* st = ring.stage<T>(team, s);
    const int a0 = c * Pk;
    const int np = min(Pk, A - a0);
    // positions a = wt, wt + W, ... of the row, whichever stage holds them:
    // the warps spread over the stages in flight
    for (int p = (wt - a0 % W + W) % W; p < np; p += W) {
      const T* kr = st + p * H;
      float acc = 0.f;
      for (int h0 = lane * V; h0 < H; h0 += 32 * V) {
        float x[V], qh[V], vh[V];
        load_vec<T, kVec>(kr, h0, H, x);
        load_f32<T, kVec>(q_s, h0, H, qh);
        load_f32<T, kVec>(v_s, h0, H, vh);
#pragma unroll
        for (int t = 0; t < V; ++t)
          if (kVec || h0 + t < H) acc += tanh_t<T>(x[t] + qh[t]) * vh[t];
      }
      acc = warp_sum(acc);
      const int a = a0 + p;
      if (lane == 0) p_s[a] = (mn != nullptr && mn[a] == 0) ? kNegInf : acc + b;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(team, s));
  }
  team_sync(bar, TT);

  // softmax over a, in f32
  float m = -INFINITY;
  for (int a = ttid; a < A; a += TT) m = fmaxf(m, p_s[a]);
  m = team_reduce<true>(m, red, bar, W);
  float sum = 0.f;
  for (int a = ttid; a < A; a += TT) {
    const float e = expf(p_s[a] - m);
    p_s[a] = e;
    sum += e;
  }
  sum = team_reduce<false>(sum, red, bar, W);
  const float inv = 1.f / sum;
  T* wn = w + n * A;
  for (int a = ttid; a < A; a += TT) {
    const float p = p_s[a] * inv;
    p_s[a] = p;
    wn[a] = from_f32<T>(p);
  }
  team_sync(bar, TT);

  // values pass: each thread sums z over its 16-byte groups of d
  // (j = ttid + k * TT), looping over the positions of each stage
  constexpr int KD = kAccFloats / V;
  const int Gd = (D + V - 1) / V;
  float acc[kAccFloats];
#pragma unroll
  for (int e = 0; e < kAccFloats; ++e) acc[e] = 0.f;
  const int Cv = (A + Pv - 1) / Pv;
  for (int c = 0; c < Cv; ++c, ++i) {
    const int s = i % n_stages;
    mbar_wait(ring.full(team, s), (i / n_stages) & 1);
    const T* st = ring.stage<T>(team, s);
    const int a0 = c * Pv;
    const int np = min(Pv, A - a0);
    for (int p = 0; p < np; ++p) {
      const float pa = p_s[a0 + p];
      const T* vr = st + p * D;
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const int j = ttid + k * TT;
        if (j < Gd) {
          float x[V];
          load_vec<T, kVec>(vr, j * V, D, x);
#pragma unroll
          for (int t = 0; t < V; ++t) acc[k * V + t] += pa * x[t];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(team, s));
  }
  T* zn = z + n * D;
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    const int j = ttid + k * TT;
    if (j < Gd) store_vec<T, kVec>(zn, j * V, D, acc + k * V);
  }
}

template <typename T, bool kVec>
int launch(const void* q, const void* keys, const void* v, const void* bv,
           const void* values, const void* mask, void* z, void* w, int rows, int N,
           int A, int H, int D, int R, int n_stages, int stage_bytes, int smem,
           cudaStream_t stream) {
  auto kernel = additive_attention_fwd_kernel<T, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (rows + R - 1) / R;
  kernel<<<blocks, kBlock, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(keys), static_cast<const T*>(v),
      static_cast<const T*>(bv), static_cast<const T*>(values),
      static_cast<const uint8_t*>(mask), static_cast<T*>(z), static_cast<T*>(w), rows, N, A,
      H, D, R, n_stages, stage_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null. vec: 1 when keys and
// values are 16-byte aligned and H, D are multiples of 16 bytes' elements
// (the bulk-copy path), else 0 (the scalar path). R (rows per block),
// n_stages, stage_bytes and smem (dynamic shared bytes) come from the
// wrapper's plan (kernels/additive_attention.py::_plan). Returns the CUDA
// error of the launch (0 = cudaSuccess); the Python wrapper raises on
// anything else.
extern "C" int additive_attention_fwd(const void* q, const void* keys, const void* v,
                                      const void* bv, const void* values,
                                      const void* mask, void* z, void* w, int rows,
                                      int N, int A, int H, int D, int dtype, int vec,
                                      int R, int n_stages, int stage_bytes, int smem,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the plan's invariants: a stage holds a whole key and value row, and a
  // row's threads hold its sums of z
  const int vw = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  const int esize = dtype == 0 ? 4 : 2;
  const int threads = rfnet::kThreads / (R > 0 ? R : 1);
  if (R < 1 || rfnet::kWarps % R != 0 || n_stages < 1 || n_stages > rfnet::kMaxStages ||
      (D + vw - 1) / vw > threads * (kAccFloats / vw) || stage_bytes % 16 != 0 ||
      stage_bytes < H * esize || stage_bytes < D * esize)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return vec ? launch<float, true>(q, keys, v, bv, values, mask, z, w, rows, N, A, H, D, R,
                                     n_stages, stage_bytes, smem, s)
               : launch<float, false>(q, keys, v, bv, values, mask, z, w, rows, N, A, H, D,
                                      R, n_stages, stage_bytes, smem, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, true>(q, keys, v, bv, values, mask, z, w, rows, N, A,
                                             H, D, R, n_stages, stage_bytes, smem, s)
               : launch<__nv_bfloat16, false>(q, keys, v, bv, values, mask, z, w, rows, N,
                                              A, H, D, R, n_stages, stage_bytes, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
