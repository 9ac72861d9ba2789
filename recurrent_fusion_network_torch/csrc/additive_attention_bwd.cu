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
// What the design does about it (common.cuh describes the ring):
//  - A producer warp streams the row's A value rows, then its A key rows,
//    through a ring of shared-memory stages with 1-D bulk copies completing on
//    mbarriers. The first key stages are in flight while the consumers finish
//    the values pass and the softmax-backward reductions, so the keys pass
//    does not start cold.
//  - Values pass: one warp per position, lanes over 16-byte groups of d:
//    dw by a warp shuffle, dvalues = w * dz written 16 bytes a lane.
//  - Keys pass: each thread owns fixed 16-byte groups of h (its f32 sums of
//    dq and of the row's dv partial in registers) and a lane of positions;
//    dkeys is written 16 bytes a lane. The position lanes' sums are added
//    through shared memory in a fixed order.
//  - R rows per block (R = 4 when A <= 8: stage II and the decoder), each
//    row a team of 8 / R warps with its own named barrier and ring stages; a
//    block may straddle a head-group boundary (each team reads its own v[g]).
//  - kVec = false is the kernel's scalar path, for widths that are not a
//    multiple of 16 bytes or keys / values not 16-byte aligned.
//  - tanh: common.cuh::tanh_t, the forward's (tanh.approx.f32 in bf16).
//  - dv and dbv, which sum over rows, are reduced in a second small kernel
//    from per-row f32 partials in a fixed order (no float atomics), so two
//    runs give bit-identical gradients.

#include <stdint.h>

#include "common.cuh"

namespace {

using rfnet::from_f32;
using rfnet::kBlock;
using rfnet::kWarps;
using rfnet::load_f32;
using rfnet::load_vec;
using rfnet::mbar_arrive;
using rfnet::mbar_wait;
using rfnet::pad4;
using rfnet::pad8;
using rfnet::Ring;
using rfnet::store_f32;
using rfnet::store_vec;
using rfnet::tanh_t;
using rfnet::team_reduce;
using rfnet::team_sync;
using rfnet::to_f32;
using rfnet::Vec;
using rfnet::warp_sum;

constexpr int kKeyAcc = 8;  // f32 sums of dq (and of dv) per thread (H <= 8 * threads)

template <typename T, bool kVec>
__global__ void __launch_bounds__(kBlock, 4)  // 4 blocks per SM: 512 rows in one wave
additive_attention_bwd_rows(const T* __restrict__ dz, const T* __restrict__ dw_in,
                            const T* __restrict__ q, const T* __restrict__ keys,
                            const T* __restrict__ v, const T* __restrict__ values,
                            const T* __restrict__ w, const uint8_t* __restrict__ mask,
                            T* __restrict__ dq, T* __restrict__ dkeys,
                            T* __restrict__ dvalues, float* __restrict__ dv_part,
                            float* __restrict__ dbv_part, int64_t rows, int N, int A,
                            int H, int D, int R, int n_stages, int stage_bytes) {
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
    rfnet::ring_produce<T, kVec>(ring, row0, rows, A, values, D, Pv, keys, H, Pk);
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

  // dz_s, q_s, v_s: f32 copies in the layout of common.cuh f32_slot
  float* dz_s = ring.floats + team * (pad8(D) + 2 * pad8(H) + 2 * pad4(A) + kWarps);
  float* q_s = dz_s + pad8(D);
  float* v_s = q_s + pad8(H);
  float* w_s = v_s + pad8(H);
  float* ds_s = w_s + pad4(A);  // A: dw, then ds
  float* red = ds_s + pad4(A);  // W
  rfnet::load_row_f32(dz_s, dz + n * D, D, ttid, TT);
  for (int a = ttid; a < A; a += TT) w_s[a] = to_f32(w[n * A + a]);
  rfnet::load_row_f32(q_s, q + n * H, H, ttid, TT);
  rfnet::load_row_f32(v_s, v + static_cast<int64_t>(g) * H, H, ttid, TT);
  team_sync(bar, TT);

  // values pass: dw[a] = dz . values[n, a, :], one warp per position, lanes
  // over 16-byte groups of d; dvalues[n, a, :] = w[a] * dz in the same pass
  T* dvn = dvalues == nullptr ? nullptr : dvalues + n * A * D;
  const int Cv = (A + Pv - 1) / Pv;
  int i = 0;  // chunk of the row's stream
  for (int c = 0; c < Cv; ++c, ++i) {
    const int s = i % n_stages;
    mbar_wait(ring.full(team, s), (i / n_stages) & 1);
    const T* st = ring.stage<T>(team, s);
    const int a0 = c * Pv;
    const int np = min(Pv, A - a0);
    // positions a = wt, wt + W, ... of the row, whichever stage holds them:
    // the warps spread over the stages in flight
    for (int p = (wt - a0 % W + W) % W; p < np; p += W) {
      const int a = a0 + p;
      const T* vr = st + p * D;
      const float wa = w_s[a];
      float acc = 0.f;
      for (int d0 = lane * V; d0 < D; d0 += 32 * V) {
        float x[V], dzv[V];
        load_vec<T, kVec>(vr, d0, D, x);
        load_f32<T, kVec>(dz_s, d0, D, dzv);
#pragma unroll
        for (int t = 0; t < V; ++t) acc += dzv[t] * x[t];
        if (dvn != nullptr) {
#pragma unroll
          for (int t = 0; t < V; ++t) dzv[t] *= wa;
          store_vec<T, kVec>(dvn + static_cast<int64_t>(a) * D, d0, D, dzv);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) ds_s[a] = acc + (dw_in == nullptr ? 0.f : to_f32(dw_in[n * A + a]));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(team, s));
  }
  team_sync(bar, TT);

  // softmax backward: ds = w * (dw - sum_a w dw), zero where masked
  float t = 0.f;
  for (int a = ttid; a < A; a += TT) t += w_s[a] * ds_s[a];
  t = team_reduce<false>(t, red, bar, W);
  const uint8_t* mn = mask == nullptr ? nullptr : mask + n * A;
  float bsum = 0.f;
  for (int a = ttid; a < A; a += TT) {
    const float ds = (mn != nullptr && mn[a] == 0) ? 0.f : w_s[a] * (ds_s[a] - t);
    ds_s[a] = ds;
    bsum += ds;
  }
  bsum = team_reduce<false>(bsum, red, bar, W);  // its barriers also publish ds_s

  // keys pass: thread ttid owns the 16-byte groups j = j0 + k * span of h and
  // the positions a = pl, pl + PL, ... of the row
  constexpr int KH = kKeyAcc / V;
  const int Gh = (H + V - 1) / V;
  const int span = min(Gh, TT);
  const int PL = TT / span;
  const int pl = ttid / span;
  const int j0 = ttid % span;
  float dqa[kKeyAcc], dva[kKeyAcc];
#pragma unroll
  for (int e = 0; e < kKeyAcc; ++e) dqa[e] = dva[e] = 0.f;
  T* dkn = dkeys + n * A * H;
  const int Ck = (A + Pk - 1) / Pk;
  for (int c = 0; c < Ck; ++c, ++i) {
    const int s = i % n_stages;
    mbar_wait(ring.full(team, s), (i / n_stages) & 1);
    const T* st = ring.stage<T>(team, s);
    const int a0 = c * Pk;
    const int np = min(Pk, A - a0);
    if (pl < PL) {
      for (int p = (pl - a0 % PL + PL) % PL; p < np; p += PL) {
        const int a = a0 + p;
        const float ds = ds_s[a];
        const T* kr = st + p * H;
        T* dkr = dkn + static_cast<int64_t>(a) * H;
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          const int j = j0 + k * span;
          if (j < Gh) {
            float x[V], qh[V], vh[V];
            load_vec<T, kVec>(kr, j * V, H, x);
            load_f32<T, kVec>(q_s, j * V, H, qh);
            load_f32<T, kVec>(v_s, j * V, H, vh);
#pragma unroll
            for (int u = 0; u < V; ++u) {
              const float e = tanh_t<T>(x[u] + qh[u]);
              const float dpre = ds * vh[u] * (1.f - e * e);
              x[u] = dpre;
              dqa[k * V + u] += dpre;
              dva[k * V + u] += ds * e;
            }
            store_vec<T, kVec>(dkr, j * V, H, x);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(team, s));
  }

  // dq and the row's dv partial: the PL position lanes' sums added in a
  // fixed order through the team's (now idle) stage buffers
  T* dqn = dq + n * H;
  float* dvp = dv_part + n * H;
  if (PL > 1) {  // span == Gh <= TT: one group per thread
    float* part = reinterpret_cast<float*>(const_cast<T*>(ring.stage<T>(team, 0)));
    team_sync(bar, TT);  // every warp of the team is done with the stages
    if (pl < PL) {
#pragma unroll
      for (int u = 0; u < V; ++u) {  // lanes at consecutive words: no bank conflicts
        part[(u * PL + pl) * span + j0] = dqa[u];
        part[((V + u) * PL + pl) * span + j0] = dva[u];
      }
    }
    team_sync(bar, TT);
    if (ttid < Gh) {
      float sq[V], sv[V];
#pragma unroll
      for (int u = 0; u < V; ++u) sq[u] = sv[u] = 0.f;
      for (int l = 0; l < PL; ++l)
#pragma unroll
        for (int u = 0; u < V; ++u) {
          sq[u] += part[(u * PL + l) * span + ttid];
          sv[u] += part[((V + u) * PL + l) * span + ttid];
        }
      store_vec<T, kVec>(dqn, ttid * V, H, sq);
      store_f32<T, kVec>(dvp, ttid * V, H, sv);
    }
  } else {
#pragma unroll
    for (int k = 0; k < KH; ++k) {
      const int j = j0 + k * span;
      if (j < Gh) {
        store_vec<T, kVec>(dqn, j * V, H, dqa + k * V);
        store_f32<T, kVec>(dvp, j * V, H, dva + k * V);
      }
    }
  }
  if (ttid == 0) dbv_part[n] = bsum;
}

// dv[g, h] and dbv[g]: sums of the per-row partials over the N rows of group
// g. Block (32, 32) per (g, 32 columns of h): thread (x, y) adds rows y,
// y + 32, ... (unrolled, so its loads are in flight together), then the 32
// partial sums are added in a fixed order.
template <typename T>
__global__ void __launch_bounds__(1024)
additive_attention_bwd_groups(const float* __restrict__ dv_part,
                              const float* __restrict__ dbv_part, T* __restrict__ dv,
                              T* __restrict__ dbv, int N, int H) {
  __shared__ float part[32][33];
  const int g = blockIdx.x;
  const int x = threadIdx.x, y = threadIdx.y;
  const int h = blockIdx.y * 32 + x;
  const int64_t row0 = static_cast<int64_t>(g) * N;

  float acc = 0.f;
  if (h < H) {
#pragma unroll 8
    for (int r = y; r < N; r += 32) acc += dv_part[(row0 + r) * H + h];
  }
  part[y][x] = acc;
  __syncthreads();
  if (y == 0 && h < H) {
    float s = 0.f;
    for (int k = 0; k < 32; ++k) s += part[k][x];
    dv[static_cast<int64_t>(g) * H + h] = from_f32<T>(s);
  }
  if (blockIdx.y != 0) return;  // one block per group writes dbv
  __syncthreads();
  const int i = y * 32 + x;
  float b = 0.f;
  for (int r = i; r < N; r += 1024) b += dbv_part[row0 + r];
  b = warp_sum(b);
  if (x == 0) part[y][0] = b;
  __syncthreads();
  if (i == 0) {
    float s = 0.f;
    for (int k = 0; k < 32; ++k) s += part[k][0];
    dbv[g] = from_f32<T>(s);
  }
}

template <typename T, bool kVec>
int launch(const void* dz, const void* dw, const void* q, const void* keys, const void* v,
           const void* values, const void* w, const void* mask, void* dq, void* dkeys,
           void* dvalues, void* dv, void* dbv, float* dv_part, float* dbv_part, int rows,
           int N, int A, int H, int D, int R, int n_stages, int stage_bytes, int smem,
           cudaStream_t stream) {
  auto kernel = additive_attention_bwd_rows<T, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(rows + R - 1) / R, kBlock, smem, stream>>>(
      static_cast<const T*>(dz), static_cast<const T*>(dw), static_cast<const T*>(q),
      static_cast<const T*>(keys), static_cast<const T*>(v),
      static_cast<const T*>(values), static_cast<const T*>(w),
      static_cast<const uint8_t*>(mask), static_cast<T*>(dq), static_cast<T*>(dkeys),
      static_cast<T*>(dvalues), dv_part, dbv_part, rows, N, A, H, D, R, n_stages,
      stage_bytes);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(rows / N, (H + 31) / 32);
  additive_attention_bwd_groups<T><<<grid, dim3(32, 32), 0, stream>>>(
      dv_part, dbv_part, static_cast<T*>(dv), static_cast<T*>(dbv), N, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(int vec, const void* dz, const void* dw, const void* q, const void* keys,
                 const void* v, const void* values, const void* w, const void* mask,
                 void* dq, void* dkeys, void* dvalues, void* dv, void* dbv, float* dv_part,
                 float* dbv_part, int rows, int N, int A, int H, int D, int R, int n_stages,
                 int stage_bytes, int smem, cudaStream_t stream) {
  return vec ? launch<T, true>(dz, dw, q, keys, v, values, w, mask, dq, dkeys, dvalues, dv,
                               dbv, dv_part, dbv_part, rows, N, A, H, D, R, n_stages,
                               stage_bytes, smem, stream)
             : launch<T, false>(dz, dw, q, keys, v, values, w, mask, dq, dkeys, dvalues, dv,
                                dbv, dv_part, dbv_part, rows, N, A, H, D, R, n_stages,
                                stage_bytes, smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dw (the incoming grad of w), mask and
// dvalues may be null. dv_part (rows, H) and dbv_part (rows,) are f32 scratch.
// vec, R, n_stages, stage_bytes and smem as for additive_attention_fwd (the
// wrapper's plan). Returns the CUDA error of the launches (0 = cudaSuccess);
// the Python wrapper raises on anything else.
extern "C" int additive_attention_bwd(const void* dz, const void* dw, const void* q,
                                      const void* keys, const void* v,
                                      const void* values, const void* w,
                                      const void* mask, void* dq, void* dkeys,
                                      void* dvalues, void* dv, void* dbv,
                                      void* dv_part, void* dbv_part, int rows, int N,
                                      int A, int H, int D, int dtype, int vec, int R,
                                      int n_stages, int stage_bytes, int smem,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dvp = static_cast<float*>(dv_part);
  float* dbp = static_cast<float*>(dbv_part);
  // the plan's invariants: a stage holds a whole key and value row, a row's
  // threads hold its sums of dq and dv, and its stages their last reduction
  const int vw = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  const int esize = dtype == 0 ? 4 : 2;
  const int threads = rfnet::kThreads / (R > 0 ? R : 1);
  if (R < 1 || kWarps % R != 0 || n_stages < 1 || n_stages > rfnet::kMaxStages ||
      (H + vw - 1) / vw > threads * (kKeyAcc / vw) || stage_bytes % 16 != 0 ||
      stage_bytes < H * esize || stage_bytes < D * esize ||
      n_stages * stage_bytes < 2 * threads * vw * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dtype<float>(vec, dz, dw, q, keys, v, values, w, mask, dq, dkeys, dvalues,
                               dv, dbv, dvp, dbp, rows, N, A, H, D, R, n_stages, stage_bytes,
                               smem, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(vec, dz, dw, q, keys, v, values, w, mask, dq, dkeys,
                                       dvalues, dv, dbv, dvp, dbp, rows, N, A, H, D, R,
                                       n_stages, stage_bytes, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
