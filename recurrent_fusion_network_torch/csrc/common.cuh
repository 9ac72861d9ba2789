// Helpers shared by the hand-written kernels of csrc/: bf16 <-> f32 loads and
// stores (scalar and 16-byte), the tanh of each dtype, reductions over a team
// of warps, and the shared-memory ring that streams a row's key and value rows
// from device memory (mbarriers, 1-D bulk copies).
//
// The ring. A block has kWarps consumer warps and one producer warp. The
// consumer warps form R teams of W = kWarps / R warps; team t works on row
// blockIdx.x * R + t. Each team owns `stages` stage buffers of `stage_bytes`
// bytes and two mbarriers per stage: `full` (the producer's copy has landed)
// and `empty` (the team's W warps are done with it). The producer walks one
// stream per row: segment 0 (A rows of E0 elements, P0 of them per chunk),
// then segment 1 (A rows of E1 elements, P1 per chunk), chunk i going to stage
// i % stages. With kVec it issues one bulk copy per chunk
// (cp.async.bulk ... mbarrier::complete_tx::bytes: 16-byte aligned source and
// destination, a multiple of 16 bytes); without kVec its 32 lanes copy the
// chunk element by element (any width, any alignment). Because the stream
// does not stop between the segments, the second segment's first stages are
// in flight while the consumers still work on the first segment and the
// reduction between the two passes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rfnet {

constexpr int kWarps = 8;                   // consumer warps per block
constexpr int kThreads = kWarps * 32;       // consumer threads per block
constexpr int kBlock = kThreads + 32;       // plus one producer warp
constexpr int kMaxStages = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Elements of T in 16 bytes: the width of one vector access.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// tanh in f32. f32 keeps tanhf (the parity path, held to 1e-4). bf16 uses
// the hardware's tanh.approx.f32 (one MUFU op, max relative error about
// 2^-11, far below a bf16 ulp), since tanhf's ~20 instructions per element
// would make the bf16 key passes instruction-bound; both kernels call this
// one function, so the backward recomputes exactly the forward's tanh.
template <typename T> __device__ __forceinline__ float tanh_t(float x);
template <> __device__ __forceinline__ float tanh_t<float>(float x) { return tanhf(x); }
template <> __device__ __forceinline__ float tanh_t<__nv_bfloat16>(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void unpack(const uint4& u, float* x) {  // 4 f32
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack_bf16(const uint4& u, float* x) {  // 8 bf16
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// x[0 .. N) = row[e0 .. e0 + N) in f32. kVec: one 16-byte load (row + e0
// 16-byte aligned, e0 + N <= n); else element by element, 0 past n.
template <typename T, bool kVec>
__device__ __forceinline__ void load_vec(const T* row, int e0, int n, float* x) {
  constexpr int N = Vec<T>::N;
  if constexpr (kVec) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + e0);
    if constexpr (sizeof(T) == 4) unpack(u, x); else unpack_bf16(u, x);
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) x[t] = e0 + t < n ? to_f32(row[e0 + t]) : 0.f;
  }
}

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int pad8(int x) { return (x + 7) & ~7; }

// The f32 copies in shared memory of q, v and dz, which lanes read in
// groups of N = Vec<T>::N elements (lane l: elements 8l .. 8l + 7 in bf16).
// In bf16 a group is 32 bytes of f32, so a warp's float4 reads at a 32-byte
// stride would conflict two ways on the banks; the copy therefore keeps the
// first 4 floats of each group in one half of the array and the last 4 in
// the other (half = pad8(n) / 2 floats), and each float4 read is at a
// 16-byte stride. In f32 a group is one float4 and the layout is plain.
template <typename T>
__device__ __forceinline__ int f32_slot(int e, int n) {
  if constexpr (sizeof(T) == 4) {
    return e;
  } else {
    return ((e & 4) ? pad8(n) / 2 : 0) + ((e >> 3) << 2) + (e & 3);
  }
}

// x[0 .. N) = elements e0 .. e0 + N of such a copy of n floats; kVec: e0 a
// multiple of N and e0 + N <= n; else element by element, 0 past n.
template <typename T, bool kVec>
__device__ __forceinline__ void load_f32(const float* row, int e0, int n, float* x) {
  constexpr int N = Vec<T>::N;
  if constexpr (kVec) {
#pragma unroll
    for (int t = 0; t < N; t += 4) {
      const float4 f = *reinterpret_cast<const float4*>(row + f32_slot<T>(e0 + t, n));
      x[t] = f.x; x[t + 1] = f.y; x[t + 2] = f.z; x[t + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) x[t] = e0 + t < n ? row[f32_slot<T>(e0 + t, n)] : 0.f;
  }
}

// 8 f32 -> 8 bf16 in 16 bytes, rounded to nearest even.
__device__ __forceinline__ uint4 pack_bf16(const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// row[e0 .. e0 + N) = x in T: one 16-byte store with kVec, else element by
// element up to n.
template <typename T, bool kVec>
__device__ __forceinline__ void store_vec(T* row, int e0, int n, const float* x) {
  constexpr int N = Vec<T>::N;
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(row + e0) =
        sizeof(T) == 4 ? make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                                    __float_as_uint(x[2]), __float_as_uint(x[3]))
                       : pack_bf16(x);
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t)
      if (e0 + t < n) row[e0 + t] = from_f32<T>(x[t]);
  }
}

// row[e0 .. e0 + N) = x in f32, N = Vec<T>::N: float4 stores with kVec
// (row + e0 16-byte aligned), else element by element up to n.
template <typename T, bool kVec>
__device__ __forceinline__ void store_f32(float* row, int e0, int n, const float* x) {
  constexpr int N = Vec<T>::N;
  if constexpr (kVec) {
#pragma unroll
    for (int t = 0; t < N; t += 4)
      *reinterpret_cast<float4*>(row + e0 + t) = make_float4(x[t], x[t + 1], x[t + 2], x[t + 3]);
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t)
      if (e0 + t < n) row[e0 + t] = x[t];
  }
}

// dst (pad8(n) floats, 16-byte aligned) = the f32 copy of src[0 .. n) in
// the layout of f32_slot, spread over `threads` threads (tid the caller's
// index among them). 16-byte loads where src is 16-byte aligned and n a
// multiple of the vector width, else element by element; unrolled, so each
// thread keeps several loads in flight.
template <typename T>
__device__ __forceinline__ void load_row_f32(float* dst, const T* src, int n, int tid,
                                             int threads) {
  constexpr int N = Vec<T>::N;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n % N == 0) {
#pragma unroll 4
    for (int j = tid; j < n / N; j += threads) {
      float x[N];
      load_vec<T, true>(src, j * N, n, x);
#pragma unroll
      for (int t = 0; t < N; t += 4)
        *reinterpret_cast<float4*>(dst + f32_slot<T>(j * N + t, n)) =
            make_float4(x[t], x[t + 1], x[t + 2], x[t + 3]);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < n; e += threads) dst[f32_slot<T>(e, n)] = to_f32(src[e]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// Barrier over the `threads` consumer threads of one team (named barrier
// `id`; 0 is __syncthreads', so teams use 1 ..).
__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Max (kMax) or sum over the W warps of a team; every thread of the team
// gets the result. `red` holds W floats of the team. The leading barrier lets
// `red` be reused by back-to-back calls, and the order of the additions is
// fixed, so the result is the same on every run.
template <bool kMax>
__device__ float team_reduce(float x, float* red, int bar, int W) {
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(kFullMask, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int lane = threadIdx.x & 31;
  const int wt = (threadIdx.x >> 5) % W;
  team_sync(bar, W * 32);
  if (lane == 0) red[wt] = x;
  team_sync(bar, W * 32);
  x = red[0];
  for (int k = 1; k < W; ++k) x = kMax ? fmaxf(x, red[k]) : x + red[k];
  return x;
}

// ---- mbarriers and bulk copies (sm_90)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One 1-D bulk copy global -> shared that completes `bytes` on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The ring's view of dynamic shared memory: barriers first, then the stage
// buffers of every team, then each team's f32 area of `team_floats`.
struct Ring {
  uint64_t* bars;         // full[team][kMaxStages], then empty[team][kMaxStages]
  unsigned char* stages;  // team t, stage s at (t * n_stages + s) * stage_bytes
  float* floats;          // team t at t * team_floats
  int R, n_stages, stage_bytes;

  __device__ uint64_t* full(int t, int s) const { return bars + t * kMaxStages + s; }
  __device__ uint64_t* empty(int t, int s) const { return bars + (R + t) * kMaxStages + s; }
  template <typename T> __device__ const T* stage(int t, int s) const {
    return reinterpret_cast<const T*>(stages + static_cast<size_t>(t * n_stages + s) * stage_bytes);
  }
};

// Barriers of up to 8 teams: 2 * 8 * kMaxStages * 8 bytes = 512, a multiple
// of 128, so the stage buffers start 128-byte aligned.
constexpr int kRingHeader = 2 * 8 * kMaxStages * 8;

__device__ __forceinline__ Ring ring_layout(unsigned char* smem, int R, int n_stages,
                                            int stage_bytes) {
  Ring r;
  r.bars = reinterpret_cast<uint64_t*>(smem);
  r.stages = smem + kRingHeader;
  r.floats = reinterpret_cast<float*>(r.stages + static_cast<size_t>(R) * n_stages * stage_bytes);
  r.R = R;
  r.n_stages = n_stages;
  r.stage_bytes = stage_bytes;
  return r;
}

// Thread 0 initialises the barriers: full counts the producer's one arrival
// (plus the bytes of a bulk copy), empty the W warps of the team.
__device__ __forceinline__ void ring_init(const Ring& r, int W) {
  if (threadIdx.x == 0) {
    for (int t = 0; t < r.R; ++t)
      for (int s = 0; s < r.n_stages; ++s) {
        mbar_init(r.full(t, s), 1);
        mbar_init(r.empty(t, s), W);
      }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer warp: streams segment 0 then segment 1 of every active team's
// row (team t: row row0 + t, active while < rows) through the ring.
template <typename T, bool kVec>
__device__ void ring_produce(const Ring& r, int64_t row0, int64_t rows, int A,
                             const T* src0, int E0, int P0, const T* src1, int E1, int P1) {
  const int lane = threadIdx.x & 31;
  const int C0 = (A + P0 - 1) / P0;
  const int C = C0 + (A + P1 - 1) / P1;
  for (int i = 0; i < C; ++i) {
    const int s = i % r.n_stages;
    const uint32_t parity = ((i / r.n_stages) & 1) ^ 1;  // the first round passes
    const bool seg1 = i >= C0;
    const int E = seg1 ? E1 : E0;
    const int P = seg1 ? P1 : P0;
    const int a0 = (seg1 ? i - C0 : i) * P;
    const int count = min(P, A - a0) * E;
    for (int t = 0; t < r.R && row0 + t < rows; ++t) {
      const T* src = (seg1 ? src1 : src0) + ((row0 + t) * A + a0) * static_cast<int64_t>(E);
      T* dst = const_cast<T*>(r.stage<T>(t, s));
      if (lane == 0) mbar_wait(r.empty(t, s), parity);
      __syncwarp();
      if constexpr (kVec) {
        if (lane == 0) {
          const uint32_t bytes = static_cast<uint32_t>(count) * sizeof(T);
          mbar_arrive_expect_tx(r.full(t, s), bytes);
          bulk_copy_g2s(dst, src, bytes, r.full(t, s));
        }
      } else {
        for (int e = lane; e < count; e += 32) dst[e] = src[e];
        __syncwarp();  // orders the lanes' stores before lane 0's release
        if (lane == 0) mbar_arrive(r.full(t, s));
      }
    }
  }
}

}  // namespace rfnet
