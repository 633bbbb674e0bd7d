// Paged expert-tile GEMVs of one MoE decode step: the routed experts'
// weights are read as fixed row-tile pages of the expert pool through
// the page ids the block table resolved.
//
// Replaces the TPU kernels src/repro/kernels/moe_dispatch.py
// moe_paged_gateup (_gateup_kernel) and moe_paged_down (_down_kernel).
// Plain versions: repro_torch/kernels/moe_dispatch.py::
// moe_paged_gateup_plain / moe_paged_down_plain.
//
//   pool   f32|bf16 [P, TF, D]   row-tile pages (page 0 = zeros)
//   pids   int32 [R, K, NT]      physical page ids, in tile order
//   gate/up:  x [R, D]           -> out [R, K, NT*TF]
//             out[r,k,t*TF+i] = sum_d x[r,d] * pool[pids[r,k,t], i, d]
//   down:     h [R, K, NT*TF]    -> out [R, K, D]
//             out[r,k,d] = sum_{t,i} h[r,k,t*TF+i] * pool[pids[r,k,t], i, d]
//
// What bounds it on the H100: bytes.  Each (row, expert) pair reads
// NT pages of TF x D weights once and does two flops per weight, far
// below the card's ~295 flops per byte; x, h and the outputs are tiny.
// At qwen3-moe's decode shapes (R=8, K=8, TF=32, D=4096, NT=48) one call
// reads up to 64 x 48 pages of 256 KiB, 805 MB.  So the design is about
// keeping enough 16-byte loads in flight, coalesced along D:
//
// * gate/up: one block per (r, k, t) page.  The block loads its own
//   page id (the TPU kernel scalar-prefetched them), its 8 warps split
//   the page's TF rows four at a time, every lane reads 16 bytes of each
//   of its four rows per step (four independent loads in flight), and a
//   row's float32 sum is reduced along D with warp shuffles.  x[r] is
//   read through L1 next to the rows, so the kernel has no shared memory
//   and no barrier.
// * down: the contraction runs over the paged dimension, which the TPU
//   kernel carried in VMEM from one sequential grid step to the next.
//   Here one block per (r, k, slice of D) loops over all NT pages
//   itself: warp w takes rows w, w+8, ... of each page, each lane owns
//   16 bytes of the slice and accumulates in float32 registers, and the
//   8 warps' partial sums are added in a fixed order through shared
//   memory.  Every output element is written once, with no atomics, so
//   results do not depend on the order blocks run in.
//
// This first version is simple: no cp.async or TMA pipeline, no tensor
// cores (a GEMV has nothing for them), and rows that several (r, k)
// pairs route to the same expert read its pages again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // gate/up: rows a warp streams together

// Load V consecutive elements as float32: one 16-byte load when V fills
// 16 bytes, element by element when V == 1.
template <typename T, int V>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float* out) {
    out[0] = to_f32(p[0]);
  }
};

template <>
struct Vec<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b2[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gateup_kernel(const int32_t* __restrict__ pids, const T* __restrict__ x,
              const T* __restrict__ pool, T* __restrict__ out, int K, int NT,
              int TF, int D) {
  const int rkt = blockIdx.x;  // (r * K + k) * NT + t
  const int r = rkt / (K * NT);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* page = pool + static_cast<size_t>(pids[rkt]) * TF * D;
  const T* xr = x + static_cast<size_t>(r) * D;
  T* o = out + static_cast<size_t>(rkt) * TF;
  const int nvec = D / V;
  for (int i0 = warp * kRows; i0 < TF; i0 += kWarps * kRows) {
    const int nr = min(kRows, TF - i0);
    float acc[kRows] = {};
    for (int c = lane; c < nvec; c += 32) {
      float xv[V];
      Vec<T, V>::load(xr + c * V, xv);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j < nr) {
          float wv[V];
          Vec<T, V>::load(page + static_cast<size_t>(i0 + j) * D + c * V,
                          wv);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[j] = fmaf(xv[e], wv[e], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float s = warp_sum(acc[j]);
      if (lane == 0 && j < nr) o[i0 + j] = from_f32<T>(s);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
down_kernel(const int32_t* __restrict__ pids, const T* __restrict__ h,
            const T* __restrict__ pool, T* __restrict__ out, int NT, int TF,
            int D) {
  __shared__ float part[kWarps][32 * V];
  const int rk = blockIdx.x;  // r * K + k
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = blockIdx.y * 32 * V + lane * V;  // this lane's columns
  const bool live = d0 < D;
  const int32_t* pid_rk = pids + static_cast<size_t>(rk) * NT;
  const T* h_rk = h + static_cast<size_t>(rk) * NT * TF;
  float acc[V] = {};
  if (live) {
    for (int t = 0; t < NT; ++t) {
      const T* page = pool + static_cast<size_t>(pid_rk[t]) * TF * D + d0;
      const T* ht = h_rk + t * TF;
#pragma unroll 4
      for (int i = warp; i < TF; i += kWarps) {
        const float hv = to_f32(ht[i]);
        float wv[V];
        Vec<T, V>::load(page + static_cast<size_t>(i) * D, wv);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(hv, wv[e], acc[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) part[warp][lane * V + e] = acc[e];
  __syncthreads();
  // the warps' partial sums, added in warp order
  for (int c = threadIdx.x; c < 32 * V; c += kThreads) {
    const int d = blockIdx.y * 32 * V + c;
    if (d < D) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][c];
      out[static_cast<size_t>(rk) * D + d] = from_f32<T>(s);
    }
  }
}

template <typename T, int V>
cudaError_t launch_gateup(const void* pids, const void* x, const void* pool,
                          void* out, int R, int K, int NT, int TF, int D,
                          cudaStream_t stream) {
  gateup_kernel<T, V><<<R * K * NT, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(pids), static_cast<const T*>(x),
      static_cast<const T*>(pool), static_cast<T*>(out), K, NT, TF, D);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_down(const void* pids, const void* h, const void* pool,
                        void* out, int R, int K, int NT, int TF, int D,
                        cudaStream_t stream) {
  const dim3 grid(R * K, (D + 32 * V - 1) / (32 * V));
  down_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(pids), static_cast<const T*>(h),
      static_cast<const T*>(pool), static_cast<T*>(out), NT, TF, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x or h, pool and out share it).
// vec: 1 when D fills whole 16-byte vectors and every pointer is
// 16-byte aligned, else 0 (element-wise loads).
extern "C" int moe_paged_gateup(const void* pids, const void* x,
                                const void* pool, void* out, int R, int K,
                                int NT, int TF, int D, int dtype, int vec,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_gateup<float, 4>(pids, x, pool, out, R, K, NT, TF, D,
                                         s)
               : launch_gateup<float, 1>(pids, x, pool, out, R, K, NT, TF, D,
                                         s);
  return vec ? launch_gateup<__nv_bfloat16, 8>(pids, x, pool, out, R, K, NT,
                                               TF, D, s)
             : launch_gateup<__nv_bfloat16, 1>(pids, x, pool, out, R, K, NT,
                                               TF, D, s);
}

extern "C" int moe_paged_down(const void* pids, const void* h,
                              const void* pool, void* out, int R, int K,
                              int NT, int TF, int D, int dtype, int vec,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_down<float, 4>(pids, h, pool, out, R, K, NT, TF, D, s)
               : launch_down<float, 1>(pids, h, pool, out, R, K, NT, TF, D,
                                       s);
  return vec ? launch_down<__nv_bfloat16, 8>(pids, h, pool, out, R, K, NT, TF,
                                             D, s)
             : launch_down<__nv_bfloat16, 1>(pids, h, pool, out, R, K, NT, TF,
                                             D, s);
}
