// The MoE expert GEMMs: the capacity dispatch's grouped GEMM
// (moe_dispatch_matmul) and the paged expert-tile GEMVs of one decode
// step (moe_paged_gateup, moe_paged_down).
//
// Replaces the TPU kernels src/repro/kernels/moe_dispatch.py
// moe_dispatch_matmul (_moe_kernel), moe_paged_gateup (_gateup_kernel)
// and moe_paged_down (_down_kernel).  Plain versions:
// repro_torch/kernels/moe_dispatch.py::moe_dispatch_matmul_plain,
// moe_paged_gateup_plain and moe_paged_down_plain.
//
// == moe_dispatch_matmul: out[t] = x[t] @ w[group_ids[t / block_t]] ==
//
//   x          f32|bf16 [T, K]     rows sorted by expert, contiguous
//   w          x's dtype [E, K, N] read through its strides (se, sk, sn)
//   group_ids  int32 [T / block_t] the expert of each block of rows
//   out        x's dtype [T, N], float32 accumulation
//
// The port hands it its packed experts as they lie: we_gate and we_up
// are [E, D, F] views whose memory is [E, F, D] (K contiguous), we_down
// is [E, F, D] row-major (N contiguous).  A contiguous copy would
// duplicate a layer's 4.83 GB of experts, so both layouts are read in
// place.  Group ids may come in any order (a block of rows is one
// expert, neighbouring blocks need not be); an id outside [0, E) gives
// rows of zeros.
//
// What bounds it on the H100: at the capacity dispatch of a 256-token
// prefill chunk of qwen3-moe (T = 128 experts x 32 = 4096 rows, K = 4096,
// N = 1536) the bytes: every expert's weights are read once, 1.61 GB a
// product, 0.48 ms at 3.35 TB/s, against 51.5 GFLOP (0.05 ms on the bf16
// tensor cores).  At the single-batch prefill (8 x 1024 tokens, 98,304
// rows) the operations: 1.24 TFLOP a product, 1.25 ms on the tensor
// cores, which the CUDA cores' float32 FMA (67 TFLOP/s) could not come
// near.  So the bf16 kernel runs on the tensor cores with mma.sync
// (m16n8k16, bf16 in, float32 accumulate): a block owns a 64 x 128
// output tile, 4 warps of 32 x 64 each; K advances 32 at a time through
// two shared-memory stages filled by cp.async, so the next tile's loads
// are in flight while the tensor cores work on this one, and fragments
// come out of shared memory with ldmatrix (.trans for the N-contiguous
// layout).  The TPU kernel's grid walks one expert per row block; here a
// 64-row tile may span several experts, so the block walks the runs of
// equal group id inside its tile, streams each run's expert through the
// same accumulators, and zero-fills the rows outside the run, which adds
// exact zeros to them.  The float32 kernel (float32 configs and the
// checks) is a plain 64 x 64 CUDA-core tile with 4 x 4 outputs a thread.
// Not done yet: wgmma and TMA (a ring of stages and a producer warp),
// which the card's full tensor-core rate needs.
//
// == moe_paged_gateup / moe_paged_down ==
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

// ---- moe_dispatch_matmul ---------------------------------------------------

namespace {

constexpr int kGemmThreads = 128;  // 4 warps
// bf16 tensor-core tile: 64 x 128 outputs, K in steps of 32, rows of the
// shared tiles padded by 8 elements (16 bytes) so ldmatrix's eight row
// addresses fall in distinct banks
constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kAPitch = kBK + 8;   // sA[m][k]
constexpr int kBPitchK = kBK + 8;  // sB[n][k], K-contiguous weights
constexpr int kBPitchN = kBN + 8;  // sB[k][n], N-contiguous weights
constexpr int kBStage = kBN * kBPitchK > kBK * kBPitchN ? kBN * kBPitchK
                                                        : kBK * kBPitchN;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The next run of rows [r0, r1) of one group id inside [r0, mend).
__device__ __forceinline__ int run_end(const int32_t* gids, int r0, int mend,
                                       int block_t, int g) {
  int r1 = min((r0 / block_t + 1) * block_t, mend);
  while (r1 < mend && gids[r1 / block_t] == g) r1 = min(r1 + block_t, mend);
  return r1;
}

// kNContig: w's N stride is 1 (sB[k][n], ldmatrix.trans), else its K
// stride is 1 (sB[n][k]).
template <bool kNContig>
__global__ void __launch_bounds__(kGemmThreads)
grouped_mma_kernel(const int32_t* __restrict__ gids,
                   const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int T, int K, int N,
                   int E, int block_t, long long se, long long sk,
                   long long sn) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][kBM * kAPitch];
  __shared__ __align__(16) __nv_bfloat16 sB[2][kBStage];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // warp tile 32 x 64
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int mend = min(m0 + kBM, T);
  const int nk = (K + kBK - 1) / kBK;

  float acc[2][8][4] = {};
  for (int r0 = m0; r0 < mend;) {
    const int g = gids[r0 / block_t];
    const int r1 = run_end(gids, r0, mend, block_t, g);
    if (g < 0 || g >= E) {  // rows of an unknown expert stay zero
      r0 = r1;
      continue;
    }
    const __nv_bfloat16* wg = w + static_cast<size_t>(g) * se;

    auto load = [&](int stage, int k0) {
      // A: 64 rows x 4 chunks of 8; rows outside the run are zeros
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kGemmThreads;
        const int row = c >> 2, kc = (c & 3) * 8;
        const int gr = m0 + row;
        const bool ok = gr >= r0 && gr < r1 && k0 + kc < K;
        const __nv_bfloat16* src =
            ok ? x + static_cast<size_t>(gr) * K + k0 + kc : x;
        cp_async16(&sA[stage][row * kAPitch + kc], src, ok);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = tid + i * kGemmThreads;
        if (kNContig) {  // 32 k rows x 16 chunks of 8 n
          const int kr = c >> 4, nc = (c & 15) * 8;
          const bool ok = k0 + kr < K && n0 + nc < N;
          const __nv_bfloat16* src =
              ok ? wg + static_cast<size_t>(k0 + kr) * sk + n0 + nc : w;
          cp_async16(&sB[stage][kr * kBPitchN + nc], src, ok);
        } else {  // 128 n rows x 4 chunks of 8 k
          const int nr = c >> 2, kc = (c & 3) * 8;
          const bool ok = n0 + nr < N && k0 + kc < K;
          const __nv_bfloat16* src =
              ok ? wg + static_cast<size_t>(n0 + nr) * sn + k0 + kc : w;
          cp_async16(&sB[stage][nr * kBPitchK + kc], src, ok);
        }
      }
    };

    load(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load((kt + 1) & 1, (kt + 1) * kBK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* a_s = sA[kt & 1];
      const __nv_bfloat16* b_s = sB[kt & 1];
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int row = wm * 32 + mi * 16 + (lane & 15);
          ldmatrix_x4<false>(af[mi], a_s + row * kAPitch + kk +
                                         (lane >> 4) * 8);
        }
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {  // two n8 tiles per ldmatrix
          const int nb = wn * 64 + nj * 16;
          uint32_t bf[4];
          if (kNContig) {
            const int kr = kk + ((lane >> 3) & 1) * 8 + (lane & 7);
            ldmatrix_x4<true>(bf, b_s + kr * kBPitchN + nb +
                                      (lane >> 4) * 8);
          } else {
            const int nr = nb + (lane >> 4) * 8 + (lane & 7);
            ldmatrix_x4<false>(bf, b_s + nr * kBPitchK + kk +
                                       ((lane >> 3) & 1) * 8);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * nj], af[mi], bf);
            mma_bf16(acc[mi][2 * nj + 1], af[mi], bf + 2);
          }
        }
      }
      __syncthreads();
    }
    r0 = r1;
  }

  // epilogue: c0, c1 at (row g, cols 2q, 2q+1), c2, c3 at row g + 8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mi * 16 + (lane >> 2) + h * 8;
        const int col = n0 + wn * 64 + ni * 8 + (lane & 3) * 2;
        if (row >= T) continue;
        __nv_bfloat16* o = out + static_cast<size_t>(row) * N + col;
        if (col < N) o[0] = __float2bfloat16(acc[mi][ni][2 * h]);
        if (col + 1 < N) o[1] = __float2bfloat16(acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

// float32: a 64 x 64 tile on the CUDA cores, 256 threads of 4 x 4
// outputs, K in steps of 16; w through any strides.
constexpr int kFM = 64, kFN = 64, kFK = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
grouped_f32_kernel(const int32_t* __restrict__ gids,
                   const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int T, int K, int N, int E,
                   int block_t, long long se, long long sk, long long sn) {
  __shared__ __align__(16) float sA[kFK][kFM + 4];  // k-major
  __shared__ __align__(16) float sB[kFK][kFN + 4];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.x * kFN;
  const int m0 = blockIdx.y * kFM;
  const int mend = min(m0 + kFM, T);
  const bool n_contig = sn == 1;
  float acc[4][4] = {};
  for (int r0 = m0; r0 < mend;) {
    const int g = gids[r0 / block_t];
    const int r1 = run_end(gids, r0, mend, block_t, g);
    if (g < 0 || g >= E) {
      r0 = r1;
      continue;
    }
    const float* wg = w + static_cast<size_t>(g) * se;
    for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * kFThreads;
        const int m = e / kFK, k = e % kFK;  // k fastest: x rows coalesce
        const int gr = m0 + m;
        sA[k][m] = gr >= r0 && gr < r1 && k0 + k < K
                       ? x[static_cast<size_t>(gr) * K + k0 + k]
                       : 0.f;
        // the weight tile, walked along whichever stride is 1
        const int kb = n_contig ? e / kFN : e % kFK;
        const int nb = n_contig ? e % kFN : e / kFK;
        sB[kb][nb] = k0 + kb < K && n0 + nb < N
                         ? wg[(k0 + kb) * sk + (n0 + nb) * sn]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&sA[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&sB[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    r0 = r1;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 = float32 (w through any strides), 1 = bfloat16 (layout 0:
// w's K stride is 1; layout 1: its N stride is 1; K a multiple of 8,
// the other strides multiples of 8 elements and w 16-byte aligned).
// Strides are in elements.  Returns cudaGetLastError() after the launch.
extern "C" int moe_dispatch_matmul(const void* gids, const void* x,
                                   const void* w, void* out, int T, int K,
                                   int N, int E, int block_t, long long se,
                                   long long sk, long long sn, int dtype,
                                   int layout, void* stream) {
  if (T == 0 || N == 0) return cudaSuccess;
  if (block_t <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* g = static_cast<const int32_t*>(gids);
  if (dtype == 0) {
    const dim3 grid((N + kFN - 1) / kFN, (T + kFM - 1) / kFM);
    grouped_f32_kernel<<<grid, kFThreads, 0, s>>>(
        g, static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), T, K, N, E, block_t, se, sk, sn);
    return cudaGetLastError();
  }
  if (dtype != 1 || K % 8) return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (T + kBM - 1) / kBM);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (layout == 1)
    grouped_mma_kernel<true><<<grid, kGemmThreads, 0, s>>>(
        g, xb, wb, ob, T, K, N, E, block_t, se, sk, sn);
  else if (layout == 0)
    grouped_mma_kernel<false><<<grid, kGemmThreads, 0, s>>>(
        g, xb, wb, ob, T, K, N, E, block_t, se, sk, sn);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
