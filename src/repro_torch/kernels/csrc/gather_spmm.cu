// ELL SpMM with a gathered dense operand:
//   out[m, n] = sum_j vals[m, j] * dense[cols[m, j], n]
//
// Replaces the TPU kernel src/repro/kernels/gather_spmm.py (_spmm_kernel,
// public gather_spmm).  Plain version:
// repro_torch/kernels/gather_spmm.py::gather_spmm_plain (gather, float32
// einsum).
//
//   cols   int32 [M, J]        column ids into dense's rows
//   vals   f32|bf16 [M, J]     ELL values; padding entries carry 0
//   dense  f32|bf16 [N_in, N]  row-major
//   out    f32 [M, N]          float32 accumulation
//
// Padding entries (val 0) add 0 * dense[col], numerically inert as in
// the TPU contract; a column id outside [0, N_in) adds nothing instead
// of reading outside dense.
//
// What bounds it on the H100: operations, then the gathers.  Each of the
// M * J (row, entry) pairs multiplies one dense row of N elements, so
// M * J * N FMAs; the bytes each input must move once are the ELL arrays,
// dense and out (at a pruned 1536 x 8960 down projection at 90 %
// sparsity over a 256-token chunk: 705 MFLOP against 14 MB).  The TPU
// kernel scalar-prefetches cols and DMAs row cols[m, j+1] while row j is
// in the vector unit.  Here one warp owns (row m, a slice of 32 * V
// columns): the warp loads 32 (col, val) pairs at once, coalesced, and
// hands them round with shuffles; every lane then reads V contiguous
// elements (16 bytes) of each gathered row, four rows in flight, and
// keeps V float32 sums in registers.  A dense operand that fits the 50 MB
// L2 is read from it again for every row that names it; a warp's loads
// are independent of its FMAs, so the SM keeps many in flight.  Every
// output element is written once: no atomics, no dependence on the order
// blocks run in.  Not done: tensor cores (each row's entries gather
// other rows, so there is no shared tile to feed them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::to_f32;

constexpr int kWarps = 8;
constexpr int kUnroll = 4;  // gathered rows a lane has in flight

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

template <typename TV, typename TD, int V>
__global__ void __launch_bounds__(kWarps * 32)
gather_spmm_kernel(const int32_t* __restrict__ cols,
                   const TV* __restrict__ vals,
                   const TD* __restrict__ dense, float* __restrict__ out,
                   int M, int J, int N_in, int N, int n_slices) {
  const int lane = threadIdx.x & 31;
  const long long item =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(M) * n_slices) return;  // warp-uniform
  const int m = static_cast<int>(item / n_slices);
  const int n0 = static_cast<int>(item % n_slices) * 32 * V + lane * V;
  const bool live = n0 < N;
  const int32_t* c_m = cols + static_cast<size_t>(m) * J;
  const TV* v_m = vals + static_cast<size_t>(m) * J;
  float acc[V] = {};
  for (int j0 = 0; j0 < J; j0 += 32) {
    // 32 entries of the row, one a lane, coalesced
    int col = -1;
    float val = 0.f;
    if (j0 + lane < J) {
      col = c_m[j0 + lane];
      val = to_f32(v_m[j0 + lane]);
    }
    const int nj = min(32, J - j0);
    for (int u0 = 0; u0 < nj; u0 += kUnroll) {
      float row[kUnroll][V];
      float vs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = __shfl_sync(0xffffffffu, col, (u0 + u) & 31);
        vs[u] = __shfl_sync(0xffffffffu, val, (u0 + u) & 31);
        const bool ok = live && u0 + u < nj && c >= 0 && c < N_in;
        if (ok) {
          Vec<TD, V>::load(dense + static_cast<size_t>(c) * N + n0, row[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) row[u][e] = 0.f;
          vs[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(vs[u], row[u][e], acc[e]);
    }
  }
  if (!live) return;
  float* o = out + static_cast<size_t>(m) * N + n0;
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(o + e) =
          make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = acc[e];
  }
}

template <typename TV, typename TD, int V>
cudaError_t launch(const void* cols, const void* vals, const void* dense,
                   void* out, int M, int J, int N_in, int N,
                   cudaStream_t stream) {
  const int n_slices = (N + 32 * V - 1) / (32 * V);
  const long long items = static_cast<long long>(M) * n_slices;
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_spmm_kernel<TV, TD, V><<<static_cast<unsigned>(blocks), kWarps * 32,
                                  0, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const TV*>(vals),
      static_cast<const TD*>(dense), static_cast<float*>(out), M, J, N_in, N,
      n_slices);
  return cudaGetLastError();
}

template <typename TV>
cudaError_t launch_dense(const void* cols, const void* vals,
                         const void* dense, void* out, int M, int J, int N_in,
                         int N, int dense_dtype, int vec,
                         cudaStream_t stream) {
  switch (dense_dtype) {
    case 0:
      return vec ? launch<TV, float, 4>(cols, vals, dense, out, M, J, N_in, N,
                                        stream)
                 : launch<TV, float, 1>(cols, vals, dense, out, M, J, N_in, N,
                                        stream);
    case 1:
      return vec ? launch<TV, __nv_bfloat16, 8>(cols, vals, dense, out, M, J,
                                                N_in, N, stream)
                 : launch<TV, __nv_bfloat16, 1>(cols, vals, dense, out, M, J,
                                                N_in, N, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (vals and dense each).  vec: 1
// when N fills whole 16-byte vectors of dense and both dense and out are
// 16-byte aligned, else 0 (element-wise).  Returns cudaGetLastError()
// after the launch.
extern "C" int gather_spmm(const void* cols, const void* vals,
                           const void* dense, void* out, int M, int J,
                           int N_in, int N, int vals_dtype, int dense_dtype,
                           int vec, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vals_dtype) {
    case 0:
      return launch_dense<float>(cols, vals, dense, out, M, J, N_in, N,
                                 dense_dtype, vec, s);
    case 1:
      return launch_dense<__nv_bfloat16>(cols, vals, dense, out, M, J, N_in,
                                         N, dense_dtype, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}
