// Paged TopK decode attention on one layer of the physical KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attn.py
// (_paged_kernel, public paged_decode_attn).  Plain version:
// repro_torch/models/sparse_attention.py::attend_pages_paged.
//
//   phys, idx  int32 [R, KV, K]   physical page ids (gather) / logical ids
//                                 (causal frontier mask)
//   pos        int32 [R]          per-request frontier position
//   q          f32|bf16 [R, KV, G, D]
//   k/v_pool   f32|bf16|int8 [P, page, KV, D] (int8 scaled by 1/KV_QSCALE)
//   out        q's dtype [R, KV, G, D]
//
// What bounds it on the H100: bytes.  Each (request, KV head) reads its K
// selected pages once (2 * K * page * D elements) and does 4 * G * D
// flops per token, far below the card's ~295 flops per byte.  The design
// follows from that: one block per (request, KV head) streams its own
// pages through shared memory in float32 and keeps the online-softmax
// state (running max, sum, accumulator) there, so the gathered K/V never
// goes back to device memory, and pages whose first token lies past the
// frontier (NULL-padded slots of short requests, padded batch rows) are
// skipped without being read.  This first version is simple: no cp.async
// double buffering and no tensor cores; a page is loaded, scored and
// accumulated in turn.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 128;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const int32_t* __restrict__ phys,
                    const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ pos,
                    const TQ* __restrict__ q,
                    const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, TQ* __restrict__ out,
                    int KV, int G, int D, int K, int page, float scale,
                    float kv_scale) {
  extern __shared__ float smem[];
  const int rh = blockIdx.x;  // r * KV + h
  const int r = rh / KV;
  const int h = rh - r * KV;
  const int tid = threadIdx.x;
  const int ks = D + 1;  // padded K row: the score loop reads across rows
  float* q_s = smem;                // [G][D], pre-scaled by 1/sqrt(D)
  float* acc = q_s + G * D;         // [G][D]
  float* k_s = acc + G * D;         // [page][D + 1]
  float* v_s = k_s + page * ks;     // [page][D]
  float* p_s = v_s + page * D;      // [G][page] scores, then weights
  float* m_s = p_s + G * page;      // [G] running max
  float* l_s = m_s + G;             // [G] running sum
  float* a_s = l_s + G;             // [G] rescale of this page

  const TQ* q_rh = q + static_cast<size_t>(rh) * G * D;
  for (int e = tid; e < G * D; e += blockDim.x) {
    q_s[e] = to_f32(q_rh[e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  const int frontier = pos[r];
  const int32_t* phys_rh = phys + static_cast<size_t>(rh) * K;
  const int32_t* idx_rh = idx + static_cast<size_t>(rh) * K;
  __syncthreads();

  for (int j = 0; j < K; ++j) {
    const int tok0 = idx_rh[j] * page;
    // uniform across the block: a page wholly past the frontier adds
    // nothing to the online softmax, so it is not read at all
    if (tok0 > frontier) continue;
    const int n_live = min(page, frontier - tok0 + 1);
    const size_t base = static_cast<size_t>(phys_rh[j]) * page * KV * D;
    for (int e = tid; e < page * D; e += blockDim.x) {
      const int t = e / D;
      const int d = e - t * D;
      const size_t off = base + (static_cast<size_t>(t) * KV + h) * D + d;
      k_s[t * ks + d] = to_f32(k_pool[off]) * kv_scale;
      v_s[e] = to_f32(v_pool[off]) * kv_scale;
    }
    __syncthreads();
    for (int e = tid; e < G * page; e += blockDim.x) {
      const int g = e / page;
      const int t = e - g * page;
      float s = -INFINITY;
      if (t < n_live) {
        const float* qg = q_s + g * D;
        const float* kt = k_s + t * ks;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qg[d] * kt[d];
        s = dot;
      }
      p_s[e] = s;
    }
    __syncthreads();
    for (int g = tid; g < G; g += blockDim.x) {
      float* pg = p_s + g * page;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int t = 0; t < page; ++t) m_new = fmaxf(m_new, pg[t]);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = isfinite(pg[t]) ? expf(pg[t] - m_safe) : 0.f;
        pg[t] = p;
        sum += p;
      }
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += blockDim.x) {
      const int g = e / D;
      const int d = e - g * D;
      const float* pg = p_s + g * page;
      float o = acc[e] * a_s[g];
      for (int t = 0; t < n_live; ++t) o += pg[t] * v_s[t * D + d];
      acc[e] = o;
    }
    __syncthreads();
  }

  TQ* out_rh = out + static_cast<size_t>(rh) * G * D;
  for (int e = tid; e < G * D; e += blockDim.x) {
    const float l = l_s[e / D];
    out_rh[e] = from_f32<TQ>(l > 0.f ? acc[e] / fmaxf(l, 1e-30f) : 0.f);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* phys, const void* idx, const void* pos,
                   const void* q, const void* k_pool, const void* v_pool,
                   void* out, int R, int KV, int G, int D, int K, int page,
                   float kv_scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      (2 * G * D + page * (D + 1) + page * D + G * page + 3 * G);
  auto kern = paged_decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<R * KV, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(phys), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(pos), static_cast<const TQ*>(q),
      static_cast<const TKV*>(k_pool), static_cast<const TKV*>(v_pool),
      static_cast<TQ*>(out), KV, G, D, K, page,
      1.f / sqrtf(static_cast<float>(D)), kv_scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_q(const void* phys, const void* idx, const void* pos,
                     const void* q, const void* k_pool, const void* v_pool,
                     void* out, int R, int KV, int G, int D, int K, int page,
                     int kv_dtype, float kv_scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<TQ, float>(phys, idx, pos, q, k_pool, v_pool, out, R, KV,
                               G, D, K, page, kv_scale, stream);
    case 1:
      return launch<TQ, __nv_bfloat16>(phys, idx, pos, q, k_pool, v_pool,
                                       out, R, KV, G, D, K, page, kv_scale,
                                       stream);
    case 2:
      return launch<TQ, int8_t>(phys, idx, pos, q, k_pool, v_pool, out, R,
                                KV, G, D, K, page, kv_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_attn(const void* phys, const void* idx,
                                 const void* pos, const void* q,
                                 const void* k_pool, const void* v_pool,
                                 void* out, int R, int KV, int G, int D,
                                 int K, int page, int q_dtype, int kv_dtype,
                                 float kv_scale, void* stream) {
  if (R * KV == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_q<float>(phys, idx, pos, q, k_pool, v_pool, out, R, KV,
                             G, D, K, page, kv_dtype, kv_scale, s);
    case 1:
      return launch_q<__nv_bfloat16>(phys, idx, pos, q, k_pool, v_pool, out,
                                     R, KV, G, D, K, page, kv_dtype, kv_scale,
                                     s);
    default:
      return cudaErrorInvalidValue;
  }
}
