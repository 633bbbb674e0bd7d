// Causal GQA flash attention for chunked prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py
// (_flash_kernel, public flash_prefill).  Plain version:
// repro_torch/models/layers.py::chunked_attention.
//
//   q      f32|bf16 [B, Sq, H, D]
//   k, v   f32|bf16|int8 [B, Sk, KV, D] (int8 scaled by 1/KV_QSCALE)
//   out    q's dtype [B, Sq, H, D]
//
// Query row i sits at absolute position q_offset + i and, with causal
// set, sees keys 0 .. q_offset + i; query head h reads KV head h / G.
// q_offset = 0 is the TPU kernel; the serve engine's chunked prefill
// passes the chunk's start against the block-table-gathered context.
// Ragged edges (Sq, Sk not multiples of the tiles) are masked here, so
// no divisibility is required of the caller.
//
// What bounds it on the H100: operations at the serve shapes (a chunk of
// a few hundred queries against ~1.5k keys does ~4 * Sq * Sk * H * D
// flops on ~(Sq * H + 2 * Sk * KV) * D elements).  This first version is
// the simple flash loop on the CUDA cores in float32: one block per
// (batch, head, 16-query tile) walks 16-key tiles through shared memory
// with the online softmax state beside them, never writes scores to
// device memory, and stops at the causal diagonal, so tiles above it are
// neither read nor computed.  Tensor cores (wgmma) and TMA come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 128;
constexpr int kBQ = 16;  // query rows per block
constexpr int kBK = 16;  // keys per tile

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v, TQ* __restrict__ out, int Sq,
                     int Sk, int H, int KV, int D, int q_offset, int causal,
                     float scale, float kv_scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ks = D + 1;  // padded K row: the score loop reads across rows
  float* q_s = smem;               // [kBQ][D], pre-scaled by 1/sqrt(D)
  float* acc = q_s + kBQ * D;      // [kBQ][D]
  float* k_s = acc + kBQ * D;      // [kBK][D + 1]
  float* v_s = k_s + kBK * ks;     // [kBK][D]
  float* p_s = v_s + kBK * D;      // [kBQ][kBK] scores, then weights
  float* m_s = p_s + kBQ * kBK;    // [kBQ] running max
  float* l_s = m_s + kBQ;          // [kBQ] running sum
  float* a_s = l_s + kBQ;          // [kBQ] rescale of this tile

  const int n_q = min(kBQ, Sq - q0);
  for (int e = tid; e < kBQ * D; e += blockDim.x) {
    const int i = e / D;
    const int d = e - i * D;
    float x = 0.f;
    if (i < n_q) {
      const size_t off =
          ((static_cast<size_t>(b) * Sq + q0 + i) * H + h) * D + d;
      x = to_f32(q[off]) * scale;
    }
    q_s[e] = x;
    acc[e] = 0.f;
  }
  for (int i = tid; i < kBQ; i += blockDim.x) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // keys past the last query row's position are masked for every row:
  // stop there (the causal skip of tiles above the diagonal)
  const int k_end = causal ? min(Sk, q_offset + q0 + n_q) : Sk;
  for (int kt = 0; kt < k_end; kt += kBK) {
    for (int e = tid; e < kBK * D; e += blockDim.x) {
      const int t = e / D;
      const int d = e - t * D;
      float kx = 0.f, vx = 0.f;
      if (kt + t < Sk) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + kt + t) * KV + kvh) * D + d;
        kx = to_f32(k[off]) * kv_scale;
        vx = to_f32(v[off]) * kv_scale;
      }
      k_s[t * ks + d] = kx;
      v_s[e] = vx;
    }
    __syncthreads();
    for (int e = tid; e < kBQ * kBK; e += blockDim.x) {
      const int i = e / kBK;
      const int t = e - i * kBK;
      const int key = kt + t;
      float s = -INFINITY;
      if (i < n_q && key < Sk && (!causal || key <= q_offset + q0 + i)) {
        const float* qi = q_s + i * D;
        const float* kr = k_s + t * ks;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qi[d] * kr[d];
        s = dot;
      }
      p_s[e] = s;
    }
    __syncthreads();
    for (int i = tid; i < kBQ; i += blockDim.x) {
      float* pi = p_s + i * kBK;
      const float m_prev = m_s[i];
      float m_new = m_prev;
      for (int t = 0; t < kBK; ++t) m_new = fmaxf(m_new, pi[t]);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
      float sum = 0.f;
      for (int t = 0; t < kBK; ++t) {
        const float p = isfinite(pi[t]) ? expf(pi[t] - m_safe) : 0.f;
        pi[t] = p;
        sum += p;
      }
      l_s[i] = l_s[i] * alpha + sum;
      m_s[i] = m_new;
      a_s[i] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < kBQ * D; e += blockDim.x) {
      const int i = e / D;
      const int d = e - i * D;
      const float* pi = p_s + i * kBK;
      float o = acc[e] * a_s[i];
      for (int t = 0; t < kBK; ++t) o += pi[t] * v_s[t * D + d];
      acc[e] = o;
    }
    __syncthreads();
  }

  for (int e = tid; e < n_q * D; e += blockDim.x) {
    const int i = e / D;
    const int d = e - i * D;
    const size_t off =
        ((static_cast<size_t>(b) * Sq + q0 + i) * H + h) * D + d;
    out[off] = from_f32<TQ>(acc[e] / fmaxf(l_s[i], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int D, int q_offset,
                   int causal, float kv_scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      (2 * kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kBK + 3 * kBQ);
  auto kern = flash_prefill_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(out), Sq, Sk, H, KV, D,
      q_offset, causal, 1.f / sqrtf(static_cast<float>(D)), kv_scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_q(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int H, int KV, int D,
                     int q_offset, int causal, int kv_dtype, float kv_scale,
                     cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<TQ, float>(q, k, v, out, B, Sq, Sk, H, KV, D, q_offset,
                               causal, kv_scale, stream);
    case 1:
      return launch<TQ, __nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, D,
                                       q_offset, causal, kv_scale, stream);
    case 2:
      return launch<TQ, int8_t>(q, k, v, out, B, Sq, Sk, H, KV, D, q_offset,
                                causal, kv_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (k/v only).
// Returns cudaGetLastError() after the launch.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int B, int Sq, int Sk, int H, int KV,
                             int D, int q_offset, int causal, int q_dtype,
                             int kv_dtype, float kv_scale, void* stream) {
  if (B * Sq * H == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_q<float>(q, k, v, out, B, Sq, Sk, H, KV, D, q_offset,
                             causal, kv_dtype, kv_scale, s);
    case 1:
      return launch_q<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, D,
                                     q_offset, causal, kv_dtype, kv_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
