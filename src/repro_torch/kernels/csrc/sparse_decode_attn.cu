// TopK-page decode attention on one layer of a contiguous KV cache.
//
// Replaces the TPU kernel src/repro/kernels/sparse_decode_attn.py
// (_attn_kernel, public sparse_decode_attn).  Plain versions:
// repro_torch/kernels/sparse_decode_attn.py::sparse_decode_attn_plain (no
// frontier) and repro_torch/models/sparse_attention.py::attend_pages (a
// frontier at pos).
//
//   idx    int32 [B, KV, P]          page ids into [0, S / page); a repeated
//                                    id counts its page again
//   q      f32|bf16 [B, KV, G, D]
//   k, v   f32|bf16|int8 [B, S, KV, D] (int8 scaled by 1/KV_QSCALE): one
//                                    layer of the stacked cache, so a
//                                    token's head row is D elements at a
//                                    stride of KV * D
//   out    q's dtype [B, KV, G, D]
//
// Tokens at positions past `frontier` score -inf (the single-batch
// engine's mask: the cache beyond the newest token is zeros); the TPU
// kernel's contract, every gathered token counting, is frontier = INT_MAX.
// Page ids outside [0, S / page) add nothing.
//
// What bounds it on the H100: bytes.  Each (batch row, KV head) reads its
// P selected pages once (2 * P * page * D elements) and does 4 * G * D
// flops per token, far below the card's ~295 flops per byte.  The TPU
// kernel walks the pages as a sequential grid axis with the softmax
// state in VMEM; here the pages of one (row, head) are dealt out to the 8
// warps of one block.  Each warp keeps its own online softmax for a chunk
// of up to 8 query heads in registers (lanes split D), loads 4 tokens' K
// and V rows at a time so their loads are in flight together, and needs
// no barrier until the end, when the warps' partial states meet once in
// shared memory in a fixed order: no atomics, so results do not depend
// on scheduling.  This first version has one block per (row, head,
// 8-head chunk; 4 heads at D = 256, where each lane holds 8 elements);
// splitting the pages across blocks (and a second pass to merge them)
// would fill more of the card's 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kWarps = 8;
constexpr int kTok = 4;  // tokens whose K/V rows a warp loads together

// query heads a block carries (a chunk of G): 8, or 4 at D = 256, where
// 8 warps' partial states of 8 heads would need 64 KiB of shared memory
// and twice the registers
__host__ __device__ constexpr int heads_per_block(int dpl) {
  return dpl > 4 ? 4 : 8;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
sparse_decode_kernel(const int32_t* __restrict__ idx,
                     const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v, TQ* __restrict__ out, int S,
                     int KV, int G, int P, int page, int frontier,
                     float scale, float kv_scale) {
  constexpr int D = 32 * DPL;
  constexpr int kGC = heads_per_block(DPL);
  __shared__ float m_s[kWarps][kGC];
  __shared__ float l_s[kWarps][kGC];
  __shared__ float acc_s[kWarps][kGC][D];
  const int bh = blockIdx.x;  // b * KV + h
  const int b = bh / KV;
  const int h = bh - b * KV;
  const int g0 = blockIdx.y * kGC;
  const int gn = min(kGC, G - g0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * DPL;

  float qr[kGC][DPL], acc[kGC][DPL], m[kGC], l[kGC];
  const TQ* q_bh = q + (static_cast<size_t>(bh) * G + g0) * D + d0;
#pragma unroll
  for (int g = 0; g < kGC; ++g) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      qr[g][e] = g < gn ? to_f32(q_bh[g * D + e]) * scale : 0.f;
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const int32_t* idx_bh = idx + static_cast<size_t>(bh) * P;
  const int n_seq_pages = S / page;
  const size_t row = static_cast<size_t>(KV) * D;  // token stride
  const size_t head0 = static_cast<size_t>(b) * S * row +
                       static_cast<size_t>(h) * D + d0;
  const TKV* k_bh = k + head0;
  const TKV* v_bh = v + head0;

  // every branch below is uniform across a warp: lanes only split D
  for (int j = warp; j < P; j += kWarps) {
    const int pid = idx_bh[j];
    if (pid < 0 || pid >= n_seq_pages) continue;
    const int tok0 = pid * page;
    if (tok0 > frontier) continue;  // wholly past the frontier: not read
    const int n_live = frontier - tok0 >= page ? page : frontier - tok0 + 1;
    for (int t0 = 0; t0 < n_live; t0 += kTok) {
      float kr[kTok][DPL], vr[kTok][DPL];
#pragma unroll
      for (int u = 0; u < kTok; ++u) {
        const bool live = t0 + u < n_live;
        const size_t off = static_cast<size_t>(tok0 + t0 + u) * row;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          kr[u][e] = live ? to_f32(k_bh[off + e]) * kv_scale : 0.f;
          vr[u][e] = live ? to_f32(v_bh[off + e]) * kv_scale : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < kGC; ++g) {
        if (g >= gn) continue;
        float s[kTok];
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < kTok; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < DPL; ++e) dot += qr[g][e] * kr[u][e];
          dot = warp_sum(dot);
          s[u] = t0 + u < n_live ? dot : -INFINITY;
          m_new = fmaxf(m_new, s[u]);
        }
        // token t0 is live, so m_new is finite; exp(-inf) = 0 drops the
        // first page's empty history and the masked tokens
        const float alpha = expf(m[g] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kTok; ++u) {
          s[u] = expf(s[u] - m_new);
          sum += s[u];
        }
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          float o = acc[g][e] * alpha;
#pragma unroll
          for (int u = 0; u < kTok; ++u) o += s[u] * vr[u][e];
          acc[g][e] = o;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kGC; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc_s[warp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();
  TQ* out_bh = out + (static_cast<size_t>(bh) * G + g0) * D;
  for (int e = threadIdx.x; e < gn * D; e += blockDim.x) {
    const int g = e / D;
    const int d = e - g * D;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float l_sum = 0.f, o = 0.f;
    if (mx > -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float a = m_s[w][g] > -INFINITY ? expf(m_s[w][g] - mx) : 0.f;
        l_sum += l_s[w][g] * a;
        o += acc_s[w][g][d] * a;
      }
    }
    // a row with no live token (every page past the frontier) is zeros
    out_bh[e] = from_f32<TQ>(l_sum > 0.f ? o / l_sum : 0.f);
  }
}

template <typename TQ, typename TKV, int DPL>
cudaError_t launch(const void* idx, const void* q, const void* k,
                   const void* v, void* out, int B, int S, int KV, int G,
                   int P, int page, int frontier, float kv_scale,
                   cudaStream_t stream) {
  constexpr int kGC = heads_per_block(DPL);
  const dim3 grid(B * KV, (G + kGC - 1) / kGC);
  sparse_decode_kernel<TQ, TKV, DPL><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const TQ*>(q),
      static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), S, KV, G, P, page, frontier,
      1.f / sqrtf(static_cast<float>(32 * DPL)), kv_scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(const void* idx, const void* q, const void* k,
                     const void* v, void* out, int B, int S, int KV, int G,
                     int D, int P, int page, int frontier, float kv_scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<TQ, TKV, 1>(idx, q, k, v, out, B, S, KV, G, P, page,
                                frontier, kv_scale, stream);
    case 64:
      return launch<TQ, TKV, 2>(idx, q, k, v, out, B, S, KV, G, P, page,
                                frontier, kv_scale, stream);
    case 128:
      return launch<TQ, TKV, 4>(idx, q, k, v, out, B, S, KV, G, P, page,
                                frontier, kv_scale, stream);
    case 256:
      return launch<TQ, TKV, 8>(idx, q, k, v, out, B, S, KV, G, P, page,
                                frontier, kv_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t launch_kv(const void* idx, const void* q, const void* k,
                      const void* v, void* out, int B, int S, int KV, int G,
                      int D, int P, int page, int frontier, int kv_dtype,
                      float kv_scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_d<TQ, float>(idx, q, k, v, out, B, S, KV, G, D, P, page,
                                 frontier, kv_scale, stream);
    case 1:
      return launch_d<TQ, __nv_bfloat16>(idx, q, k, v, out, B, S, KV, G, D,
                                         P, page, frontier, kv_scale, stream);
    case 2:
      return launch_d<TQ, int8_t>(idx, q, k, v, out, B, S, KV, G, D, P, page,
                                  frontier, kv_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (K/V only); D is 32,
// 64, 128 or 256.  Returns cudaGetLastError() after the launch.
extern "C" int sparse_decode_attn(const void* idx, const void* q,
                                  const void* k, const void* v, void* out,
                                  int B, int S, int KV, int G, int D, int P,
                                  int page, int frontier, int q_dtype,
                                  int kv_dtype, float kv_scale,
                                  void* stream) {
  if (B * KV * G == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_kv<float>(idx, q, k, v, out, B, S, KV, G, D, P, page,
                              frontier, kv_dtype, kv_scale, s);
    case 1:
      return launch_kv<__nv_bfloat16>(idx, q, k, v, out, B, S, KV, G, D, P,
                                      page, frontier, kv_dtype, kv_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
