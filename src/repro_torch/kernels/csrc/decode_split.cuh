// The split-page body of the two TopK decode-attention kernels,
// paged_decode_attn.cu (pages of the physical pool) and
// sparse_decode_attn.cu (pages of a contiguous cache).  The two compute
// one function: GQA decode attention of q [R, KV, G, D] over K selected
// pages of `page` tokens each, tokens past a frontier masked, with an
// -inf-safe online softmax.  They differ only in where a page starts in
// memory, which a small page-address policy says (PagedPages,
// ContiguousPages below); within a page a token's head row is D elements
// at a stride of KV * D in both.
//
// What bounds it on the H100: bytes, and below that the latency of one
// launch.  Each (row, KV head) reads its live pages' K and V once,
// 2 * page * D elements a page, and does 4 * G * D flops a token: at
// qwen3-moe's G = 16 in float32 on the CUDA cores about as long as the
// bytes take.  At the serve paths' shapes that is 2-5 microseconds, less
// than a chain of three dependent memory round trips (page ids, the
// page, the partials) and two launches.
//
// The design:
// * Split a row's pages over blocks.  The grid is (R * KV, n_split,
//   G-chunks); a block takes the run of `pages_per_split` selected pages
//   of its split, one page to each of its 8 warps.  n_split depends on K
//   alone (the host's split rule), never on R, the frontier or the data,
//   so a row's result does not depend on the rows launched beside it.
// * Bytes in flight: a warp copies its page's K rows, then its V rows,
//   into its own shared memory with 16-byte cp.async, all in flight
//   together, and scores K while V is still arriving.  A page (or the
//   part of it) past the frontier is not read.
// * bf16 q with bf16 K/V at D <= 128, what every serve path runs, on the
//   tensor cores: per 16-token chunk S = Q K^T (16 query heads, zero rows
//   past G) and O += P V with mma.sync m16n8k16, K and V read by
//   ldmatrix, P kept in registers as bf16 (warp_pages_mma).  The other
//   instantiations (float32 q or K/V, int8 K/V, D = 256) in float32 on
//   the CUDA cores: lanes split a chunk's tokens and D to score, q from
//   shared memory, then lanes split D for P V (warp_pages_simt).  Either
//   way each warp keeps its own online softmax in registers, with no
//   block barrier in the page loop, and the warps' states meet once in
//   shared memory in warp order.
// * Merge: with one split the block writes the output.  Otherwise each
//   block writes its partial (acc, m, l) in float32 to a workspace
//   [R * KV, n_split, G, D + 2], every slot, a split with no live token
//   too (m = -inf, l = 0), and decode_merge_kernel combines the splits
//   of each (row, head) in split order.  No atomics: a repeated call is
//   bitwise equal.  A row with no live token gives zeros.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace decode_split {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Where selected page j of (row, KV head) rh starts, as an element
// offset of its first token's head row, and its first token's position.
// `locate` returns false for a slot that adds nothing.
struct PagedPages {
  const int32_t* phys;  // [R, KV, K] physical page ids: the gather
  const int32_t* idx;   // [R, KV, K] logical page ids: the positions
  const int32_t* pos;   // [R] frontiers
  int kv, k_sel, page;

  __device__ int frontier(int rh) const { return pos[rh / kv]; }
  __device__ bool locate(int rh, int j, int d, size_t& base,
                         int& tok0) const {
    const size_t at = static_cast<size_t>(rh) * k_sel + j;
    tok0 = idx[at] * page;
    base = (static_cast<size_t>(phys[at]) * page * kv + rh % kv) * d;
    return true;
  }
};

struct ContiguousPages {
  const int32_t* idx;  // [B, KV, K] page ids into [0, S / page)
  int kv, k_sel, page, seq, front;  // front: INT_MAX = every token counts

  __device__ int frontier(int) const { return front; }
  __device__ bool locate(int rh, int j, int d, size_t& base,
                         int& tok0) const {
    const int pid = idx[static_cast<size_t>(rh) * k_sel + j];
    if (pid < 0 || pid >= seq / page) return false;
    tok0 = pid * page;
    base = ((static_cast<size_t>(rh / kv) * seq + tok0) * kv + rh % kv) * d;
    return true;
  }
};

// Shapes of one instantiation (K/V element type, head dim D).
template <typename TKV, int D>
struct Layout {
  static constexpr int kSz = sizeof(TKV);
  static constexpr int kEpv = 16 / kSz;       // elements in 16 bytes
  static constexpr int kVpr = D * kSz / 16;   // 16-byte vectors a row
  // tokens a warp stages at a time: up to 8 KB of K rows (a whole page
  // of 16 tokens but for float32 at D = 256), 8 to 16 tokens
  static constexpr int kCt = 8192 / (D * kSz) > 16 ? 16 : 8192 / (D * kSz);
  static constexpr int kLq = 32 / kCt;        // lanes a token, scoring
  static constexpr int kEq = D / kLq;         // elements a lane, scoring
  static constexpr int kRow = D * kSz + 16;   // padded: no bank conflicts
  static constexpr int kDpl = D / 32;         // elements a lane, P V
  static constexpr int kGc = kDpl > 4 ? 8 : 16;  // query heads a block
  static constexpr int kStage = kWarps * 2 * kCt * kRow;
  static constexpr int kMerge = kWarps * kGc * (D + 2) * 4;
  static constexpr int kSmem = (kGc * D + kWarps * kGc * kCt) * 4 +
                               (kStage > kMerge ? kStage : kMerge);
  static_assert(kEq % kEpv == 0 && kCt % 8 == 0, "layout");
};

// -- element loads -------------------------------------------------------------

template <typename T>
struct Words;  // float32 values of a 32-bit word of elements
template <>
struct Words<float> {
  static constexpr int kPer = 1;
  __device__ static float at(uint32_t w, int) { return __uint_as_float(w); }
};
template <>
struct Words<__nv_bfloat16> {
  static constexpr int kPer = 2;
  __device__ static float at(uint32_t w, int i) {
    return __uint_as_float(i ? w & 0xffff0000u : w << 16);
  }
};
template <>
struct Words<int8_t> {
  static constexpr int kPer = 4;
  __device__ static float at(uint32_t w, int i) {
    return static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
  }
};

// N consecutive elements of type T at p (aligned to N * sizeof(T) or to
// 16 bytes, whichever is less), widened to float32
template <typename T, int N>
__device__ __forceinline__ void load_f32(const unsigned char* p,
                                         float (&f)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kPer = Words<T>::kPer;
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 r = reinterpret_cast<const uint4*>(p)[c];
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4 * kPer; ++i)
        f[c * 4 * kPer + i] = Words<T>::at(w[i / kPer], i % kPer);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 2 * kPer; ++i)
      f[i] = Words<T>::at(i < kPer ? r.x : r.y, i % kPer);
  } else if constexpr (kBytes == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < kPer; ++i) f[i] = Words<T>::at(w, i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(reinterpret_cast<const T*>(p)[i]);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem, or zeros where `bytes` is 0 (nothing is read then)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows of a chunk, `stride` elements apart in device memory, into shared
// rows of kRow bytes, 16 bytes a lane at a time: rows [0, n), or with
// kFill all kCt rows, those from n on zeros (the tensor cores multiply
// them by a weight of 0, which must not meet a NaN left in shared memory)
template <typename TKV, int D, bool kFill>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const TKV* src, size_t stride,
                                           int n, int lane) {
  using L = Layout<TKV, D>;
  const int rows = kFill ? L::kCt : n;
  for (int i = lane; i < rows * L::kVpr; i += 32) {
    const int row = i / L::kVpr;
    const int col = i - row * L::kVpr;
    const bool live = row < n;
    cp_async16(dst + row * L::kRow + col * 16,
               src + (live ? row : 0) * stride + col * L::kEpv,
               live ? 16 : 0);
  }
}

// bf16 q with bf16 K/V at D <= 128, what every serve path runs, scores and
// accumulates on the tensor cores; the other instantiations (float32 q
// or K/V, int8 K/V, D = 256) on the CUDA cores in float32
template <typename TQ, typename TKV, int D>
constexpr bool kTensorCores = std::is_same<TQ, __nv_bfloat16>::value &&
                              std::is_same<TKV, __nv_bfloat16>::value &&
                              D <= 128;

// -- tensor cores: mma.sync m16n8k16, bf16 in, float32 accumulate -------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// One warp's pages on the tensor cores.  A chunk is 16 tokens: S = Q K^T
// as 16 query heads (the block's head chunk, zero rows past G) by 16
// tokens, D / 16 k-steps with K read by ldmatrix; the online softmax on
// the score fragments (a lane holds rows r0 and r0 + 8, a quad a row's
// 16 tokens); then O += P V with P in registers (the score accumulator
// is P's A fragment) and V read by ldmatrix.trans.  Leaves the warp's
// (O, m, l) in acc_s / ml_s.
template <int D, class Pages>
__device__ __forceinline__ void warp_pages_mma(
    const Pages& pages, const __nv_bfloat16* __restrict__ q_rh, int gn,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    unsigned char* k_s, unsigned char* v_s, int rh, int j0, int j_end,
    int frontier, float qk_scale, float* acc_s, float* ml_s) {
  using L = Layout<__nv_bfloat16, D>;
  static_assert(L::kCt == 16 && L::kGc == 16, "16 heads by 16 tokens");
  constexpr int kKs = D / 16;  // k16 steps of Q K^T
  constexpr int kNt = D / 8;   // n8 tiles of P V
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = lane >> 2;        // fragment rows r0, r0 + 8
  const int c0 = (lane & 3) * 2;   // fragment columns c0, c0 + 1
  const size_t stride = static_cast<size_t>(pages.kv) * D;

  uint32_t qa[kKs][4];
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i & 1) * 8;
      const int col = ks * 16 + c0 + (i >> 1) * 8;
      qa[ks][i] = row < gn ? *reinterpret_cast<const uint32_t*>(
                                 q_rh + row * D + col)
                           : 0u;
    }
  }
  float o[kNt][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  // ldmatrix rows of this lane: K as (tokens 0-7 | 8-15) x (d 0-7 | 8-15)
  // of a k-step, V transposed as (tokens 0-7 | 8-15) of d 0-7, then d 8-15
  const uint32_t k_lane = smem_addr(
      k_s + ((lane & 7) + ((lane >> 4) << 3)) * L::kRow +
      ((lane >> 3) & 1) * 16);
  const uint32_t v_lane = smem_addr(
      v_s + ((lane & 7) + (((lane >> 3) & 1) << 3)) * L::kRow +
      (lane >> 4) * 16);

  for (int j = j0; j < j_end; j += kWarps) {
    size_t base;
    int tok0;
    if (!pages.locate(rh, j, D, base, tok0) || tok0 > frontier) continue;
    const int page = pages.page;
    const int n_page = frontier - tok0 >= page ? page : frontier - tok0 + 1;
    for (int t0 = 0; t0 < n_page; t0 += 16) {
      const int n = min(16, n_page - t0);
      __syncwarp();  // the last chunk's ldmatrix reads are done
      const size_t at = base + t0 * stride;
      stage_rows<__nv_bfloat16, D, true>(k_s, k + at, stride, n, lane);
      cp_async_commit();
      stage_rows<__nv_bfloat16, D, true>(v_s, v + at, stride, n, lane);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();

      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, k_lane + ks * 32);
        mma_bf16(s[0], qa[ks], b[0], b[1]);
        mma_bf16(s[1], qa[ks], b[2], b[3]);
      }
      // token 0 of the chunk is live, so each row's max is finite
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = nt * 8 + c0 + (e & 1);
          s[nt][e] = t < n ? s[nt][e] * qk_scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - m[e >> 1]);
          l[e >> 1] += s[nt][e];
        }
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      cp_async_wait<0>();
      __syncwarp();
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldsm_x4_t(b, v_lane + dn * 32);
        mma_bf16(o[2 * dn], pa, b[0], b[1]);
        mma_bf16(o[2 * dn + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();  // every warp is done with its staging buffers
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc_s[(warp * 16 + r0 + (e >> 1) * 8) * D + nt * 8 + c0 + (e & 1)] =
          o[nt][e];
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ml_s[(warp * 16 + r0 + h * 8) * 2] = m[h];
      ml_s[(warp * 16 + r0 + h * 8) * 2 + 1] = l[h];
    }
  }
}

// -- CUDA cores: float32 ----------------------------------------------------------

// One warp's pages on the CUDA cores.  Scores: lanes split a chunk's
// tokens (and D into kLq slices), q read from shared memory as float32;
// P V: lanes split D.  Leaves the warp's (O, m, l) in acc_s / ml_s.
template <typename TKV, int D, class Pages>
__device__ __forceinline__ void warp_pages_simt(
    const Pages& pages, const float* q_s, int gn,
    const TKV* __restrict__ k, const TKV* __restrict__ v,
    unsigned char* k_s, unsigned char* v_s, float* p_s, int rh, int j0,
    int j_end, int frontier, float qk_scale, float* acc_s, float* ml_s) {
  using L = Layout<TKV, D>;
  constexpr int kGc = L::kGc, kCt = L::kCt, kDpl = L::kDpl;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane % kCt;      // scoring: this lane's token of a chunk
  const int part = lane / kCt;   // and its slice of D
  const size_t stride = static_cast<size_t>(pages.kv) * D;

  float m[kGc], l[kGc], acc[kGc][kDpl];
#pragma unroll
  for (int g = 0; g < kGc; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kDpl; ++e) acc[g][e] = 0.f;
  }

  // every branch below is uniform across a warp
  for (int j = j0; j < j_end; j += kWarps) {
    size_t base;
    int tok0;
    if (!pages.locate(rh, j, D, base, tok0) || tok0 > frontier) continue;
    const int page = pages.page;
    const int n_page = frontier - tok0 >= page ? page : frontier - tok0 + 1;
    for (int c0 = 0; c0 < n_page; c0 += kCt) {
      const int n = min(kCt, n_page - c0);
      __syncwarp();  // the last chunk's reads of k_s, v_s, p_s are done
      const size_t at = base + c0 * stride;
      stage_rows<TKV, D, false>(k_s, k + at, stride, n, lane);
      cp_async_commit();
      stage_rows<TKV, D, false>(v_s, v + at, stride, n, lane);
      cp_async_commit();
      cp_async_wait<1>();  // K is in; V may still be arriving
      __syncwarp();

      float s[kGc];
#pragma unroll
      for (int g = 0; g < kGc; ++g) s[g] = 0.f;
      const unsigned char* krow = k_s + t * L::kRow + part * L::kEq * L::kSz;
      const float* qp = q_s + part * L::kEq;
#pragma unroll
      for (int c = 0; c < L::kEq / L::kEpv; ++c) {
        float kf[L::kEpv];
        load_f32<TKV, L::kEpv>(krow + c * 16, kf);
#pragma unroll
        for (int g = 0; g < kGc; ++g) {
          if (g >= gn) continue;
          const float4* q4 =
              reinterpret_cast<const float4*>(qp + g * D + c * L::kEpv);
#pragma unroll
          for (int e = 0; e < L::kEpv / 4; ++e) {
            const float4 x = q4[e];
            s[g] += x.x * kf[4 * e] + x.y * kf[4 * e + 1] +
                    x.z * kf[4 * e + 2] + x.w * kf[4 * e + 3];
          }
        }
      }
      // sum a token's D slices; the chunk's first token is live, so the
      // chunk's max is finite and exp(-inf) = 0 drops the masked tokens
      // and the first page's empty history
#pragma unroll
      for (int g = 0; g < kGc; ++g) {
        if (g >= gn) continue;
#pragma unroll
        for (int o = kCt; o < 32; o <<= 1)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
        const float sg = t < n ? s[g] * qk_scale : -INFINITY;
        float mc = sg;
#pragma unroll
        for (int o = 1; o < kCt; o <<= 1)
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
        const float m_new = fmaxf(m[g], mc);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sg - m_new);
        l[g] = l[g] * alpha + (part == 0 ? p : 0.f);
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < kDpl; ++e) acc[g][e] *= alpha;
        if (part == 0) p_s[g * kCt + t] = p;
      }
      cp_async_wait<0>();
      __syncwarp();

      const unsigned char* vcol = v_s + lane * kDpl * L::kSz;
      for (int u0 = 0; u0 < n; u0 += 4) {
        float vf[4][kDpl];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u0 + u < n) {
            load_f32<TKV, kDpl>(vcol + (u0 + u) * L::kRow, vf[u]);
          } else {
#pragma unroll
            for (int e = 0; e < kDpl; ++e) vf[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < kGc; ++g) {
          if (g >= gn) continue;
          const float4 p4 =
              *reinterpret_cast<const float4*>(p_s + g * kCt + u0);
#pragma unroll
          for (int e = 0; e < kDpl; ++e)
            acc[g][e] += p4.x * vf[0][e] + p4.y * vf[1][e] +
                         p4.z * vf[2][e] + p4.w * vf[3][e];
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kGc; ++g)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
  __syncthreads();  // every warp is done with its staging buffers
#pragma unroll
  for (int g = 0; g < kGc; ++g) {
    if (g >= gn) continue;
#pragma unroll
    for (int e = 0; e < kDpl; ++e)
      acc_s[(warp * kGc + g) * D + lane * kDpl + e] = acc[g][e];
    if (lane == 0) {
      ml_s[(warp * kGc + g) * 2] = m[g];
      ml_s[(warp * kGc + g) * 2 + 1] = l[g];
    }
  }
}

// -- the split kernel ----------------------------------------------------------

template <typename TQ, typename TKV, int D, class Pages>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_kernel(Pages pages, const TQ* __restrict__ q,
                    const TKV* __restrict__ k, const TKV* __restrict__ v,
                    TQ* __restrict__ out, float* __restrict__ ws, int G,
                    int pages_per_split, float qk_scale, float kv_scale) {
  using L = Layout<TKV, D>;
  constexpr int kGc = L::kGc, kCt = L::kCt;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);       // [kGc][D]
  float* p_all = q_s + kGc * D;                      // [kWarps][kGc][kCt]
  unsigned char* pool =
      reinterpret_cast<unsigned char*>(p_all + kWarps * kGc * kCt);
  // the pool stages each warp's K and V rows, then holds the warps' states
  float* acc_s = reinterpret_cast<float*>(pool);     // [kWarps][kGc][D]
  float* ml_s = acc_s + kWarps * kGc * D;            // [kWarps][kGc][2]

  const int rh = blockIdx.x;  // row * KV + head
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int g0 = blockIdx.z * kGc;
  const int gn = min(kGc, G - g0);
  const int warp = threadIdx.x >> 5;
  unsigned char* k_s = pool + warp * 2 * kCt * L::kRow;
  unsigned char* v_s = k_s + kCt * L::kRow;
  const int frontier = pages.frontier(rh);
  const int j0 = split * pages_per_split + warp;
  const int j_end = min(pages.k_sel, (split + 1) * pages_per_split);
  const TQ* q_rh = q + (static_cast<size_t>(rh) * G + g0) * D;

  if constexpr (kTensorCores<TQ, TKV, D>) {
    warp_pages_mma<D>(pages, q_rh, gn, k, v, k_s, v_s, rh, j0, j_end,
                      frontier, qk_scale, acc_s, ml_s);
  } else {
    for (int e = threadIdx.x; e < gn * D; e += kThreads)
      q_s[e] = to_f32(q_rh[e]);
    __syncthreads();
    warp_pages_simt<TKV, D>(pages, q_s, gn, k, v, k_s, v_s,
                            p_all + warp * kGc * kCt, rh, j0, j_end,
                            frontier, qk_scale, acc_s, ml_s);
  }
  __syncthreads();

  // the warps' states meet in warp order
  for (int i = threadIdx.x; i < gn * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[(w * kGc + g) * 2]);
    float l_sum = 0.f, o = 0.f;
    if (mx > -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float a = expf(ml_s[(w * kGc + g) * 2] - mx);
        l_sum += ml_s[(w * kGc + g) * 2 + 1] * a;
        o += acc_s[(w * kGc + g) * D + d] * a;
      }
    }
    o *= kv_scale;
    const size_t row = static_cast<size_t>(rh) * G + g0 + g;
    if (n_split == 1) {
      out[row * D + d] = from_f32<TQ>(l_sum > 0.f ? o / l_sum : 0.f);
    } else {
      float* part_row =
          ws + ((static_cast<size_t>(rh) * n_split + split) * G + g0 + g) *
                   (D + 2);
      part_row[d] = o;
      if (d == 0) {
        part_row[D] = mx;
        part_row[D + 1] = l_sum;
      }
    }
  }
}

// out[rh, g, :] from the n_split partials of (rh, g), in split order: one
// block per (rh, g), one thread per element of D
template <typename TQ>
__global__ void __launch_bounds__(256)
decode_merge_kernel(const float* __restrict__ ws, TQ* __restrict__ out,
                    int D, int n_split) {
  const int rh = blockIdx.x;
  const int g = blockIdx.y;
  const int G = gridDim.y;
  const int d = threadIdx.x;
  const size_t split_stride = static_cast<size_t>(G) * (D + 2);
  const float* p0 = ws + (static_cast<size_t>(rh) * n_split * G + g) * (D + 2);
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, p0[s * split_stride + D]);
  float l_sum = 0.f, o = 0.f;
  if (mx > -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      const float* p = p0 + s * split_stride;
      const float a = expf(p[D] - mx);
      l_sum += p[D + 1] * a;
      o += p[d] * a;
    }
  }
  out[(static_cast<size_t>(rh) * G + g) * D + d] =
      from_f32<TQ>(l_sum > 0.f ? o / l_sum : 0.f);
}

// -- host side -----------------------------------------------------------------

template <typename TQ, typename TKV, int D, class Pages>
cudaError_t launch(const Pages& pages, const void* q, const void* k,
                   const void* v, void* out, void* ws, int rkv, int G,
                   int pages_per_split, float kv_scale,
                   cudaStream_t stream) {
  using L = Layout<TKV, D>;
  const int n_split = (pages.k_sel + pages_per_split - 1) / pages_per_split;
  const dim3 grid(rkv, n_split, (G + L::kGc - 1) / L::kGc);
  auto kern = decode_split_kernel<TQ, TKV, D, Pages>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  kern<<<grid, kThreads, L::kSmem, stream>>>(
      pages, static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(out),
      static_cast<float*>(ws), G, pages_per_split, scale * kv_scale,
      kv_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  decode_merge_kernel<TQ><<<dim3(rkv, G), D, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<TQ*>(out), D, n_split);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, class Pages>
cudaError_t launch_d(const Pages& pages, const void* q, const void* k,
                     const void* v, void* out, void* ws, int rkv, int G,
                     int D, int pps, float kv_scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<TQ, TKV, 32>(pages, q, k, v, out, ws, rkv, G, pps,
                                 kv_scale, stream);
    case 64:
      return launch<TQ, TKV, 64>(pages, q, k, v, out, ws, rkv, G, pps,
                                 kv_scale, stream);
    case 128:
      return launch<TQ, TKV, 128>(pages, q, k, v, out, ws, rkv, G, pps,
                                  kv_scale, stream);
    case 256:
      return launch<TQ, TKV, 256>(pages, q, k, v, out, ws, rkv, G, pps,
                                  kv_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ, class Pages>
cudaError_t launch_kv(const Pages& pages, const void* q, const void* k,
                      const void* v, void* out, void* ws, int rkv, int G,
                      int D, int pps, int kv_dtype, float kv_scale,
                      cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_d<TQ, float>(pages, q, k, v, out, ws, rkv, G, D, pps,
                                 kv_scale, stream);
    case 1:
      return launch_d<TQ, __nv_bfloat16>(pages, q, k, v, out, ws, rkv, G, D,
                                         pps, kv_scale, stream);
    case 2:
      return launch_d<TQ, int8_t>(pages, q, k, v, out, ws, rkv, G, D, pps,
                                  kv_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (K/V only); D is 32,
// 64, 128 or 256; ws holds rkv * n_split * G * (D + 2) floats when
// n_split > 1.  Returns cudaGetLastError() after the last launch.
template <class Pages>
cudaError_t run(const Pages& pages, const void* q, const void* k,
                const void* v, void* out, void* ws, int rkv, int G, int D,
                int pages_per_split, int q_dtype, int kv_dtype,
                float kv_scale, void* stream) {
  if (rkv == 0 || G == 0) return cudaSuccess;
  if (pages.k_sel < 1 || pages_per_split < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_kv<float>(pages, q, k, v, out, ws, rkv, G, D,
                              pages_per_split, kv_dtype, kv_scale, s);
    case 1:
      return launch_kv<__nv_bfloat16>(pages, q, k, v, out, ws, rkv, G, D,
                                      pages_per_split, kv_dtype, kv_scale,
                                      s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace decode_split
}  // namespace repro_torch
