// Causal GQA flash attention for prefill and dense decode.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py
// (_flash_kernel, public flash_prefill).  Plain version:
// repro_torch/models/layers.py::chunked_attention.
//
//   q      f32|bf16 [B, Sq, H, D]
//   k, v   f32|bf16|int8 [B, Sk, KV, D] (int8 scaled by kv_scale)
//   out    q's dtype [B, Sq, H, D]
//
// Query row i sits at absolute position q_offset + i and, with causal
// set, sees keys 0 .. q_offset + i; query head h reads KV head h / G.
// q_offset = 0 is the TPU kernel; the serve engine's chunked prefill
// passes the chunk's start against the block-table-gathered context, and
// the dense decode step one row at the cache's position.  Ragged edges
// (Sq, Sk not multiples of the tiles) are masked here.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s):
// * the single-batch prefills (B=8, S=1536, H=12, KV=2; B=8, S=1024,
//   H=64, KV=4; D=128) do 58 and 138 GFLOP of causal work on 50-150 MB:
//   operations, about 0.06 and 0.14 ms;
// * a paged prefill chunk (B=1, Sq=256, Sk=1536) makes only 24 (qwen2)
//   or 128 (qwen3-moe) blocks of 128 query rows for 132 SMs, and the
//   dense decode step (Sq=1) 96 blocks of one live row: latency and
//   occupancy, far above their 2-12 us bounds.
//
// bf16 q (k/v bf16 or int8) runs flash_wgmma_kernel on the tensor cores:
// * A block owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each and one producer warpgroup (at D=256 one
//   consumer and 64 rows, whose O accumulator takes 128 registers).  The
//   producer's one thread loads Q once and streams K and V tiles (128
//   keys; 64 at D=256) by TMA into a ring of two stages, guarded by full
//   and empty mbarriers, so loads overlap the products.  The consumers
//   compute S = Q K^T (wgmma m64nKk16, both operands K-major in shared
//   memory) and O += P V (wgmma m64nDk16, P from registers, V MN-major),
//   with the online softmax in registers: row max and sum over the four
//   threads of a row by shuffles, exp2 with 1/sqrt(D) * kv_scale * log2 e
//   folded into one FMA.  Scores never reach device memory.
// * GQA: a block reads KV head h / G; the G blocks of one KV head share
//   its tiles through the 50 MB L2 (a KV head's whole context is at most
//   0.8 MB here), so heads are not packed into the M dimension, which
//   would tie the tile to G (6 does not divide 64).  Measured so, the
//   single-batch prefills run at 340-365 TFLOP/s (PERF.md, section 6).
// * Causal work only: a block stops at the last key its last row sees,
//   a warpgroup skips the tiles past its own rows, and only tiles that
//   cross the diagonal (or Sk) pay for the mask.
// * Filling the card: when the (batch, head, 128-row tile) blocks are
//   fewer than the SMs, the wrapper splits each block's key tiles over
//   `splits` blocks (its rule is in kernels/flash_prefill.py::plan).
//   Each writes its unnormalised O with its row max and sum in float32,
//   and flash_merge_kernel combines them in split order, so the result
//   does not depend on block order.
// * int8 K/V (KV_QSCALE 16: every value is exact in bf16): the producer
//   warpgroup TMA-loads the int8 tile into a staging buffer and writes it
//   as bf16 into the ring stage in the swizzled layout; kv_scale enters
//   the scores' exponent and the output once, in float32.
// * Registers: ptxas gives every thread of the 384 the same 168
//   (setmaxnreg did not change its allocation: a D=256 build with it
//   spilled), which holds O, S and P of a 64-row slice at D <= 128 with
//   no spill; D=256 takes one consumer and 256 threads instead.
// * TMA maps are encoded on the host with cuTensorMapEncodeTiled, looked
//   up at run time through the CUDA runtime (no link against libcuda).
//
// float32 q keeps flash_simt_kernel, the CUDA-core loop of the first
// port: one block per (batch, head, 16-row tile) walks 16-key tiles in
// shared memory in float32, numerics unchanged (no TF32).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = repro_torch::hopper;
using repro_torch::to_f32;

// -- float32 q: the CUDA-core loop ----------------------------------------

constexpr int kThreads = 128;
constexpr int kBQ = 16;  // query rows per block
constexpr int kBK = 16;  // keys per tile

template <typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const float* __restrict__ q, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, float* __restrict__ out, int Sq,
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
      x = q[off] * scale;
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
    out[off] = acc[e] / fmaxf(l_s[i], 1e-30f);
  }
}

template <typename TKV>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int KV, int D,
                        int q_offset, int causal, float kv_scale,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      (2 * kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kBK + 3 * kBQ);
  auto kern = flash_simt_kernel<TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<float*>(out), Sq, Sk, H, KV, D,
      q_offset, causal, 1.f / sqrtf(static_cast<float>(D)), kv_scale);
  return cudaGetLastError();
}

// -- bf16 q: the tensor-core kernel ----------------------------------------

constexpr int kWgThreads = 128;
constexpr int kStages = 2;                    // K/V ring depth

template <int D>
struct Tile {
  // consumer warpgroups of 64 query rows each: two, but one at D=256,
  // whose 128 accumulator registers a thread do not fit the 168 that
  // each of 384 threads gets; each of 256 may have 255
  static constexpr int kConsumers = D == 256 ? 1 : 2;
  static constexpr int kRows = 64 * kConsumers;       // query rows a block
  static constexpr int kThreads = (kConsumers + 1) * kWgThreads;
  static constexpr int kKeys = D == 256 ? 64 : 128;   // keys a tile
  static constexpr int kPanel = D == 32 ? 32 : 64;    // bf16 columns a panel
  static constexpr int kRowBytes = 2 * kPanel;        // = swizzle width
  static constexpr int kPanels = D / kPanel;
  static constexpr uint32_t kQBytes = kRows * D * 2;
  static constexpr uint32_t kKVBytes = kKeys * D * 2;  // K or V, one stage
  static constexpr uint32_t kStageBytes = kKeys * D;   // int8 K or V
};

// shared memory of one block, from a 1024-byte aligned base
template <int D, bool INT8>
struct Smem {
  using T = Tile<D>;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + T::kQBytes;
  static constexpr uint32_t kV = kK + kStages * T::kKVBytes;
  static constexpr uint32_t kK8 = kV + kStages * T::kKVBytes;
  static constexpr uint32_t kV8 = kK8 + (INT8 ? T::kStageBytes : 0);
  static constexpr uint32_t kBars = kV8 + (INT8 ? T::kStageBytes : 0);
  // full[kStages], empty[kStages], q, staged
  static constexpr uint32_t kBytes = kBars + 8 * (2 * kStages + 2);
  static constexpr uint32_t kAlloc = kBytes + 1024;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// byte offset of a 16-byte chunk in a swizzled tile whose base is
// 1024-aligned (hopper.cuh: chunk bits 4-6 XOR row bits 7-9 for 128 B,
// bits 4-5 XOR bits 7-8 for 64 B)
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr uint32_t mask = ROW_BYTES == 128 ? 7 : 3;
  return off ^ (((off >> 7) & mask) << 4);
}

// The producer warpgroup's int8 path: the staged int8 K and V tiles
// [kKeys, D] to bf16 in the stage's swizzled panels.
template <int D>
__device__ __forceinline__ void widen_int8(const int8_t* src, uint8_t* dst,
                                           int pt) {
  using T = Tile<D>;
  constexpr int kChunks = T::kKeys * D / 16;  // 16 int8 values each
#pragma unroll 2
  for (int e = pt; e < kChunks; e += kWgThreads) {
    const int row = e / (D / 16);
    const int col = (e % (D / 16)) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + e * 16);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint4 lo, hi;
    lo.x = pack_bf16(x[0], x[1]);
    lo.y = pack_bf16(x[2], x[3]);
    lo.z = pack_bf16(x[4], x[5]);
    lo.w = pack_bf16(x[6], x[7]);
    hi.x = pack_bf16(x[8], x[9]);
    hi.y = pack_bf16(x[10], x[11]);
    hi.z = pack_bf16(x[12], x[13]);
    hi.w = pack_bf16(x[14], x[15]);
    const uint32_t off = (col / T::kPanel) * (T::kKeys * T::kRowBytes) +
                         row * T::kRowBytes + (col % T::kPanel) * 2;
    *reinterpret_cast<uint4*>(dst + swizzle<T::kRowBytes>(off)) = lo;
    *reinterpret_cast<uint4*>(dst + swizzle<T::kRowBytes>(off + 16)) = hi;
  }
}

// Grid (q tiles * splits, H, B); kThreads threads: the first kConsumers
// warpgroups consume, the last produces.  splits == 1 writes `out` (bf16); otherwise
// split s writes part_o[s] (unnormalised O) and part_ml[s] (row max in
// log2 units, row sum), rows (b * Sq + i) * H + h.
template <int D, bool INT8>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ part_o, float2* __restrict__ part_ml,
                   int B, int Sq, int Sk, int H, int KV, int q_offset,
                   int causal, int splits, float score_log2, float out_scale) {
  using T = Tile<D>;
  using S = Smem<D, INT8>;
  constexpr int kConsumers = T::kConsumers;
  constexpr int kRows = T::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem + S::kQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* q_bar = bars + 2 * kStages;
  uint64_t* staged = q_bar + 1;

  const int split = blockIdx.x % splits;
  const int q0 = (blockIdx.x / splits) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  // the block's keys: up to what its last row sees, cut into tiles, of
  // which this split takes an even share
  const int k_end =
      causal ? max(0, min(Sk, q_offset + min(Sq, q0 + kRows))) : Sk;
  const int n_tiles = (k_end + T::kKeys - 1) / T::kKeys;
  const int t0 = split * n_tiles / splits;
  const int t1 = (split + 1) * n_tiles / splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(&full[s], INT8 ? kWgThreads : 1);
      hw::mbar_init(&empty[s], kConsumers * kWgThreads);
    }
    hw::mbar_init(q_bar, 1);
    hw::mbar_init(staged, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == kConsumers) {
    // ---- producer ----
    const int pt = threadIdx.x - kConsumers * kWgThreads;
    if (pt == 0) {
      hw::mbar_arrive_expect_tx(q_bar, T::kQBytes);
#pragma unroll 1
      for (int p = 0; p < T::kPanels; ++p)
        hw::tma_load_4d(q_s + p * kRows * T::kRowBytes, &map_q, q_bar,
                        p * T::kPanel, h, q0, b);
    }
    if (!INT8 && pt != 0) return;
    for (int t = t0; t < t1; ++t) {
      const int i = t - t0;
      const int s = i % kStages;
      uint8_t* k_s = smem + S::kK + s * T::kKVBytes;
      uint8_t* v_s = smem + S::kV + s * T::kKVBytes;
      hw::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      if (!INT8) {
        hw::mbar_arrive_expect_tx(&full[s], 2 * T::kKVBytes);
#pragma unroll 1
        for (int p = 0; p < T::kPanels; ++p) {
          const uint32_t po = p * T::kKeys * T::kRowBytes;
          hw::tma_load_4d(k_s + po, &map_k, &full[s], p * T::kPanel, kvh,
                          t * T::kKeys, b);
          hw::tma_load_4d(v_s + po, &map_v, &full[s], p * T::kPanel, kvh,
                          t * T::kKeys, b);
        }
      } else {
        if (pt == 0) {
          hw::fence_proxy_async();
          hw::mbar_arrive_expect_tx(staged, 2 * T::kStageBytes);
          hw::tma_load_4d(smem + S::kK8, &map_k, staged, 0, kvh,
                          t * T::kKeys, b);
          hw::tma_load_4d(smem + S::kV8, &map_v, staged, 0, kvh,
                          t * T::kKeys, b);
        }
        hw::mbar_wait(staged, i & 1);
        widen_int8<D>(reinterpret_cast<const int8_t*>(smem + S::kK8), k_s,
                      pt);
        widen_int8<D>(reinterpret_cast<const int8_t*>(smem + S::kV8), v_s,
                      pt);
        hw::fence_proxy_async();
        hw::mbar_arrive(&full[s]);
        // every producer thread is done with the staging buffer before
        // the next tile's TMA overwrites it
        hw::named_bar_sync(1, kWgThreads);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 ----
  const int tid = threadIdx.x % kWgThreads;
  const int lane = tid % 32;
  const int wg_q0 = q0 + 64 * wg;
  const int row0 = wg_q0 + 16 * (tid / 32) + lane / 4;  // and row0 + 8
  const int wg_k_end =
      wg_q0 >= Sq ? 0
                  : (causal ? min(Sk, q_offset + min(Sq, wg_q0 + 64)) : Sk);
  const uint32_t q_addr = hw::smem_addr(q_s) + 64 * wg * T::kRowBytes;
  constexpr uint32_t kSbo = 8 * T::kRowBytes;
  constexpr uint32_t kPanelQ = kRows * T::kRowBytes;
  constexpr uint32_t kPanelKV = T::kKeys * T::kRowBytes;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, raw score units
  float l[2] = {0.f, 0.f};              // this thread's share of the sum

  hw::mbar_wait(q_bar, 0);
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0;
    const int s = i % kStages;
    hw::mbar_wait(&full[s], (i / kStages) & 1);
    const int kt = t * T::kKeys;
    if (kt < wg_k_end) {
      const uint32_t k_addr = hw::smem_addr(smem + S::kK + s * T::kKVBytes);
      const uint32_t v_addr = hw::smem_addr(smem + S::kV + s * T::kKVBytes);
      // S = Q K^T: D / 16 steps of k16
      float sc[T::kKeys / 2];
      hw::wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int panel = j * 16 / T::kPanel;
        const uint32_t off = (j * 16 % T::kPanel) * 2;  // inside the row
        hw::wgmma_ss<T::kKeys>(
            sc,
            hw::make_desc(q_addr + panel * kPanelQ + off, 16, kSbo,
                          T::kRowBytes),
            hw::make_desc(k_addr + panel * kPanelKV + off, 16, kSbo,
                          T::kRowBytes),
            j > 0);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(sc);

      // mask only tiles that cross the diagonal or the end of the keys
      if (kt + T::kKeys > Sk ||
          (causal && kt + T::kKeys - 1 > q_offset + wg_q0)) {
#pragma unroll
        for (int c = 0; c < T::kKeys / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt + 8 * c + 2 * (lane % 4) + (e & 1);
            const int row = row0 + (e >= 2 ? 8 : 0);
            if (key >= Sk || (causal && key > q_offset + row))
              sc[4 * c + e] = -INFINITY;
          }
        }
      }
      // online softmax: rows row0 (r = 0) and row0 + 8 (r = 1)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int c = 0; c < T::kKeys / 8; ++c) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * c], sc[4 * c + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
      }
      float base[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no visible key yet keeps m = -inf and adds nothing
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * score_log2;
        alpha[r] = exp2_approx(m[r] * score_log2 - base[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      uint32_t pa[T::kKeys / 16][4];
#pragma unroll
      for (int c = 0; c < T::kKeys / 8; ++c) {
        const float p0 = exp2_approx(fmaf(sc[4 * c], score_log2, -base[0]));
        const float p1 =
            exp2_approx(fmaf(sc[4 * c + 1], score_log2, -base[0]));
        const float p2 =
            exp2_approx(fmaf(sc[4 * c + 2], score_log2, -base[1]));
        const float p3 =
            exp2_approx(fmaf(sc[4 * c + 3], score_log2, -base[1]));
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        // n8 blocks 2 kk and 2 kk + 1 make the A fragment of k16 step kk
        pa[c / 2][(c % 2) * 2] = pack_bf16(p0, p1);
        pa[c / 2][(c % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c] *= alpha[0];
        o[4 * c + 1] *= alpha[0];
        o[4 * c + 2] *= alpha[1];
        o[4 * c + 3] *= alpha[1];
      }
      // O += P V: kKeys / 16 steps of k16 down the V rows
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kKeys / 16; ++kk) {
        hw::wgmma_rs_mn<D>(
            o, pa[kk],
            hw::make_desc(v_addr + kk * 16 * T::kRowBytes, kPanelKV, kSbo,
                          T::kRowBytes),
            1);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(o);
    }
    hw::mbar_arrive(&empty[s]);
  }

  // the row sums over the four threads of each row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const size_t rid = (static_cast<size_t>(b) * Sq + row) * H + h;
    if (splits == 1) {
      const float inv = out_scale / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst = out + rid * D + 2 * (lane % 4);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
            __floats2bfloat162_rn(o[4 * c + 2 * r] * inv,
                                  o[4 * c + 2 * r + 1] * inv);
      }
    } else {
      const size_t prow = static_cast<size_t>(split) * B * Sq * H + rid;
      float* dst = part_o + prow * D + 2 * (lane % 4);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<float2*>(dst + 8 * c) =
            make_float2(o[4 * c + 2 * r], o[4 * c + 2 * r + 1]);
      }
      if (lane % 4 == 0)
        part_ml[prow] = make_float2(
            m[r] == -INFINITY ? -INFINITY : m[r] * score_log2, l[r]);
    }
  }
}

// One warp per output row: the splits' (O, max, sum) merged in split
// order; rows = B * Sq * H.
__global__ void __launch_bounds__(128)
flash_merge_kernel(const float* __restrict__ part_o,
                   const float2* __restrict__ part_ml,
                   __nv_bfloat16* __restrict__ out, int rows, int D,
                   int splits, float out_scale) {
  const int r = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, part_ml[static_cast<size_t>(s) * rows + r].x);
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 ml = part_ml[static_cast<size_t>(s) * rows + r];
    sum += ml.x == -INFINITY ? 0.f : exp2_approx(ml.x - mx) * ml.y;
  }
  const float inv = out_scale / fmaxf(sum, 1e-30f);
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t row = static_cast<size_t>(s) * rows + r;
      const float x = part_ml[row].x;
      if (x != -INFINITY) acc += exp2_approx(x - mx) * part_o[row * D + d];
    }
    out[static_cast<size_t>(r) * D + d] = __float2bfloat16(acc * inv);
  }
}

template <int D, bool INT8>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, void* part_o, void* part_ml, int B,
                         int Sq, int Sk, int H, int KV, int q_offset,
                         int causal, float kv_scale, int splits,
                         cudaStream_t stream) {
  using T = Tile<D>;
  using S = Smem<D, INT8>;
  CUtensorMap mq, mk, mv;
  const uint32_t q_box[4] = {T::kPanel, 1, T::kRows, 1};
  const uint32_t kv_box[4] = {INT8 ? D : T::kPanel, 1, T::kKeys, 1};
  const uint64_t q_dims[4] = {static_cast<uint64_t>(D),
                              static_cast<uint64_t>(H),
                              static_cast<uint64_t>(Sq),
                              static_cast<uint64_t>(B)};
  const uint64_t kv_dims[4] = {static_cast<uint64_t>(D),
                               static_cast<uint64_t>(KV),
                               static_cast<uint64_t>(Sk),
                               static_cast<uint64_t>(B)};
  const CUtensorMapDataType kv_type = INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int kv_swizzle = INT8 ? 0 : T::kRowBytes;
  if (!hw::encode_map_4d(&mq, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q_dims,
                         q_box, T::kRowBytes) ||
      !hw::encode_map_4d(&mk, k, kv_type, INT8 ? 1 : 2, kv_dims, kv_box,
                         kv_swizzle) ||
      !hw::encode_map_4d(&mv, v, kv_type, INT8 ? 1 : 2, kv_dims, kv_box,
                         kv_swizzle))
    return cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<D, INT8>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kAlloc);
  if (attr != cudaSuccess) return attr;
  const float score_log2 =
      kv_scale / sqrtf(static_cast<float>(D)) * 1.4426950408889634f;
  dim3 grid(((Sq + T::kRows - 1) / T::kRows) * splits, H, B);
  kern<<<grid, T::kThreads, S::kAlloc, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part_o), static_cast<float2*>(part_ml), B, Sq, Sk,
      H, KV, q_offset, causal, splits, score_log2, kv_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int rows = B * Sq * H;
  flash_merge_kernel<<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(part_o),
      static_cast<const float2*>(part_ml), static_cast<__nv_bfloat16*>(out),
      rows, D, splits, kv_scale);
  return cudaGetLastError();
}

template <bool INT8>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, void* part_o, void* part_ml, int B, int Sq,
                        int Sk, int H, int KV, int D, int q_offset,
                        int causal, float kv_scale, int splits,
                        cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_wgmma<32, INT8>(q, k, v, out, part_o, part_ml, B, Sq, Sk,
                                    H, KV, q_offset, causal, kv_scale, splits,
                                    stream);
    case 64:
      return launch_wgmma<64, INT8>(q, k, v, out, part_o, part_ml, B, Sq, Sk,
                                    H, KV, q_offset, causal, kv_scale, splits,
                                    stream);
    case 128:
      return launch_wgmma<128, INT8>(q, k, v, out, part_o, part_ml, B, Sq,
                                     Sk, H, KV, q_offset, causal, kv_scale,
                                     splits, stream);
    case 256:
      return launch_wgmma<256, INT8>(q, k, v, out, part_o, part_ml, B, Sq,
                                     Sk, H, KV, q_offset, causal, kv_scale,
                                     splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (k/v only).  float32 q
// runs the CUDA-core kernel (splits must be 1); bfloat16 q with bfloat16
// or int8 k/v the tensor-core kernel at D 32, 64, 128 or 256, with
// `splits` key splits merged through part_o [splits, B*Sq*H, D] and
// part_ml [splits, B*Sq*H, 2] (float32; unused when splits is 1).
// Returns cudaGetLastError() after the launches.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, void* part_o, void* part_ml, int B,
                             int Sq, int Sk, int H, int KV, int D,
                             int q_offset, int causal, int q_dtype,
                             int kv_dtype, float kv_scale, int splits,
                             void* stream) {
  if (B * Sq * H == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && splits == 1) {
    switch (kv_dtype) {
      case 0:
        return launch_simt<float>(q, k, v, out, B, Sq, Sk, H, KV, D,
                                  q_offset, causal, kv_scale, s);
      case 1:
        return launch_simt<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, D,
                                          q_offset, causal, kv_scale, s);
      case 2:
        return launch_simt<int8_t>(q, k, v, out, B, Sq, Sk, H, KV, D,
                                   q_offset, causal, kv_scale, s);
    }
  }
  if (q_dtype == 1 && splits >= 1) {
    if (Sk == 0)  // no key: the plain version's zero rows
      return cudaMemsetAsync(out, 0,
                             sizeof(__nv_bfloat16) * B * Sq * H * D, s);
    if (kv_dtype == 1)
      return launch_bf16<false>(q, k, v, out, part_o, part_ml, B, Sq, Sk, H,
                                KV, D, q_offset, causal, kv_scale, splits, s);
    if (kv_dtype == 2)
      return launch_bf16<true>(q, k, v, out, part_o, part_ml, B, Sq, Sk, H,
                               KV, D, q_offset, causal, kv_scale, splits, s);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one tensor-core block at head dim D with
// bf16 (kv_dtype 1) or int8 (2) K/V; 0 for what it does not take.
extern "C" int flash_prefill_smem(int D, int kv_dtype) {
  const bool int8 = kv_dtype == 2;
  switch (D) {
    case 32:
      return int8 ? Smem<32, true>::kAlloc : Smem<32, false>::kAlloc;
    case 64:
      return int8 ? Smem<64, true>::kAlloc : Smem<64, false>::kAlloc;
    case 128:
      return int8 ? Smem<128, true>::kAlloc : Smem<128, false>::kAlloc;
    case 256:
      return int8 ? Smem<256, true>::kAlloc : Smem<256, false>::kAlloc;
    default:
      return 0;
  }
}
