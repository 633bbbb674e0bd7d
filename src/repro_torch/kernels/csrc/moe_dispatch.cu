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
//   x          f32|bf16 [T, K]     contiguous
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
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s), at the three
// shapes the MoE paths give it (qwen3-moe: E = 128 experts, K x N = 4096
// x 1536 for gate and up, 1536 x 4096 for down, block_t 16):
// * a paged prefill chunk (256 tokens: 32 rows an expert, T = 4096) and
//   the single-batch decode step (8 rows x 16 slots: 128 rows an expert,
//   T = 16,384): bytes.  Every expert's weights are read once, 1.61 GB a
//   product, 0.48 ms, against 0.05 and 0.21 ms of tensor-core work.  The
//   weights have to stream at the memory's rate, and no expert's weights
//   may be read twice.
// * the single-batch prefill (8 x 1024 tokens: 768 rows an expert, T =
//   98,304): operations, 1.24 TFLOP a product, 1.25 ms.  The tensor cores
//   have to be kept busy: wgmma on large tiles fed from shared memory.
//
// The bf16 route (grouped_wgmma_kernel) does both:
// * One expert per tile.  A prologue (grouped_tiles_kernel, one block,
//   two block-wide scans, no host sync) cuts the runs of equal group id
//   into tiles of at most 128 rows (two consumer warpgroups of 64):
//   (row0, row_end, expert).  At the chunk and the decode each expert's
//   weights are streamed by exactly one row tile (six at the prefill,
//   sharing them through the 50 MB L2).  A tile's rows past its run are
//   loaded but never stored, and a warpgroup with none of the run's rows
//   (the second, at the chunk's 32 rows) skips its products and only
//   releases the stages; an unknown id's tile loads nothing and stores
//   zeros.
// * wgmma m64n256k16 with both operands in shared memory, float32
//   accumulators in registers (128 a thread): A is the tile's rows of x
//   (K-major), B the expert's next 256 columns, K-major for gate/up (the
//   views' K stride is 1) and MN-major for down and the dense layout
//   (transpose bit set), both read in place through a 3-D tensor map
//   over (inner dim, other dim, E) with the view's strides.
// * A producer warpgroup whose one thread TMA-loads x and w tiles, 64 of
//   K a stage (128-byte swizzled panels; rows past T and columns past K
//   arrive as zeros), into a ring of 4 stages guarded by
//   full and empty mbarriers; the consumers keep one wgmma group in
//   flight before they release a stage.  The blocks are persistent (one
//   per SM) and walk (tile, column block) items with the columns
//   fastest, so the ring runs on from one tile into the next and the
//   blocks in flight share the tile's rows and the expert's weights in
//   the L2.
// * Epilogue, 64 columns at a time (so its buffer leaves room for the
//   fourth stage): the accumulators go to shared memory as bf16 rows
//   and out as 16-byte stores of the live rows.  Each output element is
//   written once, by one block, in a fixed K order: the result is
//   bitwise repeatable and independent of block order.
// * The weights' tensor maps are cached on the host by pointer, shape
//   and strides; x's map is encoded each call.  A map that TMA refuses
//   is an error, never another route.
// The float32 kernel (float32 configs and the checks) is a plain 64 x 64
// CUDA-core tile with 4 x 4 outputs a thread, which walks the runs of
// equal group id inside its tile and zero-fills the rows outside each.

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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "common.cuh"
#include "hopper.cuh"

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

namespace hw = repro_torch::hopper;

// -- the tile list ------------------------------------------------------------

constexpr int kScanThreads = 1024;  // 32 warps
constexpr int kScanItems = 8;       // group ids a thread takes per round

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return max(a, b);
  }
};
struct AddOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a + b;
  }
};

// The exclusive scan of v over the block's kScanThreads threads (x) and
// the block's total (y); `tot` is 32 ints of shared memory.
template <typename Op>
__device__ __forceinline__ int2 block_scan(int v, Op op, int identity,
                                           int* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = op(incl, y);
  }
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = op(t, y);
    }
    tot[lane] = t;
  }
  __syncthreads();
  const int2 r = make_int2(op(warp > 0 ? tot[warp - 1] : identity, excl),
                           tot[31]);
  __syncthreads();  // tot is the next scan's
  return r;
}

// One block of kScanThreads: the runs of equal group id cut into tiles
// of at most bm rows, in row order, as (row0, row_end, expert, 0), and
// their number in *count.  kernels/moe_dispatch.py::dispatch_tiles_plain
// is the contract.  Block j of a run that starts at block js starts the
// tiles whose first row (relative to the run) falls in its rows, and the
// run's last block ends the run's last tile at its own end.
__global__ void __launch_bounds__(kScanThreads)
grouped_tiles_kernel(const int32_t* __restrict__ gids, int nb, int block_t,
                     int bm, int4* __restrict__ tiles,
                     int* __restrict__ count) {
  __shared__ int tot[32];
  int run0 = 0;  // the first block of the run open at this round's start
  int base = 0;  // tiles of the earlier rounds
  for (int r0 = 0; r0 < nb; r0 += kScanThreads * kScanItems) {
    const int j0 = r0 + threadIdx.x * kScanItems;
    int g[kScanItems + 2];  // the ids of blocks j0 - 1 .. j0 + kScanItems
#pragma unroll
    for (int k = 0; k < kScanItems + 2; ++k) {
      const int j = j0 - 1 + k;
      g[k] = j >= 0 && j < nb ? gids[j] : 0;
    }
    int last_start = -1;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int j = j0 + k;
      if (j < nb && (j == 0 || g[k] != g[k + 1])) last_start = j;
    }
    const int2 st = block_scan(last_start, MaxOp(), -1, tot);
    int js = max(run0, st.x);
    int first[kScanItems], cnt[kScanItems], n = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int j = j0 + k;
      cnt[k] = 0;
      first[k] = js;
      if (j < nb) {
        if (j == 0 || g[k] != g[k + 1]) js = j;
        first[k] = js;
        const int a = (j - js) * block_t;
        cnt[k] = ceil_div(a + block_t, bm) - ceil_div(a, bm);
        n += cnt[k];
      }
    }
    const int2 sum = block_scan(n, AddOp(), 0, tot);
    int p = base + sum.x;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int m0 = ceil_div((j0 + k - first[k]) * block_t, bm);
      for (int i = 0; i < cnt[k]; ++i) {
        const int row0 = first[k] * block_t + (m0 + i) * bm;
        tiles[p++] = make_int4(row0, row0 + bm, g[k + 1], 0);
      }
    }
    __syncthreads();  // the tiles are written before their ends are cut
    p = base + sum.x;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int j = j0 + k;
      p += cnt[k];
      if (j < nb && (j == nb - 1 || g[k + 2] != g[k + 1]))
        tiles[p - 1].y = (j + 1) * block_t;
    }
    run0 = max(run0, st.y);
    base += sum.y;
  }
  if (threadIdx.x == 0) *count = base;
}

// -- the bf16 product on the tensor cores -------------------------------------

constexpr int kWgThreads = 128;
constexpr int kBK = 64;  // K a stage: one 128-byte swizzled panel
// dynamic shared memory a block may use, less the alignment slack
constexpr uint32_t kSmemBudget = 232448 - 1024;

// A block owns a kBM x kBN output tile: two consumer warpgroups of 64
// rows each, and one producer warpgroup.
constexpr int kBM = 128;
constexpr int kBN = 256;
// epilogue rows of 64 bf16 columns, padded by 16 bytes so a quad's 4-byte
// writes to eight rows fall in distinct banks (row r starts at bank
// 4 (r % 8)) and eight threads' 16-byte reads of one row too
constexpr uint32_t kEpiPitch = 64 * 2 + 16;

struct Gemm {
  static constexpr int kConsumers = kBM / 64;
  static constexpr int kThreads = (kConsumers + 1) * kWgThreads;
  static constexpr uint32_t kABytes = kBM * kBK * 2;  // x: kBM rows x 128 B
  static constexpr uint32_t kBBytes = kBN * kBK * 2;  // w: kBN x 64 of K
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  // epilogue: each consumer's 64 rows x 64 columns (a quarter of the
  // tile's at a time) as 128-byte rows padded to kEpiPitch
  static constexpr uint32_t kEpiBytes = kBM * kEpiPitch;
  static constexpr int kStages =
      (kSmemBudget - kEpiBytes - 8 * 2 * 8) / kStageBytes;
  // offsets from a 1024-byte aligned base: A and B stages (each a
  // multiple of 1024 bytes, so the swizzle phase is the address's), the
  // epilogue rows, then full[kStages] and empty[kStages]
  static constexpr uint32_t kA = 0;
  static constexpr uint32_t kB = kA + kStages * kABytes;
  static constexpr uint32_t kEpi = kB + kStages * kBBytes;
  static constexpr uint32_t kBars = kEpi + kEpiBytes;
  static constexpr uint32_t kAlloc = kBars + 8 * 2 * kStages + 1024;
  static_assert(kStages >= 2 && kStages <= 8, "ring stages");
  static_assert(kAlloc <= kSmemBudget + 1024, "shared memory");
};

// One stage: 64 of K in four k16 steps, A (64 rows, K-major) and B (kBN
// columns; kMN: MN-major) in the stage's swizzled panels.  `first`
// overwrites d.
template <bool kMN>
__device__ __forceinline__ void mma_stage(float (&d)[kBN / 2],
                                          uint32_t a_addr, uint32_t b_addr,
                                          bool first) {
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    const uint64_t da = hw::make_desc(a_addr + 32 * j, 16, 1024, 128);
    const int scale = first && j == 0 ? 0 : 1;
    if (kMN)  // 16 rows of K a step; the next 64 columns a panel further
      hw::wgmma_ss<kBN, 1>(
          d, da, hw::make_desc(b_addr + j * 16 * 128, 64 * 128, 1024, 128),
          scale);
    else      // 32 bytes of K a step inside the 128-byte rows
      hw::wgmma_ss<kBN>(d, da, hw::make_desc(b_addr + 32 * j, 16, 1024, 128),
                        scale);
  }
}

// Persistent: block b takes work items b, b + gridDim.x, ... of the
// *count tiles x ceil(N / kBN) column blocks, the columns fastest (the
// blocks running together share a tile's rows and one expert's weights
// through the L2).  kMN: w's N stride is 1 (down, and the dense [E, K, N]
// layout; B MN-major), else its K stride is 1 (gate, up; B K-major).
template <bool kMN>
__global__ void __launch_bounds__(Gemm::kThreads, 1)
grouped_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const int4* __restrict__ tiles,
                     const int* __restrict__ count,
                     __nv_bfloat16* __restrict__ out, int K, int N, int E) {
  using G = Gemm;
  constexpr int S = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBars);
  uint64_t* empty = full + S;
  const int n_cols = (N + kBN - 1) / kBN;
  const int n_work = *count * n_cols;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], G::kConsumers * 4);  // one lane a warp
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == G::kConsumers) {
    // ---- producer: one thread keeps the ring full across tiles ----
    if (threadIdx.x != G::kConsumers * kWgThreads) return;
    int it = 0;  // stages filled so far, over every tile of the block
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int4 t = tiles[w / n_cols];
      const int n0 = (w % n_cols) * kBN;
      if (t.z < 0 || t.z >= E) continue;  // zeros: nothing to load
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % S;
        hw::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        hw::mbar_arrive_expect_tx(&full[s], G::kStageBytes);
        uint8_t* a_s = smem + G::kA + s * G::kABytes;
        uint8_t* b_s = smem + G::kB + s * G::kBBytes;
        // rows past T and columns past K arrive as zeros
        hw::tma_load_2d(a_s, &map_x, &full[s], kt * kBK, t.x);
        if (kMN) {
#pragma unroll
          for (int p = 0; p < kBN / 64; ++p)
            hw::tma_load_3d(b_s + p * 64 * 128, &map_w, &full[s], n0 + 64 * p,
                            kt * kBK, t.z);
        } else {
          hw::tma_load_3d(b_s, &map_w, &full[s], kt * kBK, n0, t.z);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile ----
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  uint8_t* epi = smem + G::kEpi + wg * 64 * kEpiPitch;
  float acc[kBN / 2];
  int it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int4 t = tiles[w / n_cols];
    const int n0 = (w % n_cols) * kBN;
    const bool known = t.z >= 0 && t.z < E;
    // this warpgroup's rows to store: those of the run, never past it
    const int rows = min(64, t.y - t.x - 64 * wg);
    const bool live = known && rows > 0;
    if (known) {
      const uint32_t a_off = wg * 64 * 128;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % S;
        hw::mbar_wait(&full[s], (it / S) & 1);
        if (live) {
          hw::wgmma_fence();
          mma_stage<kMN>(acc,
                         hw::smem_addr(smem + G::kA + s * G::kABytes) + a_off,
                         hw::smem_addr(smem + G::kB + s * G::kBBytes),
                         kt == 0);
          hw::wgmma_commit();
          // one group stays in flight; the one before it is done with
          // its stage
          hw::wgmma_wait<1>();
        }
        if (kt > 0 && lane == 0) hw::mbar_arrive(&empty[(it - 1) % S]);
      }
      if (live) {
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
      }
      if (lane == 0) hw::mbar_arrive(&empty[(it - 1) % S]);
    }

    // epilogue, 64 columns at a time: bf16 rows through shared memory,
    // then 16-byte stores of the live rows; an unknown expert's rows are
    // zeros
    const int r = 16 * warp + lane / 4;  // and r + 8
#pragma unroll
    for (int q = 0; q < kBN / 64; ++q) {
      hw::named_bar_sync(1 + wg, kWgThreads);  // the last reads are done
      if (live) {
        uint8_t* o = epi + r * kEpiPitch + 4 * (lane % 4);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int a = 4 * (8 * q + c);
          *reinterpret_cast<__nv_bfloat162*>(o + 16 * c) =
              __floats2bfloat162_rn(acc[a], acc[a + 1]);
          *reinterpret_cast<__nv_bfloat162*>(o + 16 * c + 8 * kEpiPitch) =
              __floats2bfloat162_rn(acc[a + 2], acc[a + 3]);
        }
      }
      hw::named_bar_sync(1 + wg, kWgThreads);
      for (int e = tid; e < rows * 8; e += kWgThreads) {
        const int rr = e / 8, c = e % 8;
        const int col = n0 + 64 * q + 8 * c;
        if (col >= N) continue;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (live)
          v = *reinterpret_cast<const uint4*>(epi + rr * kEpiPitch + 16 * c);
        __nv_bfloat16* dst =
            out + static_cast<size_t>(t.x + 64 * wg + rr) * N + col;
        if (N % 8 == 0) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
          for (int i = 0; i < 8 && col + i < N; ++i) dst[i] = h[i];
        }
      }
    }
  }
}

int num_sms() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

// The weights' tensor maps, cached: a layer's expert views keep their
// pointer, shape and strides from call to call.  The key fixes every
// field of the map, so a hit is right even for a tensor reallocated at
// the same address.
struct WeightKey {
  const void* w;
  long long K, N, E, se, sk, sn;
  int layout;
  bool operator==(const WeightKey& o) const {
    return w == o.w && K == o.K && N == o.N && E == o.E && se == o.se &&
           sk == o.sk && sn == o.sn && layout == o.layout;
  }
};
struct WeightKeyHash {
  size_t operator()(const WeightKey& k) const {
    size_t h = std::hash<const void*>()(k.w);
    for (long long v : {k.K, k.N, k.E, k.se, k.sk, k.sn,
                        static_cast<long long>(k.layout)})
      h = h * 1000003u ^ std::hash<long long>()(v);
    return h;
  }
};

// layout 0: K-major w, a map over (K, N, E) read in boxes of 64 x kBN;
// layout 1: N-major, over (N, K, E) in boxes of 64 x 64.  Strides in
// elements.  False if TMA refuses them.
bool weight_map(CUtensorMap* map, const void* w, int K, int N, int E,
                long long se, long long sk, long long sn, int layout) {
  static std::mutex mu;
  static std::unordered_map<WeightKey, CUtensorMap, WeightKeyHash> cache;
  const WeightKey key{w, K, N, E, se, sk, sn, layout};
  std::lock_guard<std::mutex> lock(mu);
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return true;
  }
  const uint64_t e = static_cast<uint64_t>(E);
  const uint64_t dims0[3] = {static_cast<uint64_t>(K),
                             static_cast<uint64_t>(N), e};
  const uint64_t dims1[3] = {static_cast<uint64_t>(N),
                             static_cast<uint64_t>(K), e};
  const uint64_t strides0[2] = {static_cast<uint64_t>(sn) * 2,
                                static_cast<uint64_t>(se) * 2};
  const uint64_t strides1[2] = {static_cast<uint64_t>(sk) * 2,
                                static_cast<uint64_t>(se) * 2};
  const uint32_t box0[3] = {kBK, kBN, 1};
  const uint32_t box1[3] = {64, kBK, 1};
  const bool ok =
      layout == 0
          ? hw::encode_map(map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dims0,
                           strides0, box0, 128)
          : hw::encode_map(map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dims1,
                           strides1, box1, 128);
  if (!ok) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// One persistent block per SM: the tile count is on the card, and a
// block with no work item exits at once.
template <bool kMN>
cudaError_t launch_wgmma(const CUtensorMap& mx, const CUtensorMap& mw,
                         const int4* tiles, const int* count,
                         __nv_bfloat16* out, int K, int N, int E,
                         cudaStream_t stream) {
  using G = Gemm;
  auto kern = grouped_wgmma_kernel<kMN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kAlloc);
  if (attr != cudaSuccess) return attr;
  kern<<<num_sms(), G::kThreads, G::kAlloc, stream>>>(mx, mw, tiles, count,
                                                      out, K, N, E);
  return cudaGetLastError();
}

// -- float32 on the CUDA cores -------------------------------------------------

// The next run of rows [r0, r1) of one group id inside [r0, mend).
__device__ __forceinline__ int run_end(const int32_t* gids, int r0, int mend,
                                       int block_t, int g) {
  int r1 = min((r0 / block_t + 1) * block_t, mend);
  while (r1 < mend && gids[r1 / block_t] == g) r1 = min(r1 + block_t, mend);
  return r1;
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

// The tile list of the bf16 product (grouped_tiles_kernel) into tiles
// (int4, room for nb * (block_t / bm + 1)) and *count, on the stream.
extern "C" int moe_dispatch_tiles(const void* gids, int nb, int block_t,
                                  int bm, void* tiles, void* count,
                                  void* stream) {
  if (block_t <= 0 || bm <= 0) return cudaErrorInvalidValue;
  grouped_tiles_kernel<<<1, kScanThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gids), nb, block_t, bm,
      static_cast<int4*>(tiles), static_cast<int*>(count));
  return cudaGetLastError();
}

// dtype: 0 = float32 (w through any strides; tiles, count and layout
// unused), 1 = bfloat16 on the tensor cores: layout 0 when w's K stride
// is 1, 1 when its N stride is 1; x's rows, w's other strides and both
// bases 16-byte aligned (TMA); tiles and count the scratch of
// moe_dispatch_tiles at bm = 128 rows a tile.  Strides are in
// elements.  Returns the first CUDA error of the encodes and launches.
extern "C" int moe_dispatch_matmul(const void* gids, const void* x,
                                   const void* w, void* out, void* tiles,
                                   void* count, int T, int K, int N, int E,
                                   int block_t, long long se, long long sk,
                                   long long sn, int dtype, int layout,
                                   void* stream) {
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
  if (dtype != 1 || (layout != 0 && layout != 1))
    return cudaErrorInvalidValue;
  if (K == 0)  // an empty contraction: zeros
    return cudaMemsetAsync(out, 0, sizeof(__nv_bfloat16) * T * N, s);
  CUtensorMap mx, mw;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K),
                              static_cast<uint64_t>(T)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t x_box[2] = {kBK, kBM};
  if (!hw::encode_map(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x_dims,
                      x_strides, x_box, 128) ||
      !weight_map(&mw, w, K, N, E, se, sk, sn, layout))
    return cudaErrorInvalidValue;
  cudaError_t err = static_cast<cudaError_t>(moe_dispatch_tiles(
      gids, T / block_t, block_t, kBM, tiles, count, stream));
  if (err != cudaSuccess) return err;
  const int4* tl = static_cast<const int4*>(tiles);
  const int* cnt = static_cast<const int*>(count);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  return layout == 1
             ? launch_wgmma<true>(mx, mw, tl, cnt, ob, K, N, E, s)
             : launch_wgmma<false>(mx, mw, tl, cnt, ob, K, N, E, s);
}

// Dynamic shared memory of one bf16 block.
extern "C" int moe_dispatch_smem() { return Gemm::kAlloc; }
