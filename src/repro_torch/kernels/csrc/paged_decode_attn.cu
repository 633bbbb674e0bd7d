// Paged TopK decode attention on one layer of the physical KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attn.py
// (_paged_kernel, public paged_decode_attn).  Plain version:
// repro_torch/models/sparse_attention.py::attend_pages_paged.
//
//   phys, idx  int32 [R, KV, K]   physical page ids (gather) / logical ids
//                                 (causal frontier mask)
//   pos        int32 [R]          per-request frontier position
//   q          f32|bf16 [R, KV, G, D], D in 32/64/128/256
//   k/v_pool   f32|bf16|int8 [P, page, KV, D] (int8 scaled by 1/KV_QSCALE)
//   out        q's dtype [R, KV, G, D]
//   ws         float32 [R * KV, n_split, G, D + 2] when n_split > 1
//
// What bounds it on the H100: bytes (and the launch below them).  Each
// (request, KV head) reads its live pages once, 2 * page * D elements a
// page, for 4 * G * D flops a token.  The TPU kernel walks the pages as
// a sequential grid axis with the softmax state in VMEM.  The first port
// kept that shape, one block per (request, KV head) walking 64 pages in
// turn with four block barriers a page: 16 blocks for 132 SMs, no page
// in flight while another was scored, 470x its bound.  Now the body of
// decode_split.cuh runs it: a row's pages split over blocks (n_split =
// ceil(K / pages_per_split)), one page to a warp, K and V rows copied
// with 16-byte cp.async all in flight before scoring, bf16 scored and
// accumulated on the tensor cores (mma.sync), an online softmax per warp
// in registers with no barrier in the page loop, and a fixed-order merge
// of the splits.  Page j of row r starts at
// phys[r, h, j] in the pool; its logical id idx[r, h, j] places it for
// the frontier mask tok <= pos[r].
#include "decode_split.cuh"

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns cudaGetLastError() after the last launch.
extern "C" int paged_decode_attn(const void* phys, const void* idx,
                                 const void* pos, const void* q,
                                 const void* k_pool, const void* v_pool,
                                 void* out, void* ws, int R, int KV, int G,
                                 int D, int K, int page, int pages_per_split,
                                 int q_dtype, int kv_dtype, float kv_scale,
                                 void* stream) {
  using namespace repro_torch::decode_split;
  const PagedPages pages{static_cast<const int32_t*>(phys),
                         static_cast<const int32_t*>(idx),
                         static_cast<const int32_t*>(pos), KV, K, page};
  return run(pages, q, k_pool, v_pool, out, ws, R * KV, G, D,
             pages_per_split, q_dtype, kv_dtype, kv_scale, stream);
}
