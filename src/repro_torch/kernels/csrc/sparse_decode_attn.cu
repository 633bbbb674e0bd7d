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
//   q      f32|bf16 [B, KV, G, D], D in 32/64/128/256
//   k, v   f32|bf16|int8 [B, S, KV, D] (int8 scaled by 1/KV_QSCALE): one
//                                    layer of the stacked cache, so a
//                                    token's head row is D elements at a
//                                    stride of KV * D
//   out    q's dtype [B, KV, G, D]
//   ws     float32 [B * KV, n_split, G, D + 2] when n_split > 1
//
// Tokens at positions past `frontier` score -inf (the single-batch
// engine's mask: the cache beyond the newest token is zeros); the TPU
// kernel's contract, every gathered token counting, is frontier = INT_MAX.
// Page ids outside [0, S / page) add nothing.
//
// What bounds it on the H100: bytes (and the launch below them).  Each
// (batch row, KV head) reads its P selected pages once, 2 * page * D
// elements a page, for 4 * G * D flops a token.  The first port dealt a
// row's pages to the 8 warps of one block per (row, head, head chunk):
// 16 blocks for 132 SMs at the serve path's shape, 57x its bound.  Now
// the body of decode_split.cuh runs it, shared with paged_decode_attn:
// a row's pages split over blocks (n_split = ceil(P / pages_per_split)),
// one page to a warp, K and V rows copied with 16-byte cp.async all in
// flight before scoring, bf16 scored and accumulated on the tensor cores
// (mma.sync), and a fixed-order merge of the splits.  Page j
// of row b starts at token idx[b, h, j] * page of row b's cache.
#include "decode_split.cuh"

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (K/V only).
// Returns cudaGetLastError() after the last launch.
extern "C" int sparse_decode_attn(const void* idx, const void* q,
                                  const void* k, const void* v, void* out,
                                  void* ws, int B, int S, int KV, int G,
                                  int D, int P, int page, int frontier,
                                  int pages_per_split, int q_dtype,
                                  int kv_dtype, float kv_scale,
                                  void* stream) {
  using namespace repro_torch::decode_split;
  const ContiguousPages pages{static_cast<const int32_t*>(idx), KV, P, page,
                              S, frontier};
  return run(pages, q, k, v, out, ws, B * KV, G, D, pages_per_split,
             q_dtype, kv_dtype, kv_scale, stream);
}
