// Row gather: out[k] = table[idx[k]].
//
// Replaces the TPU kernel src/repro/kernels/gather_rows.py
// (_gather_kernel, public gather_rows).  Plain version:
// repro_torch/kernels/gather_rows.py::gather_rows_plain (table[idx]).
//
//   idx    int32|int64 [K]       row ids, repeats allowed
//   table  any dtype [N, row]    rows of row_bytes bytes, contiguous
//   out    table's dtype [K, row]
//
// A gather moves bytes and computes nothing, so the kernel copies each
// row as opaque words: the result is bitwise the plain version's for
// every dtype.  Ids outside [0, N) give a row of zero bytes instead of a
// read outside the table; the plain version gives the same rows (see
// gather_rows.py for where the reference disagrees with itself).
//
// What bounds it on the H100: bytes (each output row read once from the
// table and written once).  The TPU kernel prefetches the ids ahead of a
// sequential grid so the row DMAs overlap; here every thread copies one
// word of one row (16 bytes where the row length and both base addresses
// allow it, else 4, 2 or 1), neighbouring threads take neighbouring words
// of a row so each warp's loads and stores coalesce, and a grid-stride
// loop over all K * words keeps many rows in flight at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename TI, typename W>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const TI* __restrict__ idx, const W* __restrict__ table,
                   W* __restrict__ out, long long K, long long N,
                   long long words) {
  const long long total = K * words;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / words;
    const long long c = i - r * words;
    const long long src = static_cast<long long>(idx[r]);
    W w{};
    if (src >= 0 && src < N) w = table[src * words + c];
    out[i] = w;
  }
}

template <typename TI, typename W>
cudaError_t launch(const void* idx, const void* table, void* out,
                   long long K, long long N, long long row_bytes,
                   cudaStream_t stream) {
  const long long words = row_bytes / static_cast<long long>(sizeof(W));
  const long long total = K * words;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  gather_rows_kernel<TI, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TI*>(idx), static_cast<const W*>(table),
      static_cast<W*>(out), K, N, words);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_w(const void* idx, const void* table, void* out,
                     long long K, long long N, long long row_bytes, int word,
                     cudaStream_t stream) {
  switch (word) {
    case 16:
      return launch<TI, uint4>(idx, table, out, K, N, row_bytes, stream);
    case 4:
      return launch<TI, uint32_t>(idx, table, out, K, N, row_bytes, stream);
    case 2:
      return launch<TI, uint16_t>(idx, table, out, K, N, row_bytes, stream);
    case 1:
      return launch<TI, uint8_t>(idx, table, out, K, N, row_bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// idx_bytes: 4 (int32) or 8 (int64); word: bytes each thread copies (16,
// 4, 2 or 1), which must divide row_bytes and both base addresses.
// Returns cudaGetLastError() after the launch.
extern "C" int gather_rows(const void* idx, const void* table, void* out,
                           long long K, long long N, long long row_bytes,
                           int idx_bytes, int word, void* stream) {
  if (K == 0 || row_bytes == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (idx_bytes) {
    case 4:
      return launch_w<int32_t>(idx, table, out, K, N, row_bytes, word, s);
    case 8:
      return launch_w<int64_t>(idx, table, out, K, N, row_bytes, word, s);
    default:
      return cudaErrorInvalidValue;
  }
}
