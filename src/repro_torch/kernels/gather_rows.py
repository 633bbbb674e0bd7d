"""Row gather, the port's embedding lookup: the CUDA kernel and its
dispatch.

Replaces the TPU kernel ``src/repro/kernels/gather_rows.py``
(``_gather_kernel``).  The kernel source is ``csrc/gather_rows.cu``,
whose header says what bounds it on the H100 and what its design does
about that.  The plain version copies the reference's oracle
``kernels/ref.py::gather_rows_ref`` (``jnp.take(table, idx, axis=0)``),
which is also how the reference embeds tokens.

:func:`gather_rows` runs the plain version for tensors on the CPU and
launches the CUDA kernel for tensors on a card; there is no fallback
between the two.  The kernel copies rows as opaque words, so its result
is bitwise the plain version's.  ``gather_rows.launches`` counts kernel
launches.

Ids outside ``[0, N)``: both versions give a row of zeros and never read
outside the table.  The reference disagrees with itself there: its
oracle ``jnp.take`` gives NaN rows for ``id >= N`` and wraps ``-1`` to
the last row, and its Pallas kernel (interpret mode) clamps ``id >= N``
to the last row.  No serve path makes such ids (tokens come from an
argmax over the vocabulary).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {"gather_rows": [_P] * 3 + [_L] * 3 + [_I] * 2 + [_P]}
_IDX_BYTES = {torch.int32: 4, torch.int64: 8}


def gather_rows_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """idx int [K]; table [N, D] -> table[idx] [K, D], with a row of
    zeros for each id outside [0, N), as the kernel gives."""
    n = table.shape[0]
    ok = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, max(n - 1, 0))]
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=table.dtype))


def gather_rows(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[k] = table[idx[k]]``.

    idx int32 or int64 [K] (repeats allowed; ids outside [0, N) give
    rows of zeros, on the card and on the CPU); table [N, D] of any
    dtype.  Returns [K, D] in table's dtype."""
    if not table.is_cuda:
        return gather_rows_plain(idx, table)
    if idx.dtype not in _IDX_BYTES:
        raise TypeError(f"gather_rows: idx must be int32 or int64, got "
                        f"{idx.dtype}")
    if idx.dim() != 1 or table.dim() != 2:
        raise ValueError(f"gather_rows takes idx [K] and table [N, D], got "
                         f"{tuple(idx.shape)} and {tuple(table.shape)}")
    if idx.device != table.device:
        raise ValueError("gather_rows: idx and table must be on one device")
    if not (idx.is_contiguous() and table.is_contiguous()):
        raise ValueError("gather_rows needs contiguous inputs")
    (k,), (n, d) = idx.shape, table.shape
    out = torch.empty((k, d), dtype=table.dtype, device=table.device)
    row_bytes = d * table.element_size()
    word = next(w for w in (16, 4, 2, 1) if row_bytes % w == 0 and all(
        t.data_ptr() % w == 0 for t in (table, out)))
    lib = _build.load("gather_rows", _SIGNATURES)
    code = lib.gather_rows(_build.ptr(idx), _build.ptr(table),
                           _build.ptr(out), k, n, row_bytes,
                           _IDX_BYTES[idx.dtype], word,
                           _build.stream_ptr(table.device))
    _build.check(code, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
