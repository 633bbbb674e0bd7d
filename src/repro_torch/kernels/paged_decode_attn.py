"""Paged TopK decode attention: the CUDA kernel and its dispatch.

Replaces the TPU kernel ``src/repro/kernels/paged_decode_attn.py``
(``_paged_kernel``).  The kernel source is ``csrc/paged_decode_attn.cu``,
whose header says what bounds it on the H100 and what its design does
about that.  The plain version is
``models.sparse_attention.attend_pages_paged``; the split rule and the
plain version of the split-and-merge the kernel runs are in
``kernels/decode_split.py``.

:func:`paged_decode_attn` runs the plain version for tensors on the CPU
and launches the CUDA kernel for tensors on a card; there is no fallback
between the two.  ``paged_decode_attn.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.sparse_attention import KV_QSCALE, attend_pages_paged
from . import _build
from ._build import KV_CODES, Q_CODES
from .decode_split import HEAD_DIMS, PAGES_PER_SPLIT, workspace

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"paged_decode_attn": [_P] * 8 + [_I] * 9 + [_F, _P]}


def paged_decode_attn(phys: torch.Tensor, idx: torch.Tensor,
                      pos: torch.Tensor, q: torch.Tensor,
                      k_pool: torch.Tensor, v_pool: torch.Tensor, *,
                      page_size: int) -> torch.Tensor:
    """TopK paged decode attention over one layer of the physical pool.

    phys/idx int32 [R, KV, K] physical / logical page ids; pos int32 [R]
    frontiers; q [R, KV, G, D] (float32 or bfloat16, D in 32/64/128/256
    on the card); k/v_pool [P, page, KV, D] (float32, bfloat16 or int8
    scaled by ``1 / KV_QSCALE``).  Returns [R, KV, G, D] in q's dtype;
    fully-masked rows are zeros.  One call is one count in
    ``launches``, whether or not the merge pass runs."""
    if not q.is_cuda:
        return attend_pages_paged(q, k_pool, v_pool, idx, phys, pos,
                                  page_size)
    r, kv, g, d = q.shape
    k_sel = phys.shape[-1]
    if q.dtype not in Q_CODES or k_pool.dtype not in KV_CODES:
        raise TypeError(f"paged_decode_attn takes q in {list(Q_CODES)} "
                        f"and pools in {list(KV_CODES)}, got {q.dtype} "
                        f"and {k_pool.dtype}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("k_pool and v_pool must share a dtype")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attn takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if k_pool.shape[1:] != (page_size, kv, d) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not match "
                         f"page {page_size}, q {tuple(q.shape)}")
    if phys.shape != (r, kv, k_sel) or idx.shape != phys.shape \
            or pos.shape != (r,):
        raise ValueError("phys/idx must be [R, KV, K] and pos [R]")
    for name, t in (("phys", phys), ("idx", idx), ("pos", pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    tensors = (phys, idx, pos, q, k_pool, v_pool)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attn needs contiguous inputs")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools must start on 16-byte boundaries")
    lib = _build.load("paged_decode_attn", _SIGNATURES)
    out = torch.empty_like(q)
    ws = workspace(r * kv, k_sel, g, d, q.device)
    kv_scale = 1.0 / KV_QSCALE if k_pool.dtype == torch.int8 else 1.0
    code = lib.paged_decode_attn(
        *(_build.ptr(t) for t in tensors), _build.ptr(out), _build.ptr(ws),
        r, kv, g, d, k_sel, page_size, PAGES_PER_SPLIT, Q_CODES[q.dtype],
        KV_CODES[k_pool.dtype], kv_scale, _build.stream_ptr(q.device))
    _build.check(code, "paged_decode_attn")
    paged_decode_attn.launches += 1
    return out


paged_decode_attn.launches = 0
