"""TopK-page decode attention on a contiguous KV cache: the CUDA kernel
and its dispatch.

Replaces the TPU kernel ``src/repro/kernels/sparse_decode_attn.py``
(``_attn_kernel``) and extends it with a frontier ``pos``, so the
single-batch engine's sparse decode (``transformer.decode_step``) runs
it in every layer.  The kernel source is ``csrc/sparse_decode_attn.cu``,
whose header says what bounds it on the H100 and what its design does
about that; it shares its body (``csrc/decode_split.cuh``) and its split
rule (``kernels/decode_split.py``) with ``paged_decode_attn``.

Plain versions: :func:`sparse_decode_attn_plain`, a copy of the
reference's oracle ``kernels/ref.py::sparse_decode_attn_ref`` (every
gathered token counts), and, with a frontier,
``models.sparse_attention.attend_pages`` (tokens past ``pos`` masked).
Both dequantise int8 K/V with ``KV_QSCALE``.

:func:`sparse_decode_attn` runs the plain version for tensors on the CPU
and launches the CUDA kernel for tensors on a card; there is no fallback
between the two.  ``sparse_decode_attn.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.sparse_attention import (KV_QSCALE, attend_pages,
                                       gather_pages, kv_dequant_f32)
from . import _build
from ._build import KV_CODES, Q_CODES
from .decode_split import HEAD_DIMS, PAGES_PER_SPLIT, workspace

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"sparse_decode_attn": [_P] * 6 + [_I] * 11 + [_F, _P]}
_NO_FRONTIER = 2 ** 31 - 1


def sparse_decode_attn_plain(idx: torch.Tensor, q: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor, *,
                             page_size: int) -> torch.Tensor:
    """The TPU kernel's contract: every token of every listed page counts
    (a repeated page twice).  idx [B, KV, P]; q [B, KV, G, D]; k/v
    [B, S, KV, D] -> [B, KV, G, D] in q's dtype."""
    b, hkv, g, d = q.shape
    kg, vg = (kv_dequant_f32(gather_pages(t, idx, page_size)).reshape(
        b, hkv, -1, d) for t in (k, v))
    s_ = torch.einsum("bhgd,bhtd->bhgt", q.float(), kg) / (d ** 0.5)
    p = torch.softmax(s_, dim=-1)
    return torch.einsum("bhgt,bhtd->bhgd", p, vg).to(q.dtype)


def sparse_decode_attn(idx: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, *, page_size: int,
                       pos: int | None = None) -> torch.Tensor:
    """TopK-page decode attention over one layer of a contiguous cache.

    idx int32 [B, KV, P] page ids into [0, S / page_size); q
    [B, KV, G, D] (float32 or bfloat16, D in 32/64/128/256 on the card);
    k/v [B, S, KV, D] (float32, bfloat16 or int8 scaled by
    ``1 / KV_QSCALE``).  With ``pos=None`` every gathered token counts
    (the TPU kernel); with a host int ``pos``, tokens past it score
    -inf (the single-batch engine's frontier).  Returns [B, KV, G, D] in
    q's dtype.  One call is one count in ``launches``, whether or not the
    merge pass runs."""
    if not q.is_cuda:
        if pos is None:
            return sparse_decode_attn_plain(idx, q, k, v,
                                            page_size=page_size)
        return attend_pages(q, k, v, idx, pos, page_size)
    b, kv, g, d = q.shape
    if q.dtype not in Q_CODES or k.dtype not in KV_CODES:
        raise TypeError(f"sparse_decode_attn takes q in {list(Q_CODES)} and "
                        f"k/v in {list(KV_CODES)}, got {q.dtype} and "
                        f"{k.dtype}")
    if v.dtype != k.dtype or v.shape != k.shape:
        raise TypeError("k and v must share a dtype and a shape")
    if d not in HEAD_DIMS:
        raise ValueError(f"sparse_decode_attn takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    s = k.shape[1]
    if k.dim() != 4 or k.shape[0] != b or k.shape[2:] != (kv, d) \
            or s % page_size:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} and page {page_size}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.dim() != 3 or idx.shape[:2] != (b, kv):
        raise ValueError(f"idx {tuple(idx.shape)} is not [B, KV, P]")
    tensors = (idx, q, k, v)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sparse_decode_attn needs contiguous inputs")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must start on 16-byte boundaries")
    k_sel = idx.shape[2]
    lib = _build.load("sparse_decode_attn", _SIGNATURES)
    out = torch.empty_like(q)
    ws = workspace(b * kv, k_sel, g, d, q.device)
    kv_scale = 1.0 / KV_QSCALE if k.dtype == torch.int8 else 1.0
    frontier = _NO_FRONTIER if pos is None else int(pos)
    code = lib.sparse_decode_attn(
        *(_build.ptr(t) for t in tensors), _build.ptr(out), _build.ptr(ws),
        b, s, kv, g, d, k_sel, page_size, frontier, PAGES_PER_SPLIT,
        Q_CODES[q.dtype], KV_CODES[k.dtype], kv_scale,
        _build.stream_ptr(q.device))
    _build.check(code, "sparse_decode_attn")
    sparse_decode_attn.launches += 1
    return out


sparse_decode_attn.launches = 0
