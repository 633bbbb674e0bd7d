"""Causal GQA flash attention for prefill: the CUDA kernel and its
dispatch.

Replaces the TPU kernel ``src/repro/kernels/flash_prefill.py``
(``_flash_kernel``) and extends it with ``q_offset``, so the serve
engine's chunked prefill runs it against the block-table-gathered
context.  The kernel source is ``csrc/flash_prefill.cu``, whose header
says what bounds it on the H100 and what its design does about that.
The plain version is ``models.layers.chunked_attention``.

:func:`flash_prefill` runs the plain version for tensors on the CPU and
launches the CUDA kernel for tensors on a card; there is no fallback
between the two.  ``flash_prefill.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.layers import chunked_attention
from ..models.sparse_attention import KV_QSCALE
from . import _build
from ._build import KV_CODES, Q_CODES

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_prefill": [_P] * 4 + [_I] * 10 + [_F, _P]}


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_offset: int = 0, causal: bool = True,
                  logit_softcap: float = 0.0,
                  chunk: int = 1024) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Sk, KV, D]; H = KV * G.  Query row i
    sits at position ``q_offset + i``.  Returns [B, Sq, H, D] in q's
    dtype.  ``chunk`` is the plain version's KV chunk (the reference
    engine's setting), unused by the kernel."""
    if not q.is_cuda:
        return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 chunk=chunk, logit_softcap=logit_softcap)
    if logit_softcap:
        raise NotImplementedError(
            "flash_prefill has no logit soft-capping (qwen2 uses none)")
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if q.dtype not in Q_CODES or k.dtype not in KV_CODES:
        raise TypeError(f"flash_prefill takes q in {list(Q_CODES)} and "
                        f"k/v in {list(KV_CODES)}, got {q.dtype} and "
                        f"{k.dtype}")
    if v.dtype != k.dtype or v.shape != k.shape or k.shape[0] != b \
            or k.shape[3] != d or h % kv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need H divisible by KV)")
    tensors = (q, k, v)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_prefill needs contiguous inputs")
    lib = _build.load("flash_prefill", _SIGNATURES)
    out = torch.empty_like(q)
    kv_scale = 1.0 / KV_QSCALE if k.dtype == torch.int8 else 1.0
    code = lib.flash_prefill(
        *(_build.ptr(t) for t in tensors), _build.ptr(out), b, sq, sk, h,
        kv, d, int(q_offset), int(causal), Q_CODES[q.dtype],
        KV_CODES[k.dtype], kv_scale, _build.stream_ptr(q.device))
    _build.check(code, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
