"""Causal GQA flash attention for prefill: the CUDA kernels and their
dispatch.

Replaces the TPU kernel ``src/repro/kernels/flash_prefill.py``
(``_flash_kernel``) and extends it with ``q_offset``, so the serve
engine's chunked prefill runs it against the block-table-gathered
context and the dense decode step runs it with one query row.  The
kernel source is ``csrc/flash_prefill.cu``, whose header says what
bounds it on the H100 and what its design does about that.  The plain
version is ``models.layers.chunked_attention``.

:func:`flash_prefill` runs the plain version for tensors on the CPU and
launches a CUDA kernel for tensors on a card; there is no fallback
between the two.  Which kernel a call gets is :func:`plan`'s table, by
the query's and K/V's dtypes:

========  ==========  ==============================================
q         k, v        kernel
========  ==========  ==============================================
float32   any         ``"simt"``: the float32 loop on the CUDA cores
bfloat16  bf16, int8  ``"wgmma"``: tensor cores, D in 32/64/128/256
bfloat16  float32     refused (``TypeError``)
========  ==========  ==============================================

``flash_prefill.launches`` counts calls that launched the kernel; a
call whose keys are split also runs the merge pass, in the same count.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..models.layers import chunked_attention
from ..models.sparse_attention import KV_QSCALE
from . import _build
from ._build import KV_CODES, Q_CODES

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_prefill": [_P] * 6 + [_I] * 10 + [_F, _I, _P],
               "flash_prefill_smem": [_I, _I]}

# (q dtype, k/v dtype) -> kernel
ROUTES = {
    (torch.float32, torch.float32): "simt",
    (torch.float32, torch.bfloat16): "simt",
    (torch.float32, torch.int8): "simt",
    (torch.bfloat16, torch.bfloat16): "wgmma",
    (torch.bfloat16, torch.int8): "wgmma",
}
WGMMA_HEAD_DIMS = (32, 64, 128, 256)
MAX_SPLITS = 16
H100_SMS = 132


@dataclass(frozen=True)
class Plan:
    kernel: str           # "simt" or "wgmma"
    rows: int             # query rows a block
    keys: int             # keys a tile
    splits: int           # blocks sharing one query tile's keys (1: no merge)


def plan(q_dtype, kv_dtype, d: int, b: int, sq: int, sk: int, h: int, *,
         q_offset: int = 0, causal: bool = True,
         num_sms: int = H100_SMS) -> Plan:
    """The kernel, tile and key split of one call.

    Tiles (``"wgmma"``): 128 query rows (two warpgroups of 64) and 128
    keys a block, 64 and 64 at D=256.  Split rule: with ``n`` = b * h *
    ceil(sq / rows) blocks and the longest block's key tiles ``t`` (keys
    up to what the last query row sees), ``splits`` = clamp(num_sms //
    n, 1, min(t, 16)): as many splits as fit the SMs in one wave, so a
    card with fewer blocks than SMs gets them, and a full card gets
    none."""
    kernel = ROUTES.get((q_dtype, kv_dtype))
    if kernel is None:
        raise TypeError(f"flash_prefill takes (q, k/v) dtypes in "
                        f"{sorted((str(a), str(c)) for a, c in ROUTES)}, got "
                        f"{q_dtype} and {kv_dtype}")
    if kernel == "simt":
        return Plan("simt", 16, 16, 1)
    if d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"the tensor-core flash_prefill takes head dims "
                         f"{WGMMA_HEAD_DIMS}, got {d}")
    rows = keys = 64 if d == 256 else 128
    n = b * h * -(-sq // rows)
    k_end = max(0, min(sk, q_offset + sq)) if causal else sk
    tiles = -(-k_end // keys)
    splits = max(1, min(num_sms // max(n, 1), tiles, MAX_SPLITS))
    return Plan("wgmma", rows, keys, splits)


def wgmma_smem_bytes(d: int, kv_dtype) -> int:
    """Dynamic shared memory of one tensor-core block (builds the
    kernel; needs the CUDA toolkit)."""
    lib = _build.load("flash_prefill", _SIGNATURES)
    return lib.flash_prefill_smem(d, KV_CODES[kv_dtype])


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_offset: int = 0, causal: bool = True,
                  logit_softcap: float = 0.0,
                  chunk: int = 1024) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Sk, KV, D]; H = KV * G.  Query row i
    sits at position ``q_offset + i``.  Returns [B, Sq, H, D] in q's
    dtype.  ``chunk`` is the plain version's KV chunk (the reference
    engine's setting), unused by the kernels."""
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
    p = plan(q.dtype, k.dtype, d, b, sq, sk, h, q_offset=int(q_offset),
             causal=causal, num_sms=torch.cuda.get_device_properties(
                 q.device).multi_processor_count)
    lib = _build.load("flash_prefill", _SIGNATURES)
    out = torch.empty_like(q)
    part_o = part_ml = None
    if p.splits > 1:
        rows = b * sq * h
        part_o = torch.empty((p.splits, rows, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((p.splits, rows, 2), dtype=torch.float32,
                              device=q.device)
    kv_scale = 1.0 / KV_QSCALE if k.dtype == torch.int8 else 1.0
    code = lib.flash_prefill(
        *(_build.ptr(t) for t in tensors), _build.ptr(out),
        _build.ptr(part_o) if part_o is not None else None,
        _build.ptr(part_ml) if part_ml is not None else None, b, sq, sk, h,
        kv, d, int(q_offset), int(causal), Q_CODES[q.dtype],
        KV_CODES[k.dtype], kv_scale, p.splits, _build.stream_ptr(q.device))
    _build.check(code, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
