"""TopK sparse-KV decode on the physical page pool: the paged half of the
reference's ``models/sparse_attention.py``.

The continuous-batching KV cache is a pool of physical pages shared by
all requests; each request maps logical page j to physical page
``bt[j]``.  Selection scores logical pages from the physical page-summary
pool and returns both index spaces: logical ids feed the causal mask
(absolute token positions), physical ids feed the gather and are the ids
the allocator and the NSB accounting count in.

:func:`attend_pages_paged` is the plain version of the CUDA kernel in
``kernels/paged_decode_attn.py``.
"""

from __future__ import annotations

import torch

# fixed-scale symmetric int8 KV quantisation (RoPE preserves key norms,
# so one static scale suffices); the CUDA kernels dequantise with it too
KV_QSCALE = 16.0


def kv_quant(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype != torch.int8:
        return x.to(dtype)
    return torch.clamp(torch.round(x.float() * KV_QSCALE),
                       -127, 127).to(torch.int8)


def kv_dequant_f32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int8:
        return x.float() * (1.0 / KV_QSCALE)
    return x.float()


def page_scores(q: torch.Tensor, kpage: torch.Tensor) -> torch.Tensor:
    """q [B,KV,G,D], kpage [B,NP,KV,D] -> scores [B,KV,NP] (max over G)."""
    s = torch.einsum("bkgd,bpkd->bkgp", q.float(), kpage.float())
    return s.amax(dim=2)


def topk_lowest_index(s: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, ties to
    the lowest index, in descending score order — ``jax.lax.top_k``'s
    order.  ``torch.topk`` promises no tie order, and when a request has
    fewer valid pages than ``k`` every padded page ties at -inf, so the
    tie order decides which NULL ids land in the selection."""
    return torch.sort(s, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def select_pages_blocktable(q: torch.Tensor, kpage_pool_li: torch.Tensor,
                            block_table: torch.Tensor,
                            n_pages_valid: torch.Tensor, k_pages: int):
    """TopK pages through a block table.

    q [R,KV,G,D]; kpage_pool_li [P,KV,D] (physical page summaries, one
    layer); block_table [R,NL] physical ids (NULL-padded); n_pages_valid
    [R].  Returns (logical idx [R,KV,K], physical idx [R,KV,K]), int32.
    """
    kp = kpage_pool_li[block_table]                 # [R,NL,KV,D]
    s = page_scores(q, kp)                          # [R,KV,NL]
    nl = s.shape[-1]
    valid = (torch.arange(nl, device=s.device)[None, None, :]
             < n_pages_valid[:, None, None])
    s = torch.where(valid, s, float("-inf"))
    idx = topk_lowest_index(s, k_pages)
    bt_b = block_table[:, None, :].expand(idx.shape[0], idx.shape[1], nl)
    phys = torch.gather(bt_b, -1, idx)
    return (idx.to(torch.int32).contiguous(),
            phys.to(torch.int32).contiguous())


def attend_pages_paged(q: torch.Tensor, k_pool_li: torch.Tensor,
                       v_pool_li: torch.Tensor, idx: torch.Tensor,
                       phys: torch.Tensor, pos: torch.Tensor,
                       page: int) -> torch.Tensor:
    """Attend q [R,KV,G,D] to physically gathered pages.

    k_pool_li / v_pool_li [P,page,KV,D] (one layer of the pool); idx
    [R,KV,K] logical page ids (position mask), phys [R,KV,K] physical
    page ids (gather); pos [R] per-request frontier.  Tokens past the
    frontier are masked; fully-masked rows give zeros, not NaNs."""
    kv = k_pool_li.shape[2]
    hi = torch.arange(kv, device=q.device)[None, :, None]
    ph = phys.long()
    # advanced indices (phys [R,KV,K], head [1,KV,1]) broadcast together
    # and pick each KV head's own pages: [R,KV,K,page,D]
    kg = kv_dequant_f32(k_pool_li.permute(0, 2, 1, 3)[ph, hi])
    vg = kv_dequant_f32(v_pool_li.permute(0, 2, 1, 3)[ph, hi])
    d = q.shape[-1]
    scores = torch.einsum("bkgd,bkptd->bkgpt", q.float(), kg) / (d ** 0.5)
    tok = (idx.long()[..., None] * page
           + torch.arange(page, device=q.device))       # [R,KV,K,page]
    mask = tok <= pos.long()[:, None, None, None]
    scores = torch.where(mask[:, :, None], scores, float("-inf"))
    flat = scores.reshape(*scores.shape[:-2], -1)
    m = flat.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(flat), torch.exp(flat - m), 0.0)
    w = (p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
         ).reshape(scores.shape)
    out = torch.einsum("bkgpt,bkptd->bkgd", w, vg)
    return out.to(q.dtype)


def page_summary_from_pool(k_pool_li: torch.Tensor, phys: torch.Tensor,
                           n_tokens: torch.Tensor) -> torch.Tensor:
    """Exact label-cache entries: mean of the first ``n_tokens`` keys of
    each page ``phys``.  k_pool_li [P,page,KV,D]; phys [M]; n_tokens [M]
    (>= 1).  Returns [M,KV,D] float32.  Prefill and decode both
    recompute summaries through this one function, so selection cannot
    drift between them."""
    rows = kv_dequant_f32(k_pool_li[phys.long()])   # [M,page,KV,D]
    page = rows.shape[1]
    tmask = (torch.arange(page, device=rows.device)[None, :, None, None]
             < n_tokens[:, None, None, None])
    cnt = torch.clamp(n_tokens, min=1).float()
    return (rows * tmask).sum(dim=1) / cnt[:, None, None]
