"""TopK sparse-KV decode attention: the port of the reference's
``models/sparse_attention.py``.

Approximate per-page scores come from a small label cache (page-pooled
key summaries), the TopK pages are selected, and attention reads only
those pages.  Two cache layouts:

* contiguous (the single-batch engine): a stacked ``[L, B, S, KV, D]``
  cache; :func:`select_pages`, :func:`attend_pages` and the
  layer-indexed ``*_full`` variants, with :func:`update_page_summary`
  keeping the label cache current.  :func:`attend_pages` is the plain
  version of the CUDA kernel in ``kernels/sparse_decode_attn.py`` with a
  frontier.
* paged (the continuous-batching engine): a pool of physical pages
  shared by all requests; each request maps logical page j to physical
  page ``bt[j]``.  Selection scores logical pages from the physical
  page-summary pool and returns both index spaces: logical ids feed the
  causal mask (absolute token positions), physical ids feed the gather
  and are the ids the allocator and the NSB accounting count in.
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


# -- contiguous caches ---------------------------------------------------------

def select_pages(q: torch.Tensor, kpage: torch.Tensor, n_pages_valid,
                 k_pages: int) -> torch.Tensor:
    """TopK page ids [B,KV,K] int32 per (batch row, KV head); pages at or
    past ``n_pages_valid`` (an int or a 0-d tensor) score -inf and tie in
    ``jax.lax.top_k``'s order.  q [B,KV,G,D], kpage [B,NP,KV,D]."""
    s = page_scores(q, kpage)                       # [B,KV,NP]
    valid = torch.arange(s.shape[-1], device=s.device) < n_pages_valid
    s = torch.where(valid, s, float("-inf"))
    return topk_lowest_index(s, k_pages).to(torch.int32).contiguous()


def page_token_positions(idx: torch.Tensor, page: int) -> torch.Tensor:
    """Absolute token positions ``[..., P, page]`` (int64) of the tokens
    inside the selected pages ``idx [..., P]``."""
    return (idx.long()[..., None] * page
            + torch.arange(page, device=idx.device))


def gather_pages(cache: torch.Tensor, idx: torch.Tensor,
                 page: int) -> torch.Tensor:
    """cache [B,S,KV,D], idx [B,KV,P] -> the pages [B,KV,P,page,D]."""
    b, s, kv, d = cache.shape
    cp = cache.reshape(b, s // page, page, kv, d)
    bi = torch.arange(b, device=cache.device)[:, None, None]
    hi = torch.arange(kv, device=cache.device)[None, :, None]
    # advanced indices around a slice broadcast to the front
    return cp[bi, idx.long(), :, hi, :]


def attend_pages(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 idx: torch.Tensor, pos, page: int) -> torch.Tensor:
    """Attend q [B,KV,G,D] to the gathered pages idx [B,KV,P] of k/v
    [B,S,KV,D]; tokens at absolute positions past ``pos`` are masked (a
    selected page may straddle the frontier).  Returns [B,KV,G,D] in q's
    dtype.  Unlike the reference's ``attend_pages``, which only ever sees
    float caches, int8 K/V are dequantised here, as in its ``*_full``
    variant."""
    d = q.shape[-1]
    kg = kv_dequant_f32(gather_pages(k, idx, page))
    vg = kv_dequant_f32(gather_pages(v, idx, page))
    scores = torch.einsum("bkgd,bkptd->bkgpt", q.float(), kg) / (d ** 0.5)
    mask = page_token_positions(idx, page) <= pos    # [B,KV,P,page]
    scores = torch.where(mask[:, :, None], scores, float("-inf"))
    flat = scores.reshape(*scores.shape[:-2], -1)
    w = torch.softmax(flat, dim=-1).reshape(scores.shape)
    return torch.einsum("bkgpt,bkptd->bkgd", w, vg).to(q.dtype)


def sparse_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kpage: torch.Tensor, pos: int, *, page: int,
                  k_pages: int) -> torch.Tensor:
    """Select + attend: q [B,KV,G,D] -> [B,KV,G,D]."""
    idx = select_pages(q, kpage, pos // page + 1, k_pages)
    return attend_pages(q, k, v, idx, pos, page)


def gather_pages_full(cache_full: torch.Tensor, li: int, idx: torch.Tensor,
                      page: int) -> torch.Tensor:
    """cache_full [L,B,S,KV,D], idx [B,KV,P] -> [B,KV,P,page,D] of layer
    ``li`` (a view of the layer, then one gather)."""
    return gather_pages(cache_full[li], idx, page)


def attend_pages_full(q, k_full, v_full, li: int, idx, pos,
                      page: int) -> torch.Tensor:
    """q [B,KV,G,D] attends the gathered pages of layer ``li`` of the
    stacked caches."""
    return attend_pages(q, k_full[li], v_full[li], idx, pos, page)


def sparse_decode_full(q, k_full, v_full, kpage_li, li: int, pos: int, *,
                       page: int, k_pages: int) -> torch.Tensor:
    """Layer-indexed sparse decode: ``kpage_li`` [B,NP,KV,D] is this
    layer's label cache; K/V pages gather from the stacked caches."""
    idx = select_pages(q, kpage_li, pos // page + 1, k_pages)
    return attend_pages_full(q, k_full, v_full, li, idx, pos, page)


def update_page_summary(kpage: torch.Tensor, k_new: torch.Tensor, pos: int,
                        page: int) -> torch.Tensor:
    """Running mean of keys per page, updated **in place** (the reference
    returns a new array): kpage [B,NP,KV,D] float32; k_new [B,1,KV,D]
    written at absolute position ``pos``.  Returns ``kpage``."""
    p_id, off = divmod(int(pos), page)
    kpage[:, p_id] = (kpage[:, p_id] * float(off)
                      + k_new[:, 0].to(kpage.dtype)) / (off + 1.0)
    return kpage


# -- paged pools ---------------------------------------------------------------

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
