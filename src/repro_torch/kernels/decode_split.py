"""The split rule of the two TopK decode-attention kernels, and the plain
version of their split-and-merge.

``paged_decode_attn`` and ``sparse_decode_attn`` run one CUDA body
(``csrc/decode_split.cuh``): the K selected pages of each (row, KV head)
are cut into runs of :data:`PAGES_PER_SPLIT` pages, one block a run, and
a second pass merges the runs' partial softmax states in run order.
:func:`n_split` is the one place that says how many runs there are; it
depends on K alone, so a row's result does not depend on the rows
launched beside it.

:func:`split_merge_plain` computes the same partial states per run in
PyTorch and merges them in run order: the merge's contract, held by the
tests against the kernels' plain versions (``attend_pages_paged``,
``attend_pages``, ``sparse_decode_attn_plain``).  No serve path calls it.
:func:`paged_pages` and :func:`contiguous_pages` gather its inputs the
way each kernel addresses its pages.
"""

from __future__ import annotations

import torch

from ..models.sparse_attention import kv_dequant_f32

PAGES_PER_SPLIT = 8
HEAD_DIMS = (32, 64, 128, 256)


def n_split(k_sel: int) -> int:
    """Blocks a (row, KV head) takes: runs of ``PAGES_PER_SPLIT`` of its
    ``k_sel`` selected pages, the last one ragged."""
    if k_sel < 1:
        raise ValueError(f"needs at least one selected page, got {k_sel}")
    return -(-k_sel // PAGES_PER_SPLIT)


def workspace(rows: int, k_sel: int, g: int, d: int,
              device) -> torch.Tensor:
    """The kernels' float32 partials [rows, n_split, G, D + 2] (the
    accumulator, then m and l), every slot of which the split kernel
    writes; empty with one split, where the block writes the output."""
    splits = n_split(k_sel)
    return torch.empty((rows, splits, g, d + 2) if splits > 1 else (0,),
                       dtype=torch.float32, device=device)


def paged_pages(k_pool: torch.Tensor, v_pool: torch.Tensor,
                idx: torch.Tensor, phys: torch.Tensor, pos: torch.Tensor,
                page: int):
    """The pages ``paged_decode_attn`` reads: k/v_pool [P, page, KV, D],
    phys/idx [R, KV, K], pos [R].  Returns float32 K and V pages
    [R, KV, K, page, D] and the live mask [R, KV, K, page] (logical
    position ``idx * page + t`` at or before ``pos``)."""
    kv = k_pool.shape[2]
    hi = torch.arange(kv, device=phys.device)[None, :, None]
    kg, vg = (kv_dequant_f32(t.permute(0, 2, 1, 3)[phys.long(), hi])
              for t in (k_pool, v_pool))
    tok = idx.long()[..., None] * page + torch.arange(page,
                                                      device=idx.device)
    return kg, vg, tok <= pos.long()[:, None, None, None]


def contiguous_pages(k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
                     page: int, pos: int | None = None):
    """The pages ``sparse_decode_attn`` reads: k/v [B, S, KV, D], idx
    [B, KV, K].  An id outside ``[0, S / page)`` reads nothing and its
    tokens are not live; with ``pos`` tokens past it are not live, with
    None every gathered token is (a repeated id counts twice)."""
    b, s, kv, d = k.shape
    n_pages = s // page
    ids = idx.long()
    inside = (ids >= 0) & (ids < n_pages)
    safe = torch.where(inside, ids, 0)
    bi = torch.arange(b, device=k.device)[:, None, None]
    hi = torch.arange(kv, device=k.device)[None, :, None]
    kg, vg = (kv_dequant_f32(t.reshape(b, n_pages, page, kv, d)[bi, safe, :,
                                                                hi, :])
              for t in (k, v))
    live = inside[..., None].expand(*ids.shape, page)
    if pos is not None:
        tok = ids[..., None] * page + torch.arange(page, device=k.device)
        live = live & (tok <= pos)
    return kg, vg, live


def split_merge_plain(q: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
                      live: torch.Tensor) -> torch.Tensor:
    """Attention of q [R, KV, G, D] over the pages kg/vg [R, KV, K, page,
    D] (float32) at the ``live`` tokens [R, KV, K, page], computed as the
    kernels do: per run of ``PAGES_PER_SPLIT`` pages a partial state
    (max ``m``, sum ``l``, accumulator), then the runs merged in order.
    A run with no live token has ``m = -inf``, ``l = 0``; a row with none
    gives zeros.  Returns [R, KV, G, D] in q's dtype."""
    r, kv, k_sel, page, d = kg.shape
    qf = q.float()
    parts = []
    for s in range(n_split(k_sel)):
        run = slice(s * PAGES_PER_SPLIT, (s + 1) * PAGES_PER_SPLIT)
        ks = kg[:, :, run].reshape(r, kv, -1, d)
        vs = vg[:, :, run].reshape(r, kv, -1, d)
        ok = live[:, :, run].reshape(r, kv, 1, -1)
        sc = torch.einsum("bkgd,bktd->bkgt", qf, ks) / (d ** 0.5)
        sc = torch.where(ok, sc, float("-inf"))
        m = sc.amax(dim=-1, keepdim=True)                    # [R,KV,G,1]
        p = torch.where(ok, torch.exp(sc - torch.where(
            torch.isfinite(m), m, 0.0)), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bkgt,bktd->bkgd", p, vs)))
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    safe = torch.where(torch.isfinite(mx), mx, 0.0)
    l_sum = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.where(torch.isfinite(m), torch.exp(m - safe), 0.0)
        l_sum = l_sum + l * w
        acc = acc + a * w
    out = torch.where(l_sum > 0, acc / torch.clamp(l_sum, min=1e-30), 0.0)
    return out.to(q.dtype)
