"""Mixture-of-Experts feed-forward with static per-row capacity.

The port of the reference's ``models/moe.py`` (``_capacity``,
``_route_row``, ``moe_ffn``): top-k routing in float32, then a GShard
capacity dispatch that keeps at most ``cap`` (token, expert) pairs per
expert and drops the rest.  The chunked prefill runs it in every layer,
and so does the decode step when the engine's expert pool is off.

The three expert products run as grouped GEMMs over the dispatched rows
``[E * B * cap, D]`` (one group id per 16 rows, the experts in order):
the ``moe_dispatch_matmul`` kernel with ``kernel="cuda"`` (its plain
version for CPU tensors), ``torch.matmul`` over ``[E, B*cap, D]`` with
``kernel="torch"``.  The reference composes its grouped-GEMM kernel the
same way in its tests (``test_moe_ffn_vs_dispatch_matmul_with_drops``).

The reference ``vmap``s one row's dispatch over the batch; here the
batch is an explicit leading dimension.  Its scatters become index
writes and a gather: every kept pair owns one capacity slot, so the
dispatch is a plain assignment, and each token's combine adds its pairs
in the order the reference's scatter-add visits them (sorted by
expert), with no atomics, so the result does not depend on run order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.moe_dispatch import moe_dispatch_matmul
from .sparse_attention import topk_lowest_index

Params = dict
BLOCK_T = 16          # rows per group id; divides cap, which is 16-aligned


def _capacity(s: int, k: int, e: int, factor: float) -> int:
    cap = int(factor * s * k / e) + 1
    return (cap + 15) // 16 * 16


def _route_row(x: torch.Tensor, router: torch.Tensor, k: int, cap: int):
    """Dispatch plan of each row.  x [B, S, D]; router [D, E] float32.

    Returns (slot, keep, pair_token, order), each [B, S*k] in
    sorted-by-expert order, then the gates and expert ids, each
    [B, S, k] — the reference's ``_route_row`` for every row."""
    b, s, _ = x.shape
    logits = torch.matmul(x.float(), router)                  # [B,S,E]
    # jax.lax.top_k breaks ties at the lowest index
    eids = topk_lowest_index(logits, k)                       # [B,S,k]
    gates = torch.softmax(torch.gather(logits, -1, eids), dim=-1)
    pair_e = eids.reshape(b, s * k)
    # jnp.argsort is stable and jnp.searchsorted left-sided
    order = torch.argsort(pair_e, dim=-1, stable=True)
    sorted_e = torch.gather(pair_e, -1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(s * k, device=x.device) - first
    keep = pos_in_e < cap
    slot = sorted_e * cap + pos_in_e.clamp(max=cap - 1)
    return slot, keep, order // k, order, gates, eids


def _expert_products(xe: torch.Tensor, p: Params, kernel: str):
    """The gated expert MLP on the dispatched rows xe [E, B*cap, D]:
    three grouped GEMMs, through the kernel or ``torch.matmul``.  The
    (possibly strided) weight views are taken as they are, no copy."""
    wg, wu, wd = (p[k].to(xe.dtype) for k in ("we_gate", "we_up",
                                              "we_down"))
    if kernel != "cuda":
        gate = F.silu(torch.matmul(xe, wg))
        return torch.matmul(gate * torch.matmul(xe, wu), wd)
    e, rows, d = xe.shape
    gids = torch.arange(e, dtype=torch.int32, device=xe.device)
    gids = gids.repeat_interleave(rows // BLOCK_T)
    x2 = xe.reshape(e * rows, d)
    gate = F.silu(moe_dispatch_matmul(gids, x2, wg, block_t=BLOCK_T))
    h = gate * moe_dispatch_matmul(gids, x2, wu, block_t=BLOCK_T)
    y = moe_dispatch_matmul(gids, h, wd, block_t=BLOCK_T)
    return y.view(e, rows, -1)


def moe_ffn(x: torch.Tensor, p: Params, cfg,
            capacity_factor: float = 1.25,
            kernel: str = "cuda") -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] through the top-k experts, with static
    capacity (pairs past an expert's capacity are dropped); the expert
    products through the grouped-GEMM kernel (``kernel="cuda"``) or
    ``torch.matmul`` (``"torch"``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, k, e, capacity_factor)
    slot, keep, pair_token, order, gates, eids = _route_row(
        x, p["router"].float(), k, cap)
    bi = torch.arange(b, device=x.device)[:, None].expand_as(slot)
    # dispatch: each kept pair owns its capacity slot
    xg = x.new_zeros((b, e * cap, d))
    xg[bi[keep], slot[keep]] = x[bi[keep], pair_token[keep]]
    xe = xg.view(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    yg = _expert_products(xe, p, kernel)                      # [E,B*cap,D]
    yg = yg.view(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    # combine: each pair's output times its gate, in x's working dtype
    pair_out = torch.where(keep[..., None], yg[bi, slot], 0.0)
    pair_gate = torch.gather(gates.reshape(b, s * k), -1, order).to(
        yg.dtype)
    contrib = pair_out * pair_gate[..., None]         # [B,S*k,D], sorted
    unsorted = torch.empty_like(contrib)
    unsorted[bi, order] = contrib                     # back to (token, j)
    unsorted = unsorted.view(b, s, k, d)
    # the reference's scatter-add visits a token's pairs in sorted
    # order, i.e. by ascending expert id (a token's k ids are distinct)
    by_e = torch.argsort(eids, dim=-1)
    out = torch.zeros((b, s, d), dtype=yg.dtype, device=x.device)
    for j in range(k):
        idx = by_e[:, :, j, None, None].expand(b, s, 1, d)
        out = out + torch.gather(unsorted, 2, idx)[:, :, 0]
    return out.to(x.dtype)
