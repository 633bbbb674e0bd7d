"""Paged expert-weight pool: MoE expert tiles as pages.

The port of the reference's ``serve/expert_pool.py`` without its NSB
staging tier (that comes with the online runahead slice).

Layout contract (the reference's): each layer's three expert planes
(gate, up, down) are ``F`` rows of ``D`` features — gate and up
transposed from ``[D, F]`` — cut into ``NT = F // tile_rows`` pages of
``tile_rows`` rows.  The pool is ``[n_pages, tile_rows, D]``: page 0 is
the zero scratch page, and page ``1 + (((l*E + e)*3 + plane)*NT + t)``
holds tile ``t`` of ``plane`` of expert ``e`` in layer ``l``, so one
expert's tiles are one contiguous page range.  ``block_table``
``[L, E, 3, NT]`` maps (layer, expert, plane, tile) to that page.

The pool is not a copy: the params' packed expert buffer
(``params.pack_experts``) already holds the demand region in this
order behind ``F`` zero rows, so the pool and :meth:`dense_rows` are
views of it.  At full width the experts are most of the card's memory.

:func:`dense_moe_ffn` (weights gathered from the dense rows) and
:func:`paged_moe_ffn` with ``kernel="torch"`` (gathered from the pool
through the block table) share :func:`route` and :func:`_combine` on
bitwise-identical operands, so they agree bitwise.
``paged_moe_ffn(kernel="cuda")`` runs the two CUDA kernels of
``kernels/moe_dispatch.py`` on the page ids instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.moe_dispatch import moe_paged_down, moe_paged_gateup
from ..models.sparse_attention import topk_lowest_index
from ..params import expert_rows
from . import not_ported

MODES = ("off", "dense", "paged")
PLANE_GATE, PLANE_UP, PLANE_DOWN = 0, 1, 2
N_PLANES = 3


class ExpertPool:
    """Physical expert-weight pool and its block table, over the params'
    packed expert buffer (read-only for the serve lifetime)."""

    def __init__(self, cfg, params, *, tile_rows: int = 32,
                 nsb_slots: int = 0) -> None:
        if nsb_slots > 0:
            raise not_ported("the expert NSB staging tier (nsb_slots > 0)",
                             "3. Online runahead staging")
        lp = params["layers"]
        l, e, d, f = lp["we_gate"].shape
        if f % tile_rows:
            raise ValueError(
                f"expert tile_rows {tile_rows} must divide d_ff_expert "
                f"{f} (pages are fixed-size row tiles)")
        rows = expert_rows(lp)
        if rows is None:
            raise ValueError("ExpertPool needs packed expert weights "
                             "(params.pack_experts)")
        self.n_layers, self.n_experts = l, e
        self.d_model, self.d_ff = d, f
        self.tile_rows = tile_rows
        self.nt = f // tile_rows
        self.n_pages = 1 + l * e * N_PLANES * self.nt
        self._rows = rows
        # page 0 is cut from the zero rows in front of the demand region
        self.pool = rows[f - tile_rows:].view(self.n_pages, tile_rows, d)
        self.block_table = np.arange(
            1, self.n_pages, dtype=np.int32).reshape(l, e, N_PLANES,
                                                     self.nt)

    def pages_for_experts(self, layer: int, eids) -> np.ndarray:
        """All physical pages (3 planes x NT tiles) the given experts of
        ``layer`` occupy: the traffic one routed (token, expert) pair
        demands."""
        eids = np.asarray(eids, dtype=np.int64).reshape(-1)
        return self.block_table[layer, eids].reshape(-1)

    @property
    def pages_per_expert(self) -> int:
        return N_PLANES * self.nt

    @property
    def page_bytes(self) -> int:
        return self.tile_rows * self.d_model * self.pool.element_size()

    @property
    def pool_bytes(self) -> int:
        return self.pool.numel() * self.pool.element_size()

    def table_device(self) -> torch.Tensor:
        """The block table on the pool's device."""
        return torch.as_tensor(self.block_table, device=self.pool.device)

    def dense_rows(self) -> torch.Tensor:
        """The dense baseline view ``[L, E, 3, NT, tile, D]``: the demand
        pages' bytes without the page indirection.  The reference copies
        them (``pool[block_table]``); here it is a view with the same
        values."""
        return self._rows[self.d_ff:].view(
            self.n_layers, self.n_experts, N_PLANES, self.nt,
            self.tile_rows, self.d_model)


def route(xr: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k routing of R single-token rows: float32 logits, top-k with
    ties at the lowest index (``jax.lax.top_k``'s order), softmax over
    the selected gates.  Returns (gates [R, k] float32, eids int32
    [R, k])."""
    logits = torch.matmul(xr.float(), router.float())
    eids = topk_lowest_index(logits, k)
    gates = torch.softmax(torch.gather(logits, -1, eids), dim=-1)
    return gates, eids.to(torch.int32)


def _mix(gates: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The gate-weighted sum of the experts' outputs: [R, K] x [R, K, D]
    -> [R, D] in y's dtype."""
    return torch.matmul(gates.to(y.dtype)[:, None, :], y)[:, 0]


def _combine(xr: torch.Tensor, gates: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """The shared SwiGLU expert mix: ``w`` [R, K, 3, NT, tile, D] holds
    the routed experts' weight tiles, however they were gathered.  Both
    plain FFN variants go through this one function, so equal operands
    give equal bits."""
    r, k = gates.shape
    d = xr.shape[-1]
    w = w.to(xr.dtype)
    wg = w[:, :, PLANE_GATE].reshape(r, k, -1, d)     # [R,K,F,D] views
    wu = w[:, :, PLANE_UP].reshape(r, k, -1, d)
    wd = w[:, :, PLANE_DOWN].reshape(r, k, -1, d)
    xc = xr[:, None, :, None]                         # [R,1,D,1]
    g = torch.matmul(wg, xc)[..., 0]                  # [R,K,F]
    u = torch.matmul(wu, xc)[..., 0]
    h = F.silu(g) * u
    y = torch.matmul(h[:, :, None, :], wd)[:, :, 0]   # [R,K,D]
    return _mix(gates, y)


def dense_moe_ffn(x: torch.Tensor, lp: dict, rows_l: torch.Tensor, cfg):
    """Dense-materialised expert FFN of one decode step of one layer.

    ``x`` [R, 1, D]; ``rows_l`` [E, 3, NT, tile, D], this layer's slice
    of :meth:`ExpertPool.dense_rows`.  Returns ([R, 1, D], eids [R, k])."""
    xr = x[:, 0]
    gates, eids = route(xr, lp["router"], cfg.top_k)
    w = rows_l[eids.long()]                           # [R,K,3,NT,tile,D]
    return _combine(xr, gates, w)[:, None].to(x.dtype), eids


def paged_moe_ffn(x: torch.Tensor, lp: dict, bt_l: torch.Tensor,
                  pool: torch.Tensor, cfg, *, kernel: str = "cuda",
                  probe=None):
    """Paged expert FFN: routed expert ids resolve to physical tile
    pages through the block table.

    ``x`` [R, 1, D]; ``bt_l`` int32 [E, 3, NT], this layer's block-table
    slice; ``pool`` [n_pages, tile, D].  ``kernel="cuda"`` runs the
    gate, up and down projections through ``moe_paged_gateup`` (twice)
    and ``moe_paged_down`` (whose wrappers take their plain versions for
    CPU tensors); ``"torch"`` gathers the tiles and runs
    :func:`_combine`.  ``probe``, on the kernel route, is called with
    the kernels' inputs and outputs.  Returns ([R, 1, D], eids [R, k])."""
    xr = x[:, 0]
    gates, eids = route(xr, lp["router"], cfg.top_k)
    pids = bt_l[eids.long()]                          # [R,K,3,NT]
    if kernel == "cuda":
        pg, pu, pd = (pids[:, :, p].contiguous()
                      for p in (PLANE_GATE, PLANE_UP, PLANE_DOWN))
        g = moe_paged_gateup(pg, xr, pool)
        u = moe_paged_gateup(pu, xr, pool)
        h = F.silu(g) * u
        y = moe_paged_down(pd, h, pool)
        out = _mix(gates, y)
        if probe is not None:
            probe({"x": xr, "pids": pids, "g": g, "u": u, "h": h, "y": y})
    else:
        out = _combine(xr, gates, pool[pids.long()])
    return out[:, None].to(x.dtype), eids
