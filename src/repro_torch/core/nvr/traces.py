"""Workload trace generators — Table II of the paper.

Each generator emits the NPU-visible memory instruction stream of the
workload's sparse inner loops (linear-layer memory access patterns, as the
paper extracts them).  All are parameterised by ``dtype_bytes`` (INT8=1,
FP16=2, INT32=4 — Fig. 5) and a ``scale`` knob for quick tests.

| short | domain             | dominant pattern modelled                      |
|-------|--------------------|------------------------------------------------|
| DS    | LLM (KV sparsity)  | per-step TopK KV-row gather, drifting hot set  |
| GAT   | GNN                | CSR neighbor row gather, two passes (reuse)    |
| GCN   | GNN                | CSR neighbor row gather, power-law hubs        |
| GSABT | sparse attention   | block-sparse key-block gather (long strides)   |
| H2O   | LLM (KV sparsity)  | heavy-hitter KV gather, stable hot set         |
| MK    | point cloud        | 27-neighborhood hash probes (element gather)   |
| SCN   | point cloud        | rulebook offset-grouped gather (quasi-sorted)  |
| ST    | MoE                | expert-blocked streaming (block-local)         |
"""

from __future__ import annotations

import numpy as np

from .trace import Trace, TraceBuilder, chunk_lanes

LINE = 64
MAC_RATE = 128.0  # effective MACs/cycle of the sparse unit (16x16 array, 50% util)

# PCs (arbitrary but stable identifiers for prefetcher tables)
PC_ROWPTR, PC_IDX, PC_GATHER, PC_W, PC_GATHER2 = 0x100, 0x104, 0x108, 0x10C, 0x110


def _row_gather(tb: TraceBuilder, base: int, rows: np.ndarray, row_bytes: int,
                idx_pc: int, pc: int = PC_GATHER, bound: int | None = None) -> None:
    """Gather ``rows`` (16-lane groups); each row spans row_bytes -> emit one
    vector load per 64B slice so long rows create densely packed strides."""
    shift = int(np.log2(row_bytes)) if row_bytes & (row_bytes - 1) == 0 else 0
    n_slices = max(1, row_bytes // LINE)
    for lanes in chunk_lanes(rows):
        for j in range(n_slices):
            if shift:
                tb.indirect_load(pc + j, base + j * LINE, lanes, shift,
                                 idx_pc=idx_pc, bound=bound)
            else:
                addrs_idx = lanes * (row_bytes // max(1, LINE))
                tb.indirect_load(pc + j, base + j * LINE, addrs_idx, 6,
                                 idx_pc=idx_pc, bound=bound)


def _stream_idx(tb: TraceBuilder, base: int, start: int, vals: np.ndarray,
                pc: int = PC_IDX) -> None:
    offs = np.arange(start, start + len(vals), dtype=np.int64)
    tb.stream_load(pc, base, offs, 4)


# ---------------------------------------------------------------------------
# LLM KV-cache sparsity: Double Sparsity (DS) and H2O
# ---------------------------------------------------------------------------

def _kv_topk(name: str, dtype_bytes: int, scale: float, persistence: float,
             seed: int, topk: int = 64, n_ctx: int = 4096,
             heads: int = 4, steps: int = 24) -> Trace:
    rng = np.random.default_rng(seed)
    steps = max(2, int(steps * scale))
    head_dim = 128
    row_bytes = head_dim * dtype_bytes
    tb = TraceBuilder(name)
    kv = [tb.alloc(f"kv_h{h}", n_ctx * row_bytes, indirect=True)
          for h in range(heads)]
    idxb = tb.alloc("topk_idx", steps * heads * topk * 4)
    hot = [rng.choice(n_ctx, size=topk, replace=False) for _ in range(heads)]
    pos = 0
    for s in range(steps):
        for h in range(heads):
            keep = rng.random(topk) < persistence
            idx = hot[h].copy()
            idx[~keep] = rng.choice(n_ctx, size=int((~keep).sum()))
            hot[h] = idx
            tb.new_bound()
            _stream_idx(tb, idxb, pos, idx)
            pos += topk
            _row_gather(tb, kv[h], np.sort(idx), row_bytes, PC_IDX)
            # attention compute: topk * head_dim MACs @256/cyc
            tb.compute(topk * head_dim / MAC_RATE)
    dense_bytes = steps * heads * n_ctx * row_bytes  # full KV scan per step
    return tb.build(dense_compute_scale=n_ctx / topk, dense_bytes=dense_bytes)


def gen_ds(dtype_bytes: int = 2, scale: float = 1.0, seed: int = 0) -> Trace:
    return _kv_topk("DS", dtype_bytes, scale, persistence=0.70, seed=seed)


def gen_h2o(dtype_bytes: int = 2, scale: float = 1.0, seed: int = 1) -> Trace:
    return _kv_topk("H2O", dtype_bytes, scale, persistence=0.88, seed=seed,
                    topk=48)


# ---------------------------------------------------------------------------
# GNNs: GCN / GAT — CSR adjacency feature gather
# ---------------------------------------------------------------------------

def _powerlaw_graph(rng, n: int, avg_deg: int):
    degs = np.clip(rng.zipf(1.7, size=n), 2, 8 * avg_deg)
    degs = (degs * (avg_deg / degs.mean())).astype(np.int64).clip(1, 8 * avg_deg)
    hubs = rng.choice(n, size=max(4, n // 64), replace=False)
    rows = []
    for d in degs:
        k_hub = int(d * 0.3)
        nb = np.concatenate([rng.choice(hubs, size=k_hub),
                             rng.integers(0, n, size=int(d) - k_hub)])
        rows.append(np.sort(nb))
    return rows


def _gnn(name: str, dtype_bytes: int, scale: float, seed: int,
         two_pass: bool) -> Trace:
    rng = np.random.default_rng(seed)
    n = max(256, int(3072 * scale))
    d_feat = 64
    row_bytes = d_feat * dtype_bytes
    rows = _powerlaw_graph(rng, n, avg_deg=8)
    n_rows = max(16, int(220 * scale))
    tb = TraceBuilder(name)
    feat = tb.alloc("features", n * row_bytes, indirect=True)
    colb = tb.alloc("col_indices", sum(len(r) for r in rows) * 4)
    rpb = tb.alloc("rowptr", (n + 1) * 4)
    pos = 0
    order = rng.permutation(n)[:n_rows]
    for r in order:
        nb = rows[r]
        tb.new_bound()
        tb.stream_load(PC_ROWPTR, rpb, np.array([r, r + 1]), 4)
        _stream_idx(tb, colb, pos, nb)
        pos += len(nb)
        _row_gather(tb, feat, nb, row_bytes, PC_IDX)
        tb.compute(len(nb) * d_feat / MAC_RATE)
        if two_pass:  # GAT: edge-softmax then weighted aggregate (reuse)
            _row_gather(tb, feat, nb, row_bytes, PC_IDX, pc=PC_GATHER2)
            tb.compute(len(nb) * d_feat / MAC_RATE)
    dense_bytes = n_rows * n * row_bytes / 8  # dense adjacency row sweep
    return tb.build(dense_compute_scale=n / 8 / 8, dense_bytes=dense_bytes)


def gen_gcn(dtype_bytes: int = 2, scale: float = 1.0, seed: int = 2) -> Trace:
    return _gnn("GCN", dtype_bytes, scale, seed, two_pass=False)


def gen_gat(dtype_bytes: int = 2, scale: float = 1.0, seed: int = 3) -> Trace:
    return _gnn("GAT", dtype_bytes, scale, seed, two_pass=True)


# ---------------------------------------------------------------------------
# GSABT — block-sparse attention: gather random key *blocks*
# ---------------------------------------------------------------------------

def gen_gsabt(dtype_bytes: int = 2, scale: float = 1.0, seed: int = 4) -> Trace:
    rng = np.random.default_rng(seed)
    n_blocks = 256
    tok_per_block, head_dim = 16, 64
    block_bytes = tok_per_block * head_dim * dtype_bytes
    n_q = max(8, int(96 * scale))
    k_sel = 8
    tb = TraceBuilder("GSABT")
    kv = tb.alloc("kv_blocks", n_blocks * block_bytes, indirect=True)
    idxb = tb.alloc("block_idx", n_q * k_sel * 4)
    pos = 0
    for q in range(n_q):
        sel = np.sort(rng.choice(n_blocks, size=k_sel, replace=False))
        tb.new_bound()
        _stream_idx(tb, idxb, pos, sel)
        pos += k_sel
        # token rows inside each selected block (sequential within block)
        tok_rows = (sel[:, None] * tok_per_block
                    + np.arange(tok_per_block)[None, :]).reshape(-1)
        _row_gather(tb, kv, tok_rows, head_dim * dtype_bytes, PC_IDX)
        tb.compute(k_sel * tok_per_block * head_dim / MAC_RATE)
    dense_bytes = n_q * n_blocks * block_bytes
    return tb.build(dense_compute_scale=n_blocks / k_sel,
                    dense_bytes=dense_bytes)


# ---------------------------------------------------------------------------
# Point cloud: MinkowskiNet (hash probes) / SparseConvNet (rulebook)
# ---------------------------------------------------------------------------

def _hash3(c: np.ndarray, size: int) -> np.ndarray:
    h = (c[..., 0] * 73856093) ^ (c[..., 1] * 19349663) ^ (c[..., 2] * 83492791)
    return (h % size).astype(np.int64)


def gen_mk(dtype_bytes: int = 2, scale: float = 1.0, seed: int = 5) -> Trace:
    rng = np.random.default_rng(seed)
    table = 1 << 17           # hash table entries (8 B each)
    n_pts = max(32, int(160 * scale))
    d_feat = 32
    tb = TraceBuilder("MK")
    ht = tb.alloc("hash_table", table * 8, indirect=True)
    feat = tb.alloc("features", table * d_feat * dtype_bytes, indirect=True)
    coords = np.cumsum(rng.integers(-1, 2, size=(n_pts, 3)), axis=0) + 512
    offs = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1]),
                    -1).reshape(-1, 3)
    for p in range(n_pts):
        nb = coords[p][None, :] + offs          # 27 neighbor probes
        probes = _hash3(nb, table)
        tb.new_bound()
        _row_gather(tb, ht, probes, 8, PC_IDX, pc=PC_GATHER)
        hits = probes[rng.random(len(probes)) < 0.5]
        if len(hits):
            _row_gather(tb, feat, hits, d_feat * dtype_bytes, PC_IDX,
                        pc=PC_GATHER2)
        tb.compute(27 * d_feat / MAC_RATE)
    return tb.build(dense_compute_scale=8.0,
                    dense_bytes=n_pts * 64 * d_feat * dtype_bytes)


def gen_scn(dtype_bytes: int = 2, scale: float = 1.0, seed: int = 6) -> Trace:
    rng = np.random.default_rng(seed)
    n_vox = 1 << 14
    n_active = max(64, int(1400 * scale))
    d_feat = 32
    row_bytes = d_feat * dtype_bytes
    tb = TraceBuilder("SCN")
    feat = tb.alloc("features", n_vox * row_bytes, indirect=True)
    ruleb = tb.alloc("rulebook", 27 * n_active * 4)
    active = np.sort(rng.choice(n_vox, size=n_active, replace=False))
    pos = 0
    for off in range(9):     # offset-grouped passes over quasi-sorted lists
        m = rng.random(n_active) < 0.4
        idx = active[m] + rng.integers(-2, 3, size=int(m.sum()))
        idx = np.clip(idx, 0, n_vox - 1)
        tb.new_bound()
        _stream_idx(tb, ruleb, pos, idx)
        pos += len(idx)
        _row_gather(tb, feat, idx, row_bytes, PC_IDX)
        tb.compute(len(idx) * d_feat / MAC_RATE)
    return tb.build(dense_compute_scale=n_vox / n_active,
                    dense_bytes=9 * n_vox * row_bytes / 4)


# ---------------------------------------------------------------------------
# ST — Switch Transformer MoE: expert-blocked streaming
# ---------------------------------------------------------------------------

def gen_st(dtype_bytes: int = 2, scale: float = 1.0, seed: int = 7) -> Trace:
    rng = np.random.default_rng(seed)
    n_exp, d_model, d_ff = 8, 128, 256
    exp_bytes = d_model * d_ff * dtype_bytes
    n_groups = max(8, int(100 * scale))
    tb = TraceBuilder("ST")
    wb = tb.alloc("expert_w", n_exp * exp_bytes, indirect=True)
    route = tb.alloc("route", n_groups * 4)
    # zipf-ish routing: a few experts dominate (block-local, low miss — the
    # paper's noted exception)
    probs = np.array([0.35, 0.25, 0.15, 0.10, 0.06, 0.04, 0.03, 0.02])
    for g in range(n_groups):
        e = rng.choice(n_exp, p=probs)
        tb.new_bound()
        tb.stream_load(PC_ROWPTR, route, np.array([g]), 4)
        # stream a tile of the expert's weights: sequential rows
        n_rows_tile = 32
        start = rng.integers(0, d_ff - n_rows_tile)
        row_ids = e * d_ff + start + np.arange(n_rows_tile)
        _row_gather(tb, wb, row_ids, d_model * dtype_bytes, PC_ROWPTR)
        tb.compute(16 * d_model * n_rows_tile / MAC_RATE)  # GEMM tile: compute-rich
    return tb.build(dense_compute_scale=n_exp / 2,
                    dense_bytes=n_groups * n_exp * exp_bytes // 8)


WORKLOADS = {
    "DS": gen_ds, "GAT": gen_gat, "GCN": gen_gcn, "GSABT": gen_gsabt,
    "H2O": gen_h2o, "MK": gen_mk, "SCN": gen_scn, "ST": gen_st,
}


def make_trace(name: str, dtype_bytes: int = 2, scale: float = 1.0) -> Trace:
    return WORKLOADS[name](dtype_bytes=dtype_bytes, scale=scale)
