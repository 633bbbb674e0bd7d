"""Trace-capture adapters: turn *real* model/serving traffic into traces.

The synthetic generators in :mod:`.traces` model Table-II workloads; this
module closes the loop with the rest of the repo by recording the actual
gather traffic the serving and model layers produce and lowering it into
the same :class:`~.trace.Trace` format the simulator consumes:

* :class:`PageStream` — a generic recorder for "select K rows of a table"
  events (TopK KV pages, MoE expert weight tiles, CSR rows, ...).
* :func:`to_trace` — lowers a recorded stream into the paper's
  (index stream load -> indirect row gather -> compute) bundle shape.
* :func:`kv_page_stream` — recorder preconfigured for TopK sparse-KV
  decode page selections (``serve.Engine`` / ``sparse_attention``).
* :func:`moe_expert_stream` — converts an MoE routing decision
  (per-token expert ids, as produced by ``kernels.ops
  .group_tokens_by_expert``) into expert-weight-tile gather traffic.
* :class:`PageCache` — the NSB hot-set model backed by the shared
  :class:`~.machine.Cache`, replacing the serving engine's ad-hoc LRU.

Everything here is numpy-only: the jax layers hand over concrete index
arrays (selections are materialised on host in the serving loop anyway),
so the simulator core stays importable without jax.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .machine import Cache, LINE_BYTES, _E_PF
from .trace import Trace, TraceBuilder
from .traces import MAC_RATE, PC_IDX, _row_gather, _stream_idx

# memory-hierarchy tier tags for recorded page events (see
# docs/MEMORY_HIERARCHY.md): which tier *served or received* the pages
# of an event.  -1 = untagged (historic streams; treated as HBM demand).
TIER_HBM = 0        # demand-pool gather (the authoritative tier)
TIER_NSB = 1        # staged into / served from the NSB hot tail
TIER_HOST = 2       # host spill-tier transfer (swap-out or swap-in)


@dataclass
class PageStream:
    """Recorded row-selection traffic against one indexed table.

    ``events`` is a list of int arrays; each array holds the row ids one
    selection event touched (one decode step for one (batch, head) slot,
    one routed token block, ...).

    Multi-tenant traffic is tagged: ``rids[i]`` / ``steps[i]`` carry the
    request id and scheduler iteration that produced ``events[i]`` (-1
    when untagged, e.g. single-batch capture).  Tensor-parallel traffic
    adds ``shards[i]``: the model shard whose KV heads produced the
    selection (-1 when serving is single-shard) — each shard owns its own
    NSB, so per-shard streams replay through per-shard hot-set models
    (:func:`nsb_shard_rollup`).  Memory-tier traffic adds ``tiers[i]``:
    which hierarchy tier the event's pages moved through (``TIER_HBM``
    demand gathers, ``TIER_NSB`` staging copies, ``TIER_HOST`` spill
    swaps; -1 when untagged).  Tags are metadata only — ``to_trace``
    lowers events in recorded order, so a continuous-batching engine's
    interleaving is exactly what the simulator replays.
    """

    name: str
    n_rows: int             # number of rows in the indexed table
    row_bytes: int          # bytes gathered per selected row
    compute_per_row: float  # compute cycles per gathered row
    events: list = field(default_factory=list)
    rids: list = field(default_factory=list)
    steps: list = field(default_factory=list)
    shards: list = field(default_factory=list)
    tiers: list = field(default_factory=list)

    def record(self, idx, *, rid: int = -1, step: int = -1,
               shard: int = -1, tier: int = -1) -> None:
        """Record one selection event (any int array-like of row ids)."""
        arr = np.asarray(idx, dtype=np.int64).reshape(-1)
        if arr.size:
            self.events.append(arr)
            self.rids.append(int(rid))
            self.steps.append(int(step))
            self.shards.append(int(shard))
            self.tiers.append(int(tier))

    def record_batched(self, idx, *, rid: int = -1, step: int = -1,
                       shard: int = -1, tier: int = -1) -> None:
        """Record ``idx[..., K]`` as one event per leading slot — e.g. a
        ``[B, KV, K]`` TopK selection becomes ``B*KV`` events.  Empty
        rows (K == 0) are skipped, matching :meth:`record` — zero-length
        events would poison ``to_trace`` with empty bundles."""
        arr = np.asarray(idx, dtype=np.int64)
        if not arr.size:            # [B, KV, 0] selection: nothing chosen
            return
        for row in arr.reshape(-1, arr.shape[-1]):
            self.events.append(row.copy())
            self.rids.append(int(rid))
            self.steps.append(int(step))
            self.shards.append(int(shard))
            self.tiers.append(int(tier))

    @property
    def n_events(self) -> int:
        return len(self.events)

    @property
    def rows_selected(self) -> int:
        return sum(len(e) for e in self.events)

    # -- multi-request views -------------------------------------------------

    def request_ids(self) -> list:
        """Distinct request tags in first-appearance order (without -1)."""
        seen: dict = {}
        for r in self.rids:
            if r >= 0 and r not in seen:
                seen[r] = None
        return list(seen)

    def events_for(self, rid: int) -> list:
        """One request's events as ``(step, row-id array)`` in order."""
        return [(s, e) for e, r, s in zip(self.events, self.rids,
                                          self.steps) if r == rid]

    def _filtered(self, suffix: str, pred) -> "PageStream":
        """A new stream over the same table holding the events where
        ``pred(rid, shard, tier)`` is true, all tags preserved."""
        sub = PageStream(name=f"{self.name}/{suffix}", n_rows=self.n_rows,
                         row_bytes=self.row_bytes,
                         compute_per_row=self.compute_per_row)
        for ev, r, st, sh, ti in zip(self.events, self.rids, self.steps,
                                     self.shards, self.tiers):
            if pred(r, sh, ti):
                sub.record(ev, rid=r, step=st, shard=sh, tier=ti)
        return sub

    def subset(self, rid: int) -> "PageStream":
        """A single request's traffic as its own stream (same table)."""
        return self._filtered(f"r{rid}", lambda r, sh, ti: r == rid)

    # -- memory-tier views ---------------------------------------------------

    def tier_ids(self) -> list:
        """Distinct tier tags in first-appearance order (without -1)."""
        seen: dict = {}
        for t in self.tiers:
            if t >= 0 and t not in seen:
                seen[t] = None
        return list(seen)

    def subset_tier(self, tier: int) -> "PageStream":
        """One memory tier's traffic as its own stream: e.g.
        ``subset_tier(TIER_HOST)`` isolates the spill swap transfers
        from the demand gathers they hide behind.  Untagged events
        (``tier == -1``, historic recorders) count as ``TIER_HBM``."""
        return self._filtered(
            f"tier{tier}",
            lambda r, sh, ti: ti == tier
            or (tier == TIER_HBM and ti < 0))

    # -- tensor-parallel views -----------------------------------------------

    def shard_ids(self) -> list:
        """Distinct shard tags in first-appearance order (without -1)."""
        seen: dict = {}
        for s in self.shards:
            if s >= 0 and s not in seen:
                seen[s] = None
        return list(seen)

    def subset_shard(self, shard: int) -> "PageStream":
        """One model shard's traffic as its own stream: the page
        selections its KV heads produced, in recorded order — the
        traffic that shard's private NSB sees."""
        return self._filtered(f"shard{shard}",
                              lambda r, sh, ti: sh == shard)

    def interleave_spans(self) -> dict:
        """Per-request (first, last) positions in the recorded order —
        overlapping spans mean the requests' traffic interleaves."""
        spans: dict = {}
        for i, r in enumerate(self.rids):
            if r < 0:
                continue
            first, _ = spans.get(r, (i, i))
            spans[r] = (first, i)
        return spans

    def to_trace(self) -> Trace:
        return to_trace(self)


def to_trace(stream: PageStream) -> Trace:
    """Lower a recorded stream into a simulator trace.

    Each event becomes one sparse loop instance (bound): a stream load of
    the selected row ids, an indirect gather of the (sorted) rows, and
    the compute tile those rows feed — exactly the bundle shape the
    synthetic Table-II generators emit, so every prefetcher model sees
    the hardware-visible fields it expects.
    """
    if not stream.events:
        raise ValueError(f"PageStream {stream.name!r} has no recorded "
                         "events; run traffic through the recorder first")
    tb = TraceBuilder(stream.name)
    table = tb.alloc("table", stream.n_rows * stream.row_bytes,
                     indirect=True)
    idxb = tb.alloc("idx", max(4, stream.rows_selected * 4))
    pos = 0
    for ev in stream.events:
        tb.new_bound()
        _stream_idx(tb, idxb, pos, ev)
        pos += len(ev)
        _row_gather(tb, table, np.sort(ev), stream.row_bytes, PC_IDX)
        tb.compute(len(ev) * stream.compute_per_row)
    mean_k = stream.rows_selected / stream.n_events
    dense_bytes = stream.n_events * stream.n_rows * stream.row_bytes
    return tb.build(dense_compute_scale=stream.n_rows / max(1.0, mean_k),
                    dense_bytes=dense_bytes)


# -- concrete adapters --------------------------------------------------------

def kv_page_stream(name: str, n_pages: int, page_tokens: int, head_dim: int,
                   dtype_bytes: int = 2) -> PageStream:
    """Recorder for TopK sparse-KV decode: one row = one K+V page."""
    row_bytes = 2 * page_tokens * head_dim * dtype_bytes   # K and V planes
    comp = page_tokens * head_dim / MAC_RATE               # qk^T + pv MACs
    return PageStream(name=name, n_rows=n_pages, row_bytes=row_bytes,
                      compute_per_row=comp)


def moe_expert_stream(expert_ids, n_experts: int, d_model: int, d_ff: int,
                      dtype_bytes: int = 2, block_t: int = 16,
                      tile_rows: int = 32,
                      name: str = "MoE-route") -> PageStream:
    """Convert an MoE routing decision into expert weight-tile traffic.

    ``expert_ids`` is either ``[T]`` per-token routed experts (the top-1
    view the MoE dispatch / ``group_tokens_by_expert`` consumes) or
    ``[T, k]`` full top-k selections straight from the router
    (``jax.lax.top_k`` output): each of the ``T*k`` (token, expert)
    pairs demands its expert's weights, so a top-k matrix is the same
    traffic as ``T*k`` top-1 tokens — the flattening below *is* the
    semantics, not a shape accident.  Tokens are grouped per expert into
    ``block_t``-token blocks; each block streams a ``tile_rows``-row
    tile of its expert's weight matrix — the expert-blocked pattern of
    the paper's ST workload, but driven by real routing instead of a
    synthetic zipf draw.
    """
    raw = np.asarray(expert_ids, dtype=np.int64)
    if raw.ndim not in (1, 2):
        raise ValueError(
            f"expert_ids must be [T] top-1 or [T, k] top-k routed expert "
            f"ids, got shape {raw.shape}")
    eids = raw.reshape(-1)
    if eids.size and (eids.min() < 0 or eids.max() >= n_experts):
        raise ValueError(
            f"routed expert ids must lie in [0, {n_experts}), got range "
            f"[{eids.min()}, {eids.max()}]")
    stream = PageStream(name=name, n_rows=n_experts * d_ff,
                        row_bytes=d_model * dtype_bytes,
                        compute_per_row=16 * d_model / MAC_RATE)
    # clamp the tile to the expert's row range: with d_ff <= tile_rows an
    # unclamped tile would spill into the next expert's rows (and past
    # n_rows for the last expert)
    tile = min(tile_rows, d_ff)
    span = d_ff - tile + 1                 # valid tile start positions
    for e in range(n_experts):
        count = int((eids == e).sum())
        n_blocks = (count + block_t - 1) // block_t
        for bi in range(n_blocks):
            start = (bi * tile) % span
            rows = e * d_ff + start + np.arange(tile, dtype=np.int64)
            stream.record(rows)
    return stream


def expert_page_stream(name: str, n_pages: int, tile_rows: int,
                       d_model: int, dtype_bytes: int = 2) -> PageStream:
    """Recorder for paged expert-weight serving: one row = one expert
    weight tile page of the :class:`~repro_torch.serve.expert_pool.ExpertPool`
    physical id space (``[tile_rows, d_model]`` of one gate/up/down
    plane).  Events are the tile pages one decode step's routing
    demanded (``TIER_HBM``) or the runahead stage copied into the NSB
    tail (``TIER_NSB``) — the expert twin of :func:`kv_page_stream`."""
    row_bytes = tile_rows * d_model * dtype_bytes
    comp = tile_rows * d_model / MAC_RATE      # one MAC per weight elem
    return PageStream(name=name, n_rows=n_pages, row_bytes=row_bytes,
                      compute_per_row=comp)


class PageCache:
    """NSB hot-set model over page ids, backed by the shared
    :class:`~.machine.Cache` (one fully-associative LRU set) — the same
    memory-system model the simulator uses, replacing the serving
    engine's ad-hoc ``HotSet`` LRU so the two layers cannot drift.

    Two usage modes share the accounting:

    * demand-LRU (the historic behaviour): every :meth:`touch` installs
      on miss — what the NSB hit rate "would have been" for an LRU tier.
    * speculative (the online runahead tier's twin): pages enter only
      through :meth:`stage` (counted as prefetch fills by the underlying
      :class:`~.machine.Cache` stats) and demand traffic probes with
      ``install=False`` — misses never install, exactly the physical
      staging buffer's behaviour.  :attr:`accuracy` (staged pages that
      got used) and :attr:`coverage` (demand touches served) then fall
      straight out of the Cache's built-in prefetch accounting.
    """

    def __init__(self, capacity_pages: int) -> None:
        self.capacity = capacity_pages
        self.cache = Cache(capacity_pages * LINE_BYTES,
                           ways=capacity_pages, hit_latency=2.0,
                           name="NSB-pages")
        self._now = 0.0

    def touch(self, page: int, install: bool = True) -> bool:
        """Access one page id; returns True on a hot-set hit.

        ``install=False`` is the physical-tier demand probe: a miss is
        counted but the page is *not* brought in — only :meth:`stage`
        installs there."""
        self._now += 1.0
        t = self.cache.probe(int(page), self._now)
        if t is None:
            if install:
                self.cache.fill(int(page), self._now)
                self.cache.drain(self._now)   # install immediately
            return False
        return True

    def stage(self, page: int) -> None:
        """Speculatively install one page (no probe: hit/miss stats are
        untouched; the fill is tagged prefetch so accuracy accounting
        sees it)."""
        self._now += 1.0
        self.cache.fill(int(page), self._now, prefetch=True)
        self.cache.drain(self._now)

    def drop(self, page: int) -> None:
        """Remove one page without stats side effects beyond the
        unused-prefetch-evicted counter — the invalidation twin of the
        physical tier dropping a stale staged copy."""
        p = int(page)
        s = self.cache.sets[p % self.cache.num_sets]
        entry = s.pop(p, None)
        if entry == _E_PF:            # staged, never demanded: wasted
            self.cache.stats.prefetch_unused_evicted += 1
        self.cache.mshr.pop(p, None)

    @property
    def stats(self):
        return self.cache.stats

    @property
    def hit_rate(self) -> float | None:
        """Demand hit rate, or None before any traffic (keeps
        ``json.dumps(metrics, allow_nan=False)`` valid on smoke runs)."""
        s = self.cache.stats
        tot = s.hits + s.misses
        return s.hits / tot if tot else None

    @property
    def accuracy(self) -> float | None:
        """Fraction of staged pages demanded before eviction/drop —
        the paper's prediction-accuracy axis.  None before staging."""
        s = self.cache.stats
        return s.prefetch_used / s.prefetch_fills if s.prefetch_fills \
            else None

    @property
    def coverage(self) -> float | None:
        """Fraction of demand touches served by the hot set — the
        coverage axis (equals :attr:`hit_rate` for a pure-speculative
        tier, where misses never install).  None before traffic."""
        return self.hit_rate


class ShardedPageCache:
    """Per-shard NSB hot-set models for tensor-parallel serving.

    Under TP the paper's near-storage buffer is a *per-NPU* structure:
    each model shard holds its slice of the KV pool and its own NSB, and
    only sees the page selections its local KV heads produce.  This
    wrapper keeps one :class:`PageCache` per shard, keyed by the shared
    *global* physical page ids (the page-id space is never sharded), so
    per-shard hit rates and the cross-shard roll-up stay directly
    comparable with the single-shard accounting.
    """

    def __init__(self, n_shards: int, capacity_pages: int) -> None:
        if n_shards < 1:
            raise ValueError(f"need >= 1 shard, got {n_shards}")
        self.caches = [PageCache(capacity_pages) for _ in range(n_shards)]

    @property
    def n_shards(self) -> int:
        return len(self.caches)

    def touch(self, page: int, shard: int, install: bool = True) -> bool:
        """Access one page id on one shard's NSB; True on a hit.
        ``install=False`` follows :meth:`PageCache.touch`."""
        return self.caches[shard].touch(page, install=install)

    def stage(self, page: int) -> None:
        """Speculatively install on *every* shard: the page-id axis is
        never sharded, so one staging copy lands each shard's KV-head
        slice of the page — every shard's NSB gains the entry."""
        for c in self.caches:
            c.stage(page)

    def drop(self, page: int) -> None:
        """Invalidate a staged page on every shard."""
        for c in self.caches:
            c.drop(page)

    def hit_rates(self) -> list:
        """Per-shard NSB hit rates, indexed by shard."""
        return [c.hit_rate for c in self.caches]

    def rollup(self) -> dict:
        """Aggregate view across shards: summed hits/misses plus the
        per-shard rates (the serve ``metrics()`` roll-up)."""
        hits = sum(c.stats.hits for c in self.caches)
        misses = sum(c.stats.misses for c in self.caches)
        fills = sum(c.stats.prefetch_fills for c in self.caches)
        used = sum(c.stats.prefetch_used for c in self.caches)
        tot = hits + misses
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": hits / tot if tot else None,
            "accuracy": used / fills if fills else None,
            "coverage": hits / tot if tot else None,
            "per_shard": self.hit_rates(),
        }


def nsb_shard_rollup(stream: PageStream, nsb_pages: int,
                     n_shards: int | None = None) -> dict:
    """Replay a shard-tagged stream through per-shard NSB models.

    Each recorded event is routed to its shard's :class:`PageCache`
    (untagged events, ``shard == -1``, route to shard 0 — the
    single-shard case), touching each distinct page id in the event
    once.  Returns the :meth:`ShardedPageCache.rollup` dict: what the
    NSB hit rate *would have been* per shard for the captured traffic —
    the offline twin of the engine's live per-shard accounting.
    """
    if n_shards is None:
        n_shards = max([s for s in stream.shards if s >= 0], default=0) + 1
    spc = ShardedPageCache(n_shards, nsb_pages)
    for ev, sh in zip(stream.events, stream.shards):
        for p in dict.fromkeys(int(x) for x in ev):
            spc.touch(p, max(sh, 0))
    return spc.rollup()
