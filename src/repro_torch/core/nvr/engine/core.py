"""The event-driven simulation engine.

:class:`SimEngine` walks a compiled :class:`~.vectrace.VecTrace` and
publishes three events per retired op:

* ``"vload"``  — a vector load entered execution ``(i, now)``.
* ``"miss"``   — that load demand-missed in L2 ``(i, now)``.
* ``"retire"`` — any op (load or compute tile) retired ``(i, now)``.

The configured prefetcher is just the first subscriber (its ``on_vload`` /
``on_miss`` hooks); capture adapters and stats collectors attach with
:meth:`SimEngine.subscribe` without the timing loop knowing about them.

Timing semantics are bit-identical to the seed ``simulate()`` loop (the
parity oracle lives in :mod:`.reference`); the speed comes from the
structure-of-arrays trace — per-op unique-line lists are precomputed once
per trace and shared by all mode/prefetcher runs — not from approximating
the model.
"""

from __future__ import annotations

from collections import deque

from ..trace import Trace
from .config import SimConfig
from .result import SimResult
from .vectrace import KIND_COMPUTE, KIND_INDIRECT, compile_trace

_EVENTS = ("vload", "miss", "retire")


class SimEngine:
    """Reusable engine for one :class:`SimConfig` (state is per-``run``)."""

    def __init__(self, config: SimConfig | None = None, **kw) -> None:
        self.config = config if config is not None else SimConfig(**kw)
        self._subs: dict[str, list] = {e: [] for e in _EVENTS}

    def subscribe(self, event: str, fn) -> None:
        """Attach ``fn(i, now)`` to ``event`` for every subsequent run."""
        self._subs[event].append(fn)

    # ------------------------------------------------------------------
    def run(self, trace: Trace, dtype_bytes: int = 0) -> SimResult:
        cfg = self.config
        vt = compile_trace(trace)
        if cfg.mode == "dense":
            return self._run_dense(trace, vt, dtype_bytes)

        hier = cfg.build_hierarchy()
        pf = cfg.build_prefetcher()
        # without µ-inst-level (VMIG) restructuring, demand fetches happen
        # at rigid scratchpad-DMA granularity (paper §II-B / §IV-F)
        granule = 1 if pf is not None else cfg.dma_granule_lines
        issue, hit_lat = cfg.issue_cycles, cfg.hit_latency
        ooo = cfg.mode == "ooo"
        ooo_window = cfg.ooo_window
        vload_subs, miss_subs, retire_subs = (
            self._subs["vload"], self._subs["miss"], self._subs["retire"])
        on_vload = pf.on_vload if pf is not None else None
        on_miss = pf.on_miss if pf is not None else None

        kind, cycles, all_lines = vt.kind, vt.cycles, vt.lines
        l2 = hier.l2
        nsb = hier.nsb
        l2_stats = l2.stats
        access_lines = hier.access_lines

        t = 0.0
        mem_ready = 0.0
        base = 0.0
        stall = 0.0
        compute = 0.0
        n_vloads = 0
        window = deque()  # OoO outstanding-load completion times
        for i, k in enumerate(kind):
            if k == KIND_COMPUTE:
                c = cycles[i]
                t += c
                base += c
                compute += c
                if retire_subs:
                    for cb in retire_subs:
                        cb(i, t)
                continue
            n_vloads += 1
            if l2._min_ready <= t:       # inline hier.drain guard
                l2.drain(t)
            if nsb is not None and nsb._min_ready <= t:
                nsb.drain(t)
            if on_vload is not None:
                on_vload(i, vt, t, hier)
            if vload_subs:
                for cb in vload_subs:
                    cb(i, t)
            miss_before = l2_stats.demand_misses
            ready = access_lines(all_lines[i], t, k == KIND_INDIRECT,
                                 granule)
            if l2_stats.demand_misses > miss_before:
                if on_miss is not None:
                    on_miss(i, vt, t, hier)
                if miss_subs:
                    for cb in miss_subs:
                        cb(i, t)
            if not ooo:
                t0 = t + issue + hit_lat
                base += issue + hit_lat
                if ready > t0:
                    stall += ready - t0
                    t = ready
                else:
                    t = t0
            else:
                t += issue
                base += issue
                window.append(ready)
                if len(window) > ooo_window:
                    # coarse-grained ROB: the oldest outstanding vector
                    # load must retire before a new one can issue
                    blocker = window.popleft()
                    if blocker > t:
                        stall += blocker - t
                        t = blocker
                if ready > mem_ready:
                    mem_ready = ready
            if retire_subs:
                for cb in retire_subs:
                    cb(i, t)
        if ooo:
            total = max(t, mem_ready)
            stall = total - base
        else:
            total = t

        pf_issued = (l2_stats.prefetch_fills
                     + (hier.nsb.stats.prefetch_fills if hier.nsb else 0))
        pf_used = l2_stats.prefetch_used
        nsb_hits = 0
        if hier.nsb is not None:
            pf_used += hier.nsb.stats.prefetch_used
            nsb_hits = hier.nsb.stats.hits
        return SimResult(
            workload=trace.name, mode=cfg.mode,
            prefetcher=cfg.prefetcher or "",
            dtype_bytes=dtype_bytes, nsb_kb=cfg.nsb_kb, total=total,
            base=base, stall=stall, compute=compute, n_vloads=n_vloads,
            demand_misses=l2_stats.demand_misses,
            l2_accesses=l2_stats.accesses,
            demand_offchip=hier.demand_offchip_bytes,
            prefetch_offchip=hier.prefetch_offchip_bytes,
            pf_issued=pf_issued, pf_used=pf_used, nsb_hits=nsb_hits)

    # ------------------------------------------------------------------
    def _run_dense(self, trace: Trace, vt, dtype_bytes: int) -> SimResult:
        cfg = self.config
        comp = vt.total_compute * trace.dense_compute_scale
        dense_bytes = trace.meta.get("dense_bytes", vt.total_compute * 64)
        mem = dense_bytes / cfg.dram_bw + cfg.dram_latency
        total = max(comp, mem)
        return SimResult(
            workload=trace.name, mode="dense", prefetcher="",
            dtype_bytes=dtype_bytes, nsb_kb=cfg.nsb_kb, total=total,
            base=comp, stall=total - comp, compute=comp, n_vloads=0,
            demand_misses=0, l2_accesses=0, demand_offchip=dense_bytes,
            prefetch_offchip=0.0, pf_issued=0, pf_used=0)
