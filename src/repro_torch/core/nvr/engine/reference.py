"""Frozen copy of the seed per-op/per-line ``simulate()`` loop.

This module preserves the original (pre-engine) implementation verbatim —
per-op ``np.unique`` calls, dataclass attribute access, isinstance
dispatch, and the original prefetcher classes that scan ``trace.ops``
directly.  It exists for two reasons:

1. **Parity oracle** — ``tests/test_engine.py`` asserts the event-driven
   engine reproduces these totals exactly on all 8 Table-II workloads.
2. **Speed baseline** — ``benchmarks/paper_figs.py::engine_speedup``
   measures the engine's Fig. 5 sweep against this loop (the acceptance
   bar is >= 5x).

Do not optimise this file; it is the thing being measured against.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..machine import LINE_BYTES, cache_latency
from ..trace import Compute, Trace, VLoad
from .config import DMA_GRANULE_LINES, HIT_LAT, ISSUE, OOO_WINDOW
from .result import SimResult


def _lines(addrs: np.ndarray) -> np.ndarray:
    return np.unique(addrs // LINE_BYTES)


# -- seed memory-system model (verbatim) -------------------------------------

@dataclass
class _SeedDRAM:
    latency: float = 150.0
    bytes_per_cycle: float = 16.0
    busy_until: float = 0.0
    bytes_transferred: float = 0.0

    def fetch(self, now: float, nbytes: int = LINE_BYTES) -> float:
        occupancy = nbytes / self.bytes_per_cycle
        start = max(now, self.busy_until)
        self.busy_until = start + occupancy
        self.bytes_transferred += nbytes
        return start + occupancy + self.latency


@dataclass
class _SeedCacheStats:
    hits: int = 0
    misses: int = 0
    demand_misses: int = 0
    prefetch_fills: int = 0
    prefetch_used: int = 0
    prefetch_unused_evicted: int = 0
    coalesced: int = 0

    @property
    def accesses(self) -> int:
        return self.hits + self.misses


class _SeedCache:
    def __init__(self, size_bytes: int, ways: int, hit_latency: float,
                 name: str = "L2") -> None:
        self.name = name
        self.size_bytes = size_bytes
        self.ways = ways
        self.hit_latency = hit_latency
        self.num_sets = max(1, size_bytes // LINE_BYTES // ways)
        self.sets: list[OrderedDict] = [OrderedDict()
                                        for _ in range(self.num_sets)]
        self.mshr: dict[int, float] = {}
        self.mshr_prefetch: set[int] = set()
        self.stats = _SeedCacheStats()

    def _set(self, line: int) -> OrderedDict:
        return self.sets[line % self.num_sets]

    def present(self, line: int, now: float) -> bool:
        s = self._set(line)
        if line in s:
            return True
        return line in self.mshr and self.mshr[line] <= now

    def probe(self, line: int, now: float, demand: bool = True) -> float | None:
        s = self._set(line)
        if line in s:
            fill, was_pf, used = s[line]
            if was_pf and not used and demand:
                self.stats.prefetch_used += 1
            s[line] = (fill, was_pf, True if demand else used)
            s.move_to_end(line)
            self.stats.hits += 1
            return now + self.hit_latency
        if line in self.mshr:
            ready = self.mshr[line]
            if ready <= now:
                self._install(line, ready,
                              was_prefetch=line in self.mshr_prefetch,
                              used=demand)
                if line in self.mshr_prefetch and demand:
                    self.stats.prefetch_used += 1
                del self.mshr[line]
                self.mshr_prefetch.discard(line)
                self.stats.hits += 1
                return now + self.hit_latency
            self.stats.coalesced += 1
            if line in self.mshr_prefetch and demand:
                self.stats.prefetch_used += 1
                self.mshr_prefetch.discard(line)
            self.stats.hits += 1
            return ready + self.hit_latency
        self.stats.misses += 1
        if demand:
            self.stats.demand_misses += 1
        return None

    def _install(self, line: int, fill_cycle: float, was_prefetch: bool,
                 used: bool) -> None:
        s = self._set(line)
        if line in s:
            return
        if len(s) >= self.ways:
            _, (f, pf, u) = s.popitem(last=False)
            if pf and not u:
                self.stats.prefetch_unused_evicted += 1
        s[line] = (fill_cycle, was_prefetch, used)

    def fill(self, line: int, ready: float, prefetch: bool = False) -> None:
        if line in self.mshr:
            self.mshr[line] = min(self.mshr[line], ready)
            return
        s = self._set(line)
        if line in s:
            return
        self.mshr[line] = ready
        if prefetch:
            self.mshr_prefetch.add(line)
            self.stats.prefetch_fills += 1

    def drain(self, now: float) -> None:
        done = [l for l, r in self.mshr.items() if r <= now]
        for l in done:
            self._install(l, self.mshr[l], l in self.mshr_prefetch, False)
            del self.mshr[l]
            self.mshr_prefetch.discard(l)


@dataclass
class _SeedHierarchy:
    l2: _SeedCache
    dram: _SeedDRAM
    nsb: _SeedCache | None = None
    demand_offchip_bytes: float = 0.0
    prefetch_offchip_bytes: float = 0.0

    def _dram_fill(self, line: int, now: float, granule_lines: int,
                   also_nsb: bool, skip_l2: bool = False) -> float:
        ready = self.dram.fetch(now, nbytes=granule_lines * LINE_BYTES)
        self.demand_offchip_bytes += granule_lines * LINE_BYTES
        if not skip_l2:
            self.l2.fill(line, ready)
        if also_nsb and self.nsb is not None:
            self.nsb.fill(line, ready)
        return ready

    def access(self, line: int, now: float, indirect: bool,
               granule_lines: int = 1) -> float:
        if self.nsb is not None and indirect:
            t = self.nsb.probe(line, now)
            if t is not None:
                return t
            t2 = self.l2.probe(line, now + self.nsb.hit_latency)
            if t2 is None:
                ready = self._dram_fill(line, now + self.nsb.hit_latency,
                                        granule_lines, also_nsb=True)
                return ready + self.nsb.hit_latency
            self.nsb.fill(line, t2)
            return t2
        t = self.l2.probe(line, now)
        if t is not None:
            return t
        ready = self._dram_fill(line, now, granule_lines, also_nsb=False)
        return ready + self.l2.hit_latency

    def prefetch(self, line: int, now: float, into_nsb: bool = False) -> None:
        target = self.nsb if (into_nsb and self.nsb is not None) else self.l2
        if target.present(line, now) or line in target.mshr:
            return
        if target is self.nsb:
            if self.l2.present(line, now):
                self.nsb.fill(line, now + self.l2.hit_latency, prefetch=True)
                return
            if line in self.l2.mshr:
                self.nsb.fill(line, self.l2.mshr[line], prefetch=True)
                return
        ready = self.dram.fetch(now)
        self.prefetch_offchip_bytes += LINE_BYTES
        target.fill(line, ready, prefetch=True)
        if target is self.nsb:
            self.l2.fill(line, ready)

    def drain(self, now: float) -> None:
        self.l2.drain(now)
        if self.nsb is not None:
            self.nsb.drain(now)


def _seed_make_hierarchy(l2_kb: int = 256, nsb_kb: int = 0,
                         dram_latency: float = 150.0,
                         dram_bw: float = 16.0) -> _SeedHierarchy:
    l2 = _SeedCache(l2_kb * 1024, ways=8, hit_latency=cache_latency(l2_kb),
                    name="L2")
    nsb = None
    if nsb_kb:
        nsb = _SeedCache(nsb_kb * 1024, ways=16,
                         hit_latency=cache_latency(nsb_kb, 16, 2.0),
                         name="NSB")
    return _SeedHierarchy(l2=l2, dram=_SeedDRAM(latency=dram_latency,
                                                bytes_per_cycle=dram_bw),
                          nsb=nsb)


class _SeedPrefetcher:
    name = "none"
    mshr_cap = 10 ** 9

    def __init__(self) -> None:
        self.issued_lines = 0

    def _issue(self, hier: _SeedHierarchy, line: int, now: float,
               into_nsb: bool = False) -> bool:
        if len(hier.l2.mshr) >= self.mshr_cap:
            return False
        self.issued_lines += 1
        hier.prefetch(int(line), now, into_nsb=into_nsb)
        return True

    def on_vload(self, i, op, trace, now, hier) -> None:
        pass

    def on_miss(self, i, op, trace, now, hier) -> None:
        pass


class _SeedStream(_SeedPrefetcher):
    name = "stream"

    def __init__(self, depth: int = 4) -> None:
        super().__init__()
        self.depth = depth
        self.table: dict[int, tuple[int, int, int]] = {}

    def on_vload(self, i, op, trace, now, hier) -> None:
        a0 = int(op.addrs[0])
        span = int(op.addrs[-1]) - a0 + LINE_BYTES
        last, stride, conf = self.table.get(op.pc, (a0, 0, 0))
        new_stride = a0 - last
        if new_stride == stride and stride != 0:
            conf = min(conf + 1, 3)
        else:
            conf = 0
        self.table[op.pc] = (a0, new_stride, conf)
        if conf >= 2:
            for k in range(1, self.depth + 1):
                base = a0 + k * new_stride
                for ln in range((base // LINE_BYTES),
                                (base + span) // LINE_BYTES + 1):
                    self._issue(hier, ln, now)


class _SeedIMP(_SeedPrefetcher):
    name = "imp"
    mshr_cap = 64

    def __init__(self, learn_after: int = 2, lookahead_ops: int = 40,
                 max_chains: int = 2) -> None:
        super().__init__()
        self.learn_after = learn_after
        self.lookahead_ops = lookahead_ops
        self.max_chains = max_chains
        self.observed: dict[int, int] = {}
        self.chains: dict[int, list[int]] = {}
        self.stream = _SeedStream(depth=2)

    def on_vload(self, i, op, trace, now, hier) -> None:
        self.stream.issued_lines = self.issued_lines
        self.stream.on_vload(i, op, trace, now, hier)
        self.issued_lines = self.stream.issued_lines
        if op.kind == "indirect":
            self.observed[op.idx_pc] = self.observed.get(op.idx_pc, 0) + 1
            learned = self.chains.setdefault(op.idx_pc, [])
            if op.pc not in learned and len(learned) < self.max_chains:
                learned.append(op.pc)
            return
        pc = op.pc
        if self.observed.get(pc, 0) < self.learn_after:
            return
        learned = self.chains.get(pc, [])
        bound = op.bound_id
        for j in range(i + 1, min(len(trace.ops), i + 1 + self.lookahead_ops)):
            nxt = trace.ops[j]
            if isinstance(nxt, Compute):
                continue
            if nxt.bound_id != bound:
                break
            if nxt.kind == "indirect" and nxt.idx_pc == pc and nxt.pc in learned:
                for ln in _lines(nxt.addrs):
                    self._issue(hier, ln, now)


class _SeedDVR(_SeedPrefetcher):
    name = "dvr"
    mshr_cap = 128

    def __init__(self, window: int = 48, issue_width: int = 16) -> None:
        super().__init__()
        self.window = window
        self.issue_width = issue_width

    @staticmethod
    def _bound_ok(op: VLoad) -> bool:
        return (op.bound_id * 2654435761 + op.pc) % 100 < 72

    def on_miss(self, i, op, trace, now, hier) -> None:
        cur = op.bound_id
        seen = 0
        t = now
        for j in range(i + 1, len(trace.ops)):
            if seen >= self.window:
                break
            nxt = trace.ops[j]
            if isinstance(nxt, Compute):
                continue
            seen += 1
            t += 1.0 / self.issue_width
            if nxt.bound_id == cur or self._bound_ok(nxt):
                for ln in _lines(nxt.addrs):
                    self._issue(hier, ln, t)
            else:
                junk = int(nxt.addrs[-1] // LINE_BYTES) + 4
                for k in range(min(4, len(nxt.addrs))):
                    self._issue(hier, junk + k, t)


class _SeedNVR(_SeedPrefetcher):
    name = "nvr"
    mshr_cap = 256

    def __init__(self, depth: int = 96, fuzzy_every: int = 8,
                 fill_nsb: bool = False, near_depth: int = 12,
                 scd: bool = True, lbd: bool = True,
                 vmig: bool = True) -> None:
        super().__init__()
        self.depth = depth
        self.near_depth = near_depth
        self.fuzzy_every = fuzzy_every
        self.fill_nsb = fill_nsb
        self.scd = scd
        self.lbd = lbd
        self.vmig = vmig
        self._covered_until = -1
        self._near_until = -1
        self._fuzzy_ctr = 0

    def on_vload(self, i, op, trace, now, hier) -> None:
        start = max(i + 1, self._covered_until + 1)
        end = min(len(trace.ops), i + 1 + self.depth)
        t = now
        cur_bound = op.bound_id
        for j in range(start, end):
            nxt = trace.ops[j]
            if isinstance(nxt, Compute):
                self._covered_until = j
                continue
            if not self.scd and nxt.kind == "indirect":
                self._covered_until = j
                continue
            lines = _lines(nxt.addrs)
            if len(hier.l2.mshr) + len(lines) > self.mshr_cap:
                break
            t += (1.0 / 16.0) if self.vmig else float(len(lines))
            if not self.lbd and nxt.bound_id != cur_bound \
                    and not _SeedDVR._bound_ok(nxt):
                junk = int(nxt.addrs[-1] // LINE_BYTES) + 4
                for kk in range(min(4, len(lines))):
                    self._issue(hier, junk + kk, t)
                self._covered_until = j
                continue
            for ln in lines:
                self._issue(hier, ln, t)
            if nxt.kind == "indirect":
                self._fuzzy_ctr += 1
                if self.fuzzy_every and \
                        self._fuzzy_ctr % self.fuzzy_every == 0:
                    self._issue(hier, int(lines[-1]) + 1, t)
            self._covered_until = j
        if not self.fill_nsb:
            return
        nstart = max(i + 1, self._near_until + 1)
        nend = min(len(trace.ops), i + 1 + self.near_depth)
        for j in range(nstart, nend):
            nxt = trace.ops[j]
            self._near_until = j
            if isinstance(nxt, Compute) or nxt.kind != "indirect":
                continue
            for ln in _lines(nxt.addrs):
                self._issue(hier, ln, now, into_nsb=True)


_SEED_PREFETCHERS = {
    "stream": _SeedStream,
    "imp": _SeedIMP,
    "dvr": _SeedDVR,
    "nvr": _SeedNVR,
}


def simulate_reference(trace: Trace, mode: str = "inorder",
                       prefetcher: str | None = None, l2_kb: int = 256,
                       nsb_kb: int = 0, dram_latency: float = 150.0,
                       dram_bw: float = 16.0,
                       pf_kwargs: dict | None = None) -> SimResult:
    """The seed ``simulate()`` loop, byte-for-byte in behaviour."""
    hier = _seed_make_hierarchy(l2_kb=l2_kb, nsb_kb=nsb_kb,
                                dram_latency=dram_latency, dram_bw=dram_bw)
    pf: _SeedPrefetcher | None = None
    if prefetcher:
        kwargs = dict(pf_kwargs or {})
        if prefetcher == "nvr" and nsb_kb and "fill_nsb" not in kwargs:
            kwargs["fill_nsb"] = True
        pf = _SEED_PREFETCHERS[prefetcher](**kwargs)

    if mode == "dense":
        comp = trace.total_compute() * trace.dense_compute_scale
        dense_bytes = trace.meta.get("dense_bytes",
                                     trace.total_compute() * 64)
        mem = dense_bytes / dram_bw + dram_latency
        total = max(comp, mem)
        return SimResult(workload=trace.name, mode=mode, prefetcher="",
                         dtype_bytes=0, nsb_kb=nsb_kb, total=total,
                         base=comp, stall=total - comp, compute=comp,
                         n_vloads=0, demand_misses=0, l2_accesses=0,
                         demand_offchip=dense_bytes, prefetch_offchip=0.0,
                         pf_issued=0, pf_used=0)

    granule = 1 if pf is not None else DMA_GRANULE_LINES
    t = 0.0
    mem_ready = 0.0
    base = 0.0
    stall = 0.0
    compute = 0.0
    n_vloads = 0
    window: list[float] = []
    for i, op in enumerate(trace.ops):
        if isinstance(op, Compute):
            t += op.cycles
            base += op.cycles
            compute += op.cycles
            continue
        n_vloads += 1
        hier.drain(t)
        if pf is not None:
            pf.on_vload(i, op, trace, t, hier)
        lines = np.unique(op.addrs // LINE_BYTES)
        indirect = op.kind == "indirect"
        miss_before = hier.l2.stats.demand_misses
        ready = t
        for ln in lines:
            ready = max(ready, hier.access(int(ln), t, indirect, granule))
        if pf is not None and hier.l2.stats.demand_misses > miss_before:
            pf.on_miss(i, op, trace, t, hier)
        if mode == "inorder":
            t0 = t + ISSUE + HIT_LAT
            base += ISSUE + HIT_LAT
            if ready > t0:
                stall += ready - t0
                t = ready
            else:
                t = t0
        elif mode == "ooo":
            t += ISSUE
            base += ISSUE
            window.append(ready)
            if len(window) > OOO_WINDOW:
                blocker = window.pop(0)
                if blocker > t:
                    stall += blocker - t
                    t = blocker
            mem_ready = max(mem_ready, ready)
        else:
            raise ValueError(mode)
    if mode == "ooo":
        total = max(t, mem_ready)
        stall = total - base
    else:
        total = t

    pf_issued = (hier.l2.stats.prefetch_fills
                 + (hier.nsb.stats.prefetch_fills if hier.nsb else 0))
    pf_used = hier.l2.stats.prefetch_used
    nsb_hits = 0
    if hier.nsb is not None:
        pf_used += hier.nsb.stats.prefetch_used
        nsb_hits = hier.nsb.stats.hits
    return SimResult(
        workload=trace.name, mode=mode, prefetcher=prefetcher or "",
        dtype_bytes=0, nsb_kb=nsb_kb, total=total, base=base, stall=stall,
        compute=compute, n_vloads=n_vloads,
        demand_misses=hier.l2.stats.demand_misses,
        l2_accesses=hier.l2.stats.accesses,
        demand_offchip=hier.demand_offchip_bytes,
        prefetch_offchip=hier.prefetch_offchip_bytes,
        pf_issued=pf_issued, pf_used=pf_used, nsb_hits=nsb_hits)


def run_modes_reference(trace: Trace, dtype_bytes: int, nsb_kb: int = 0,
                        l2_kb: int = 256) -> list[SimResult]:
    """Seed ``run_modes()``: the Fig. 5 mode set via the reference loop."""
    results = []
    baseline = None
    for mode in ("dense", "inorder", "ooo", "stream", "imp", "dvr", "nvr"):
        if mode in ("dense", "inorder", "ooo"):
            r = simulate_reference(trace, mode=mode, l2_kb=l2_kb,
                                   nsb_kb=nsb_kb)
        else:
            r = simulate_reference(trace, mode="inorder", prefetcher=mode,
                                   l2_kb=l2_kb, nsb_kb=nsb_kb)
        r.dtype_bytes = dtype_bytes
        if mode == "inorder":
            baseline = r
        if baseline is not None and baseline.demand_misses:
            r.coverage = 1.0 - r.demand_misses / baseline.demand_misses
        results.append(r)
    return results
