"""Memory-system model for the NVR simulator (paper-faithful layer).

Models the Gemmini-like NPU memory hierarchy from the paper:

    NPU <-> [optional NSB (16 KB, high-assoc, MSHRs)] <-> shared L2 <-> DRAM

All structures operate on *cache lines* (64 B).  The DRAM model is a simple
latency + bandwidth-occupancy queue: each line fetch occupies the channel for
``line_bytes / bytes_per_cycle`` cycles, so prefetchers that waste bandwidth
(low accuracy) produce real queuing slowdown — this is how the paper's
"stream prefetchers occasionally introduce performance penalties" emerges.

Everything is deterministic; no wall-clock or RNG in this module.

The implementation is tuned for the event-driven engine's hot loop but is
bit-identical in behaviour to the seed model (the frozen copy in
``engine/reference.py``; parity is asserted in tests/test_engine.py):

* LRU sets are plain insertion-ordered dicts (delete + reinsert on touch);
  resident-line state is a small-int bitfield, so touches allocate nothing.
* The in-flight prefetch tag lives in the *sign* of the MSHR ready cycle
  instead of a side set.
* ``drain()`` keeps a min-ready watermark (O(1) no-op when nothing can have
  completed) and exploits that DRAM-sourced fills arrive ready-sorted —
  the seed scanned every MSHR entry on every vector load.
* ``access_lines`` / ``prefetch_lines`` process a whole vector load per
  call with DRAM clock, byte counters and stats accumulated in locals.
"""

from __future__ import annotations

from dataclasses import dataclass

_INF = float("inf")
_TINY = 5e-324  # smallest positive float: stand-in for a 0.0 prefetch ready

LINE_BYTES = 64

# cache-set entry bitfield values (see Cache.sets)
_E_PF = 1        # line was installed by a prefetch
_E_USED = 2      # line has been demand-used
_E_PF_USED = 3


def line_of(addr: int) -> int:
    return addr // LINE_BYTES


@dataclass(slots=True)
class DRAM:
    """Latency + bandwidth-occupancy DRAM channel model."""

    latency: float = 150.0          # cycles, unloaded
    bytes_per_cycle: float = 16.0   # channel bandwidth
    busy_until: float = 0.0         # channel occupancy clock
    bytes_transferred: float = 0.0  # total off-chip traffic (demand+prefetch)

    def fetch(self, now: float, nbytes: int = LINE_BYTES) -> float:
        """Issue a line fetch at cycle ``now``; returns completion cycle."""
        occupancy = nbytes / self.bytes_per_cycle
        start = now if now > self.busy_until else self.busy_until
        self.busy_until = start + occupancy
        self.bytes_transferred += nbytes
        return start + occupancy + self.latency

    def reset(self) -> None:
        self.busy_until = 0.0
        self.bytes_transferred = 0.0


@dataclass(slots=True)
class CacheStats:
    hits: int = 0
    misses: int = 0
    demand_misses: int = 0
    prefetch_fills: int = 0
    prefetch_used: int = 0
    prefetch_unused_evicted: int = 0
    coalesced: int = 0  # MSHR hits on in-flight lines

    @property
    def accesses(self) -> int:
        return self.hits + self.misses


class Cache:
    """Set-associative, LRU, non-blocking (MSHR) cache.

    ``probe`` returns the cycle at which the line is available (for hits the
    access latency; for in-flight MSHR lines the fill time; misses return
    ``None`` and the caller decides where to fetch from).

    Prefetch fills are tagged so accuracy (used / issued) can be measured:
    in flight, the tag is the sign of the MSHR value (negative = prefetch);
    resident, it is bit0 of the set-entry bitfield.
    """

    __slots__ = ("name", "size_bytes", "ways", "hit_latency", "num_sets",
                 "sets", "mshr", "stats", "_min_ready",
                 "_fifo_ok", "_last_fill_ready", "_set_mask")

    def __init__(self, size_bytes: int, ways: int, hit_latency: float,
                 name: str = "L2") -> None:
        self.name = name
        self.size_bytes = size_bytes
        self.ways = ways
        self.hit_latency = hit_latency
        self.num_sets = max(1, size_bytes // LINE_BYTES // ways)
        # per-set insertion-ordered dict: line -> entry bitfield
        # (bit0 = was_prefetch, bit1 = demand-used).  Small ints are
        # interned in CPython, so touches/installs allocate nothing; LRU
        # order is maintained by delete + reinsert on touch.  The seed
        # stored (fill_cycle, was_prefetch, used) tuples, but the fill
        # cycle was never read back — behaviour is identical.
        self.sets: list[dict] = [{} for _ in range(self.num_sets)]
        # line -> ready cycle; NEGATIVE ready marks an in-flight prefetch
        self.mshr: dict[int, float] = {}
        self.stats = CacheStats()
        # num_sets is a power of two for every real config: index with a
        # mask (bulk paths fall back to the scalar path otherwise)
        self._set_mask = (self.num_sets - 1
                          if self.num_sets & (self.num_sets - 1) == 0
                          else -1)
        self._min_ready = _INF  # watermark: earliest in-flight completion
        # MSHR entries whose fill times only ever come from the (monotone)
        # DRAM channel clock are ready-sorted in insertion order, letting
        # drain() stop at the first not-yet-ready entry.  The flag clears
        # itself the moment any fill violates sortedness (e.g. NSB
        # forwarding fills), falling back to the full scan.
        self._fifo_ok = True
        self._last_fill_ready = -_INF

    # -- internals ---------------------------------------------------------
    def present(self, line: int, now: float) -> bool:
        if line in self.sets[line % self.num_sets]:
            return True
        ready = self.mshr.get(line)
        if ready is None:
            return False
        return (-ready if ready < 0 else ready) <= now

    def probe(self, line: int, now: float, demand: bool = True) -> float | None:
        """Access ``line`` at ``now``.  Returns availability cycle or None."""
        s = self.sets[line % self.num_sets]
        entry = s.pop(line, None)  # hit: removed here, reinserted as MRU
        stats = self.stats
        if entry is not None:
            if entry == _E_PF:          # unused prefetch line
                if demand:
                    stats.prefetch_used += 1
                    s[line] = _E_PF_USED
                else:
                    s[line] = _E_PF
            else:
                s[line] = entry | _E_USED if demand else entry
            stats.hits += 1
            return now + self.hit_latency
        ready = self.mshr.get(line)
        if ready is not None:
            was_pf = ready < 0
            if was_pf:
                ready = -ready
            if ready <= now:
                # fill completed: install
                self._install(line, ready, was_prefetch=was_pf, used=demand)
                if was_pf and demand:
                    stats.prefetch_used += 1
                del self.mshr[line]
                stats.hits += 1
                return now + self.hit_latency
            # still in flight: MSHR coalescing — wait for it, no new fetch
            stats.coalesced += 1
            if demand and was_pf:
                stats.prefetch_used += 1
                self.mshr[line] = ready  # count once: clear prefetch tag
            stats.hits += 1  # not an off-chip miss
            return ready + self.hit_latency
        stats.misses += 1
        if demand:
            stats.demand_misses += 1
        return None

    def _install(self, line: int, fill_cycle: float, was_prefetch: bool,
                 used: bool) -> None:
        s = self.sets[line % self.num_sets]
        if line in s:
            return
        if len(s) >= self.ways:
            lru = next(iter(s))            # oldest-inserted = LRU
            if s.pop(lru) == _E_PF:        # prefetched, never used
                self.stats.prefetch_unused_evicted += 1
        s[line] = (_E_PF if was_prefetch else 0) | (_E_USED if used else 0)

    def fill(self, line: int, ready: float, prefetch: bool = False) -> None:
        """Register an incoming fill (from DRAM or lower level)."""
        mshr = self.mshr
        cur = mshr.get(line)
        if cur is not None:
            if ready < (-cur if cur < 0 else cur):
                # earlier completion: keep the existing prefetch tag
                mshr[line] = (-ready or -_TINY) if cur < 0 else ready
                self._fifo_ok = False  # lowered mid-queue: order broken
                if ready < self._min_ready:
                    self._min_ready = ready
            return
        if line in self.sets[line % self.num_sets]:
            return
        mshr[line] = (-ready or -_TINY) if prefetch else ready
        if ready < self._last_fill_ready:
            self._fifo_ok = False
        else:
            self._last_fill_ready = ready
        if ready < self._min_ready:
            self._min_ready = ready
        if prefetch:
            self.stats.prefetch_fills += 1

    def drain(self, now: float) -> None:
        """Install all fills that have completed by ``now``."""
        if now < self._min_ready:
            return  # nothing in flight can have completed yet
        mshr = self.mshr
        sets, num_sets, ways = self.sets, self.num_sets, self.ways
        stats = self.stats
        if self._fifo_ok and mshr:
            last = next(reversed(mshr.values()))
            if (-last if last < 0 else last) <= now:
                # everything in flight has completed (common right after
                # a long stall): install all, clear in one shot
                for l, r in mshr.items():
                    s = sets[l % num_sets]         # inline _install
                    if l not in s:
                        if len(s) >= ways:
                            lru = next(iter(s))
                            if s.pop(lru) == _E_PF:
                                stats.prefetch_unused_evicted += 1
                        s[l] = _E_PF if r < 0 else 0
                mshr.clear()
                self._min_ready = _INF
                return
        done = []
        if self._fifo_ok:
            # ready-sorted queue: completed fills are a prefix — install
            # in the same pass, collect keys, delete after iteration
            for l, r in mshr.items():
                if (-r if r < 0 else r) > now:
                    break
                done.append(l)
                s = sets[l % num_sets]             # inline _install
                if l not in s:
                    if len(s) >= ways:
                        lru = next(iter(s))
                        if s.pop(lru) == _E_PF:    # prefetched, never used
                            stats.prefetch_unused_evicted += 1
                    s[l] = _E_PF if r < 0 else 0
        else:
            for l, r in mshr.items():
                if (-r if r < 0 else r) > now:
                    continue
                done.append(l)
                s = sets[l % num_sets]             # inline _install
                if l not in s:
                    if len(s) >= ways:
                        lru = next(iter(s))
                        if s.pop(lru) == _E_PF:
                            stats.prefetch_unused_evicted += 1
                    s[l] = _E_PF if r < 0 else 0
        for l in done:
            del mshr[l]
        if not mshr:
            self._min_ready = _INF
        elif self._fifo_ok:
            v = next(iter(mshr.values()))
            self._min_ready = -v if v < 0 else v
        else:
            self._min_ready = min(-v if v < 0 else v
                                  for v in mshr.values())

    def reset(self) -> None:
        self.sets = [{} for _ in range(self.num_sets)]
        self.mshr.clear()
        self.stats = CacheStats()
        self._min_ready = _INF
        self._fifo_ok = True
        self._last_fill_ready = -_INF


@dataclass(slots=True)
class Hierarchy:
    """L2 (+ optional NSB) + DRAM, with simple fetch plumbing.

    The NSB sits in front of L2 *for indirect (discrete) lines only*, per the
    paper (§IV-G): dense/continuous data stays in the scratchpad (modelled as
    always-hit) while sparse discrete data benefits from implicit cache-line
    reuse in the small high-associativity NSB.
    """

    l2: Cache
    dram: DRAM
    nsb: Cache | None = None
    demand_offchip_bytes: float = 0.0
    prefetch_offchip_bytes: float = 0.0

    def _dram_fill(self, line: int, now: float, granule_lines: int,
                   also_nsb: bool, skip_l2: bool = False) -> float:
        """Fetch ``line`` from DRAM at scratchpad-DMA granularity.

        NPUs without µ-instruction-level prefetch issue *rigid* preload DMAs
        (paper §II-B / §IV-F): the whole aligned granule is transferred even
        if only one line is needed.  VMIG-restructured (prefetcher) accesses
        bypass this and are line-granular (granule_lines=1).
        """
        ready = self.dram.fetch(now, nbytes=granule_lines * LINE_BYTES)
        self.demand_offchip_bytes += granule_lines * LINE_BYTES
        # only the demanded line is architecturally useful: the rest of the
        # rigid DMA granule is padding streamed into the scratchpad, not
        # cacheable for reuse (it wastes bandwidth, not cache capacity)
        if not skip_l2:
            self.l2.fill(line, ready)
        if also_nsb and self.nsb is not None:
            self.nsb.fill(line, ready)
        return ready

    def access(self, line: int, now: float, indirect: bool,
               granule_lines: int = 1) -> float:
        """Demand access; returns data-ready cycle."""
        nsb = self.nsb
        if nsb is not None and indirect:
            t = nsb.probe(line, now)
            if t is not None:
                return t
            # NSB miss -> L2 (fill NSB on return)
            t2 = self.l2.probe(line, now + nsb.hit_latency)
            if t2 is None:
                ready = self._dram_fill(line, now + nsb.hit_latency,
                                        granule_lines, also_nsb=True)
                return ready + nsb.hit_latency
            nsb.fill(line, t2)
            return t2
        t = self.l2.probe(line, now)
        if t is not None:
            return t
        ready = self._dram_fill(line, now, granule_lines, also_nsb=False)
        return ready + self.l2.hit_latency

    def access_lines(self, lines, now: float, indirect: bool,
                     granule_lines: int = 1) -> float:
        """Bulk demand access: the max data-ready cycle over ``lines``.

        Semantically identical to ``max(access(ln, ...) for ln in lines)``
        but one Python call per *vector load* instead of one per line —
        the engine's hottest path.  The L2-only branch inlines
        ``Cache.probe`` (demand=True) and the DRAM miss fill; any change
        here must keep tests/test_engine.py parity green.
        """
        nsb = self.nsb
        l2 = self.l2
        mask = l2._set_mask
        if (nsb is not None and indirect) or mask < 0:
            ready = now
            for ln in lines:
                r = self.access(ln, now, indirect, granule_lines)
                if r > ready:
                    ready = r
            return ready
        sets = l2.sets
        mshr = l2.mshr
        lat = l2.hit_latency
        dram = self.dram
        gbytes = granule_lines * LINE_BYTES
        # DRAM clock, byte counters and stats accumulate in locals and
        # flush once per bundle: nothing else can touch them mid-bundle
        busy = dram.busy_until
        occupancy = gbytes / dram.bytes_per_cycle
        dlat = dram.latency
        nbytes = 0
        misses = coalesced = pf_used = 0
        ready = now
        hit_r = now + lat
        for ln in lines:
            s = sets[ln & mask]
            entry = s.pop(ln, None)  # hit: removed here, reinserted as MRU
            if entry is not None:                       # L2 hit
                if entry == _E_PF:     # unused prefetch line, first use
                    pf_used += 1
                    s[ln] = _E_PF_USED
                else:
                    s[ln] = entry | _E_USED
                r = hit_r
            else:
                rdy = mshr.get(ln)
                if rdy is not None:                     # in flight
                    if rdy < 0:                         # prefetch in flight
                        rdy = -rdy
                        if rdy <= now:
                            l2._install(ln, rdy, True, True)
                            pf_used += 1
                            del mshr[ln]
                            r = hit_r
                        else:
                            coalesced += 1
                            pf_used += 1
                            mshr[ln] = rdy  # count once: clear tag
                            r = rdy + lat
                    elif rdy <= now:
                        l2._install(ln, rdy, False, True)
                        del mshr[ln]
                        r = hit_r
                    else:
                        coalesced += 1
                        r = rdy + lat
                else:                                   # miss -> DRAM
                    misses += 1
                    start = now if now > busy else busy
                    busy = start + occupancy
                    nbytes += gbytes
                    fin = start + occupancy + dlat
                    mshr[ln] = fin      # inline l2.fill: ln known absent
                    if fin < l2._last_fill_ready:
                        l2._fifo_ok = False
                    else:
                        l2._last_fill_ready = fin
                    if fin < l2._min_ready:
                        l2._min_ready = fin
                    r = fin + lat
            if r > ready:
                ready = r
        dram.busy_until = busy
        dram.bytes_transferred += nbytes
        self.demand_offchip_bytes += nbytes
        stats = l2.stats
        stats.hits += len(lines) - misses   # every non-miss line is a hit
        stats.misses += misses
        stats.demand_misses += misses
        stats.coalesced += coalesced
        stats.prefetch_used += pf_used
        return ready

    def prefetch_lines(self, lines, now: float, cap: int,
                       into_nsb: bool = False) -> int:
        """Bulk prefetch with the per-line MSHR-cap check; returns the
        number of issue attempts that passed the cap (the prefetchers'
        ``issued_lines`` accounting).  One call per vector-issue bundle
        instead of one ``prefetch()`` per line; the L2 fast path inlines
        the dedup check and fill.  Within one bundle the L2 MSHR can only
        grow, so hitting the cap ends the bundle (identical outcome to
        the seed's per-line cap test)."""
        l2 = self.l2
        mshr = l2.mshr
        mask = l2._set_mask
        if (into_nsb and self.nsb is not None) or mask < 0:
            issued = 0
            for ln in lines:
                if len(mshr) >= cap:
                    break
                issued += 1
                self.prefetch(ln, now, into_nsb=into_nsb)
            return issued
        sets = l2.sets
        dram = self.dram
        busy = dram.busy_until
        occupancy = LINE_BYTES / dram.bytes_per_cycle
        dlat = dram.latency
        fills = 0
        free = cap - len(mshr)   # MSHR only grows within one bundle
        n = len(lines)
        if free >= n:
            # budget cannot bind: skip the per-line cap bookkeeping
            issued = n
            for ln in lines:
                if ln in mshr or ln in sets[ln & mask]:
                    continue            # on-chip or already in flight
                start = now if now > busy else busy
                busy = start + occupancy
                ready = start + occupancy + dlat
                mshr[ln] = -ready       # inline l2.fill(ln, ready, True)
                if ready < l2._last_fill_ready:
                    l2._fifo_ok = False
                else:
                    l2._last_fill_ready = ready
                if ready < l2._min_ready:
                    l2._min_ready = ready
                fills += 1
        else:
            issued = 0
            for ln in lines:
                if free <= 0:
                    break
                issued += 1
                if ln in mshr or ln in sets[ln & mask]:
                    continue            # on-chip or already in flight
                free -= 1
                start = now if now > busy else busy
                busy = start + occupancy
                ready = start + occupancy + dlat
                mshr[ln] = -ready       # inline l2.fill(ln, ready, True)
                if ready < l2._last_fill_ready:
                    l2._fifo_ok = False
                else:
                    l2._last_fill_ready = ready
                if ready < l2._min_ready:
                    l2._min_ready = ready
                fills += 1
        if fills:
            dram.busy_until = busy
            dram.bytes_transferred += fills * LINE_BYTES
            self.prefetch_offchip_bytes += fills * LINE_BYTES
            l2.stats.prefetch_fills += fills
        return issued

    def prefetch(self, line: int, now: float, into_nsb: bool = False) -> None:
        """Prefetch ``line``; fills L2 (and optionally NSB)."""
        nsb = self.nsb
        target = nsb if (into_nsb and nsb is not None) else self.l2
        # on-chip or in flight at the target: nothing to do
        if line in target.mshr or line in target.sets[line % target.num_sets]:
            return
        if target is nsb:
            l2 = self.l2
            if line in l2.sets[line % l2.num_sets]:
                # already on-chip: move into NSB without off-chip traffic
                nsb.fill(line, now + l2.hit_latency, prefetch=True)
                return
            ready = l2.mshr.get(line)
            if ready is not None:
                if ready < 0:
                    ready = -ready
                if ready <= now:
                    nsb.fill(line, now + l2.hit_latency, prefetch=True)
                else:
                    # in flight from a far (L2-level) prefetch: forward it
                    nsb.fill(line, ready, prefetch=True)
                return
        ready = self.dram.fetch(now)
        self.prefetch_offchip_bytes += LINE_BYTES
        target.fill(line, ready, prefetch=True)
        if target is nsb:
            self.l2.fill(line, ready)

    def drain(self, now: float) -> None:
        l2 = self.l2
        if l2._min_ready <= now:
            l2.drain(now)
        nsb = self.nsb
        if nsb is not None and nsb._min_ready <= now:
            nsb.drain(now)

    @property
    def offchip_bytes(self) -> float:
        return self.demand_offchip_bytes + self.prefetch_offchip_bytes


def cache_latency(size_kb: int, base_kb: int = 256,
                  base_lat: float = 20.0) -> float:
    """CACTI-style access-latency scaling: bigger SRAM arrays are slower —
    the physical argument for the paper's small NSB.  Exponent 0.3 sits
    between wire-delay (0.5) and bank-parallel (0) regimes; Fig. 9's
    NSB-vs-L2 ratio is sensitive to it (see EXPERIMENTS.md §Deviations)."""
    return base_lat * (size_kb / base_kb) ** 0.3


def make_hierarchy(l2_kb: int = 256, nsb_kb: int = 0,
                   dram_latency: float = 150.0,
                   dram_bw: float = 16.0) -> Hierarchy:
    l2 = Cache(l2_kb * 1024, ways=8, hit_latency=cache_latency(l2_kb),
               name="L2")
    nsb = None
    if nsb_kb:
        nsb = Cache(nsb_kb * 1024, ways=16,
                    hit_latency=cache_latency(nsb_kb, 16, 2.0), name="NSB")
    return Hierarchy(l2=l2, dram=DRAM(latency=dram_latency,
                                      bytes_per_cycle=dram_bw), nsb=nsb)
