"""Prefetcher models: stream [35], IMP [36], DVR [11][20], and NVR (ours).

Each prefetcher observes exactly what its hardware mechanism could observe:

* ``StreamPrefetcher`` — per-PC reference prediction table (addr, stride,
  confidence).  Covers sequential streams; mispredicts on indirect PCs and
  wastes bandwidth (the paper's "stream prefetchers occasionally introduce
  performance penalties").
* ``IMP`` — learns the indirect mapping ``addr = base + (idx << shift)`` per
  index-PC, then, when an index vector load completes, prefetches the
  *current batch*'s gather targets.  One-batch-ahead only: it cannot
  dereference future index values (no runahead), so latency hiding is
  partial and deep/dynamic chains (MK hash probes) are not covered.
* ``DVR`` — vector runahead triggered *on a demand L2 miss*: speculatively
  executes the dependency chain ahead (it can dereference future indices),
  vectorised 16-wide, up to a runahead window.  Boundary-blind: at sparse
  (dynamic) loop boundaries its fixed-trip-count assumption mispredicts,
  producing junk prefetches and lost coverage (modelled with a
  deterministic per-bound hash).
* ``NVR`` — enters runahead when a load *executes* (not when it misses),
  snoops exact sparse boundaries (LBD) and index chains (SCD) from the NPU
  sparse unit, bundles prefetches into vector requests (VMIG) and issues
  them far ahead.  Coverage-oriented fuzzy-range loading adds a small
  deterministic over-fetch (accuracy < 100 %, coverage ≈ 100 %).

Prefetchers subscribe to engine events (``on_vload`` fires when a vector
load executes, ``on_miss`` when it demand-misses in L2) and read the
compiled :class:`~.engine.vectrace.VecTrace` — per-op unique-line arrays
are precomputed, so runahead scans never touch numpy.  New prefetchers
self-register via :func:`~.engine.registry.register_prefetcher`.
"""

from __future__ import annotations

from types import MappingProxyType

from .engine.registry import _REGISTRY, register_prefetcher
from .engine.vectrace import KIND_COMPUTE, KIND_INDIRECT, VecTrace
from .machine import LINE_BYTES, Hierarchy


def bound_ok(bound_id: int, pc: int) -> bool:
    """Deterministic boundary-speculation outcome for boundary-blind
    runahead: ~72 % of cross-bound chains survive the fixed-trip-count
    assumption."""
    return (bound_id * 2654435761 + pc) % 100 < 72


class Prefetcher:
    name = "none"
    mshr_cap = 10 ** 9  # max prefetch lines in flight (hardware MSHR bound)

    def __init__(self) -> None:
        self.issued_lines = 0

    def _issue(self, hier: Hierarchy, line: int, now: float,
               into_nsb: bool = False) -> bool:
        if len(hier.l2.mshr) >= self.mshr_cap:
            return False
        self.issued_lines += 1
        hier.prefetch(int(line), now, into_nsb=into_nsb)
        return True

    def on_vload(self, i: int, vt: VecTrace, now: float,
                 hier: Hierarchy) -> None:  # pragma: no cover - interface
        pass

    def on_miss(self, i: int, vt: VecTrace, now: float,
                hier: Hierarchy) -> None:  # pragma: no cover - interface
        pass


@register_prefetcher("stream")
class StreamPrefetcher(Prefetcher):

    def __init__(self, depth: int = 4) -> None:
        super().__init__()
        self.depth = depth
        self.table: dict[int, tuple[int, int, int]] = {}  # pc -> (last, stride, conf)

    def on_vload(self, i, vt, now, hier) -> None:
        a0 = vt.addr_first[i]
        span = vt.addr_last[i] - a0 + LINE_BYTES
        pc = vt.pc[i]
        last, stride, conf = self.table.get(pc, (a0, 0, 0))
        new_stride = a0 - last
        if new_stride == stride and stride != 0:
            conf = min(conf + 1, 3)
        else:
            conf = 0
        self.table[pc] = (a0, new_stride, conf)
        if conf >= 2:
            cap = self.mshr_cap
            for k in range(1, self.depth + 1):
                base = a0 + k * new_stride
                self.issued_lines += hier.prefetch_lines(
                    range(base // LINE_BYTES,
                          (base + span) // LINE_BYTES + 1), now, cap)


@register_prefetcher("imp")
class IMP(Prefetcher):
    mshr_cap = 64

    def __init__(self, learn_after: int = 2, lookahead_ops: int = 40,
                 max_chains: int = 2) -> None:
        super().__init__()
        self.learn_after = learn_after
        self.lookahead_ops = lookahead_ops
        self.max_chains = max_chains  # IPT capacity per index stream
        self.observed: dict[int, int] = {}     # idx_pc -> #observations
        self.chains: dict[int, list[int]] = {}  # idx_pc -> learned gather PCs
        self.stream = StreamPrefetcher(depth=2)

    def on_vload(self, i, vt, now, hier) -> None:
        # stream component covers the index/weight streams themselves
        self.stream.issued_lines = self.issued_lines
        self.stream.on_vload(i, vt, now, hier)
        self.issued_lines = self.stream.issued_lines
        kind = vt.kind
        pc = vt.pc[i]
        if kind[i] == KIND_INDIRECT:
            ipc = vt.idx_pc[i]
            self.observed[ipc] = self.observed.get(ipc, 0) + 1
            learned = self.chains.setdefault(ipc, [])
            # limited pattern-table capacity: only the first ``max_chains``
            # (idx_pc -> gather_pc) mappings are captured — deep/multi-slice
            # chains exceed the IPT (the paper's §II-C criticism)
            if pc not in learned and len(learned) < self.max_chains:
                learned.append(pc)
            return
        # an index stream load completed: prefetch this batch's gather
        # targets (the values just became architecturally visible)
        if self.observed.get(pc, 0) < self.learn_after:
            return
        learned = self.chains.get(pc, [])
        bound = vt.bound[i]
        for j in range(i + 1, min(vt.n_ops, i + 1 + self.lookahead_ops)):
            kj = kind[j]
            if kj == KIND_COMPUTE:
                continue
            if vt.bound[j] != bound:
                break  # IMP has no loop-boundary knowledge beyond the batch
            if kj == KIND_INDIRECT and vt.idx_pc[j] == pc \
                    and vt.pc[j] in learned:
                self.issued_lines += hier.prefetch_lines(
                    vt.lines[j], now, self.mshr_cap)


@register_prefetcher("dvr")
class DVR(Prefetcher):
    mshr_cap = 128

    def __init__(self, window: int = 48, issue_width: int = 16) -> None:
        super().__init__()
        self.window = window
        self.issue_width = issue_width

    def on_miss(self, i, vt, now, hier) -> None:
        cur = vt.bound[i]
        seen = 0
        t = now
        kind, bound, lines = vt.kind, vt.bound, vt.lines
        step = 1.0 / self.issue_width
        for j in range(i + 1, vt.n_ops):
            if seen >= self.window:
                break
            if kind[j] == KIND_COMPUTE:
                continue
            seen += 1
            # runahead issue rate: issue_width lines per cycle group
            t += step
            if bound[j] == cur or bound_ok(bound[j], vt.pc[j]):
                self.issued_lines += hier.prefetch_lines(
                    lines[j], t, self.mshr_cap)
            else:
                # boundary mispredict: junk prefetch past the row end
                junk = vt.addr_last[j] // LINE_BYTES + 4
                self.issued_lines += hier.prefetch_lines(
                    range(junk, junk + min(4, vt.n_addrs[j])), t,
                    self.mshr_cap)


@register_prefetcher("nvr")
class NVR(Prefetcher):
    """NPU Vector Runahead: SD + SCD + LBD + VMIG (+ optional NSB fill)."""

    mshr_cap = 256

    def __init__(self, depth: int = 96, fuzzy_every: int = 8,
                 fill_nsb: bool = False, near_depth: int = 12,
                 scd: bool = True, lbd: bool = True,
                 vmig: bool = True) -> None:
        """Component flags support the ablation study
        (benchmarks/paper_figs.py::ablation_nvr):
          scd=False  — no Sparse Chain Detector: indirect targets cannot
                       be computed ahead; only stream PCs prefetch.
          lbd=False  — boundary-blind: cross-bound chains mispredict like
                       DVR's fixed-trip-count assumption.
          vmig=False — scalar issue (1 line/cycle) instead of 16-wide
                       vectorised micro-instruction bundles.
        """
        super().__init__()
        self.depth = depth              # far runahead window, in vector loads
        self.near_depth = near_depth    # near window staged into the NSB
        self.fuzzy_every = fuzzy_every  # fuzzy-range over-fetch granularity
        self.fill_nsb = fill_nsb
        self.scd = scd
        self.lbd = lbd
        self.vmig = vmig
        self._covered_until = -1
        self._near_until = -1
        self._fuzzy_ctr = 0

    def on_vload(self, i, vt, now, hier) -> None:
        # runahead entered when a load executes in the ROB (Q&A1): extend
        # coverage to [i, i+depth] — bounds are exact via LBD snooping.
        start = max(i + 1, self._covered_until + 1)
        end = min(vt.n_ops, i + 1 + self.depth)
        t = now
        cur_bound = vt.bound[i]
        kind, bound, all_lines = vt.kind, vt.bound, vt.lines
        l2_mshr = hier.l2.mshr
        for j in range(start, end):
            kj = kind[j]
            if kj == KIND_COMPUTE:
                self._covered_until = j
                continue
            if not self.scd and kj == KIND_INDIRECT:
                self._covered_until = j   # chain unresolvable without SCD
                continue
            lines = all_lines[j]
            if len(l2_mshr) + len(lines) > self.mshr_cap:
                break  # MSHR-file full: resume next trigger (non-blocking)
            t += (1.0 / 16.0) if self.vmig else float(len(lines))
            if not self.lbd and bound[j] != cur_bound \
                    and not bound_ok(bound[j], vt.pc[j]):
                # boundary-blind: mispredicted chain past the row end
                junk = vt.addr_last[j] // LINE_BYTES + 4
                self.issued_lines += hier.prefetch_lines(
                    range(junk, junk + min(4, len(lines))), t,
                    self.mshr_cap)
                self._covered_until = j
                continue
            self.issued_lines += hier.prefetch_lines(lines, t,
                                                     self.mshr_cap)
            if kj == KIND_INDIRECT:
                # coverage-oriented fuzzy range loading: deterministic
                # trailing-line over-fetch every ``fuzzy_every`` rows
                # (fuzzy_every=0 disables — ablation knob)
                self._fuzzy_ctr += 1
                if self.fuzzy_every and \
                        self._fuzzy_ctr % self.fuzzy_every == 0:
                    self.issued_lines += hier.prefetch_lines(
                        (lines[-1] + 1,), t, self.mshr_cap)
            self._covered_until = j
        if not self.fill_nsb:
            return
        # near window: stage imminently-needed indirect lines from L2 (or
        # the in-flight far prefetch) into the NSB — this is what cuts
        # NPU-to-L2 latency during actual load execution (paper §IV-G)
        nstart = max(i + 1, self._near_until + 1)
        nend = min(vt.n_ops, i + 1 + self.near_depth)
        for j in range(nstart, nend):
            self._near_until = j
            if kind[j] != KIND_INDIRECT:
                continue
            self.issued_lines += hier.prefetch_lines(
                all_lines[j], now, self.mshr_cap, into_nsb=True)


# live, read-only view of the registry kept for backwards compatibility
# with the seed's hardcoded ``PREFETCHERS`` dict
PREFETCHERS = MappingProxyType(_REGISTRY)
