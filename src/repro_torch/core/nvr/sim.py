"""Simulation driver facade + Fig. 5 mode set.

Execution modes (Fig. 5 bars):
  dense    — no sparsity skipping: regular streaming, perfectly prefetchable,
             but ``dense_compute_scale`` × the compute.
  inorder  — sparse, serial load/compute (baseline Gemmini).
  ooo      — sparse, *ideal* OoO: loads overlap compute; wall-clock is
             max(compute path, memory path).  Still suboptimal when IO-bound
             (the paper's point in §II-B).
  inorder + prefetcher — stream / imp / dvr / nvr, optional NSB.

The timing loop itself lives in :mod:`.engine.core` (event-driven, driven
by a structure-of-arrays compiled trace); this module keeps the seed's
``simulate()`` / ``run_modes()`` call signatures as thin wrappers so
existing call sites and notebooks keep working.
"""

from __future__ import annotations

from .engine.config import (DMA_GRANULE_LINES, HIT_LAT, ISSUE, OOO_WINDOW,
                            SimConfig)
from .engine.core import SimEngine
from .engine.result import SimResult, SweepResult
from .trace import Trace

__all__ = [
    "DMA_GRANULE_LINES", "HIT_LAT", "ISSUE", "OOO_WINDOW",
    "SimConfig", "SimEngine", "SimResult", "SweepResult",
    "MODES_FIG5", "simulate", "run_modes", "demand_miss_reduction",
    "demand_miss_reduction_from",
]


def simulate(trace: Trace, mode: str = "inorder",
             prefetcher: str | None = None, l2_kb: int = 256,
             nsb_kb: int = 0, dram_latency: float = 150.0,
             dram_bw: float = 16.0, pf_kwargs: dict | None = None,
             dtype_bytes: int = 0) -> SimResult:
    """One run with the seed's keyword-argument surface."""
    cfg = SimConfig(mode=mode, prefetcher=prefetcher, l2_kb=l2_kb,
                    nsb_kb=nsb_kb, dram_latency=dram_latency,
                    dram_bw=dram_bw, pf_kwargs=dict(pf_kwargs or {}))
    return SimEngine(cfg).run(trace, dtype_bytes=dtype_bytes)


MODES_FIG5 = ["dense", "inorder", "ooo", "stream", "imp", "dvr", "nvr"]


def demand_miss_reduction_from(results, target: str = "nvr",
                               baseline: str = "inorder") -> float:
    """Miss-reduction metric over an existing ``run_modes`` result set
    (list of SimResults or a label->SimResult dict) — call sites that
    already ran the mode sweep reuse it instead of simulating twice."""
    rs = results if isinstance(results, dict) \
        else {r.label: r for r in results}
    ino = rs[baseline]
    if not ino.demand_misses:
        return 0.0
    return 1.0 - rs[target].demand_misses / ino.demand_misses


def demand_miss_reduction(trace: Trace, dtype_bytes: int = 2,
                          target: str = "nvr",
                          baseline: str = "inorder") -> float:
    """Fraction of the baseline's demand misses ``target`` eliminates on
    this trace (0.0 when the baseline never misses).  The one shared
    definition the serving launcher, serve_bench, and capture replays
    report, so they cannot drift."""
    return demand_miss_reduction_from(run_modes(trace, dtype_bytes),
                                      target=target, baseline=baseline)


def run_modes(trace: Trace, dtype_bytes: int, nsb_kb: int = 0,
              l2_kb: int = 256) -> list[SimResult]:
    """Run the full Fig. 5 mode set on one trace; annotates coverage.

    Results carry separate ``mode`` and ``prefetcher`` fields; key by
    ``r.label`` to get the Fig. 5 bar names."""
    results = []
    baseline = None
    for mode in MODES_FIG5:
        if mode in ("dense", "inorder", "ooo"):
            r = simulate(trace, mode=mode, l2_kb=l2_kb, nsb_kb=nsb_kb,
                         dtype_bytes=dtype_bytes)
        else:
            r = simulate(trace, mode="inorder", prefetcher=mode,
                         l2_kb=l2_kb, nsb_kb=nsb_kb,
                         dtype_bytes=dtype_bytes)
        if mode == "inorder":
            baseline = r
        if baseline is not None and baseline.demand_misses:
            r.coverage = 1.0 - r.demand_misses / baseline.demand_misses
        results.append(r)
    return results
