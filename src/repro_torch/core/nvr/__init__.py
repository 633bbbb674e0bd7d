"""Paper-faithful NVR simulator: NPU + cache hierarchy + prefetchers.

The timing loop is the event-driven :class:`~.engine.core.SimEngine`
(see ``engine/``); traces come from the synthetic Table-II generators
(``traces``) or from real serving/model traffic via the capture adapters
(``capture``).

This is the port's own copy of the reference's ``repro.core.nvr``
(numpy and the standard library only), kept unchanged so the two give
bitwise the same traces and results; the port imports nothing of the
reference package.
"""

from . import capture
from .engine import (SimConfig, SimEngine, SweepSpec, available_prefetchers,
                     compile_trace, get_prefetcher, register_prefetcher,
                     run_sweep, write_artifacts)
from .engine.vectrace import VecTrace
from .machine import Cache, DRAM, Hierarchy, make_hierarchy, LINE_BYTES
from .prefetchers import (DVR, IMP, NVR, PREFETCHERS, Prefetcher,
                          StreamPrefetcher)
from .sim import (MODES_FIG5, SimResult, SweepResult, demand_miss_reduction,
                  demand_miss_reduction_from, run_modes, simulate)
from .trace import Compute, Trace, TraceBuilder, VLoad
from .traces import WORKLOADS, make_trace

__all__ = [
    "capture",
    "SimConfig", "SimEngine", "SweepSpec", "available_prefetchers",
    "compile_trace", "get_prefetcher", "register_prefetcher", "run_sweep",
    "write_artifacts", "VecTrace",
    "Cache", "DRAM", "Hierarchy", "make_hierarchy", "LINE_BYTES",
    "DVR", "IMP", "NVR", "PREFETCHERS", "Prefetcher", "StreamPrefetcher",
    "MODES_FIG5", "SimResult", "SweepResult", "demand_miss_reduction",
    "demand_miss_reduction_from", "run_modes", "simulate",
    "Compute", "Trace", "TraceBuilder", "VLoad", "WORKLOADS", "make_trace",
]
