"""Event-driven NVR simulation engine.

The package splits the seed's monolithic ``simulate()`` loop into:

* ``config``    — :class:`SimConfig`, one dataclass for every knob that was
  previously scattered across ``simulate()`` keyword arguments.
* ``registry``  — the ``@register_prefetcher`` decorator; prefetchers
  self-register and are instantiated by name.
* ``vectrace``  — :class:`VecTrace`, a structure-of-arrays compilation of a
  :class:`~repro_torch.core.nvr.trace.Trace` with per-op unique cache-line arrays
  precomputed once and shared by every mode/prefetcher run.
* ``core``      — :class:`SimEngine`, the event-driven timing loop.
  Observers (prefetchers, capture hooks, stats collectors) subscribe to
  ``vload`` / ``miss`` / ``retire`` events instead of being hardcoded.
* ``reference`` — a frozen copy of the seed per-op/per-line loop, kept as
  the parity oracle and the baseline for the speedup benchmark.
* ``sweep``     — grid runner (workload x dtype x prefetcher x nsb_kb)
  emitting CSV + JSON artifacts.
"""

from .config import (DMA_GRANULE_LINES, HIT_LAT, ISSUE, OOO_WINDOW,
                     SimConfig)
from .core import SimEngine
from .registry import (available_prefetchers, get_prefetcher,
                       register_prefetcher)
from .sweep import SweepSpec, run_sweep, write_artifacts
from .vectrace import (KIND_COMPUTE, KIND_INDIRECT, KIND_STREAM, VecTrace,
                       compile_trace)

__all__ = [
    "DMA_GRANULE_LINES", "HIT_LAT", "ISSUE", "OOO_WINDOW", "SimConfig",
    "SimEngine",
    "available_prefetchers", "get_prefetcher", "register_prefetcher",
    "SweepSpec", "run_sweep", "write_artifacts",
    "KIND_COMPUTE", "KIND_INDIRECT", "KIND_STREAM", "VecTrace",
    "compile_trace",
]
