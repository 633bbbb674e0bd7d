"""Unified simulation configuration.

The seed scattered its knobs across ``simulate()`` keyword arguments and
module-level constants; :class:`SimConfig` collects every one of them in a
single dataclass that builds the memory hierarchy and the (registry-
resolved) prefetcher, so sweeps, capture replays, and tests all construct
runs the same way.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..machine import Hierarchy, make_hierarchy
from .registry import get_prefetcher

ISSUE = 1.0     # cycles to issue a vector load
HIT_LAT = 2.0   # scratchpad/L1-equivalent hit latency
OOO_WINDOW = 8  # ideal-OoO outstanding vector loads (coarse-grained NPU ROB)
DMA_GRANULE_LINES = 4  # rigid preload granularity without µ-inst prefetch

MODES = ("dense", "inorder", "ooo")


@dataclass
class SimConfig:
    """Everything one simulator run depends on.

    ``mode`` is the execution model (dense / inorder / ooo); ``prefetcher``
    is the registry name of an optional prefetcher riding on top of the
    in-order core (the Fig. 5 ``stream``/``imp``/``dvr``/``nvr`` bars).
    """

    mode: str = "inorder"
    prefetcher: str | None = None
    l2_kb: int = 256
    nsb_kb: int = 0
    dram_latency: float = 150.0
    dram_bw: float = 16.0
    pf_kwargs: dict = field(default_factory=dict)
    issue_cycles: float = ISSUE
    hit_latency: float = HIT_LAT
    ooo_window: int = OOO_WINDOW
    dma_granule_lines: int = DMA_GRANULE_LINES

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.prefetcher:
            get_prefetcher(self.prefetcher)  # raises on unknown name

    def replace(self, **kw) -> "SimConfig":
        return replace(self, **kw)

    def build_hierarchy(self) -> Hierarchy:
        return make_hierarchy(l2_kb=self.l2_kb, nsb_kb=self.nsb_kb,
                              dram_latency=self.dram_latency,
                              dram_bw=self.dram_bw)

    def build_prefetcher(self):
        """Instantiate the configured prefetcher (fresh state per run)."""
        if not self.prefetcher:
            return None
        kwargs = dict(self.pf_kwargs)
        if self.prefetcher == "nvr" and self.nsb_kb \
                and "fill_nsb" not in kwargs:
            # the NSB is a *speculative* buffer: NVR prefetches fill it
            kwargs["fill_nsb"] = True
        return get_prefetcher(self.prefetcher)(**kwargs)
