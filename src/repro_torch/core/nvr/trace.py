"""Trace representation for the NVR simulator.

A trace is the NPU-visible instruction stream of one sparse kernel region:
interleaved vector loads (16-lane, matching the paper's N=16 parallel width)
and compute tiles.  Indirect loads carry *chain metadata* — the information a
hardware snooper would extract from the NPU's sparse-unit registers (base
address, index values, row boundaries).  Prefetchers are given access to
exactly the fields their mechanism could observe in hardware:

  * stream  prefetcher: past addresses per PC only
  * IMP     : index-load values after completion + learned (base, shift)
  * DVR     : lookahead within the current bound (boundary-blind runahead)
  * NVR     : lookahead across bounds with exact boundaries (snooped)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

VECTOR_LANES = 16


@dataclass
class VLoad:
    pc: int
    addrs: np.ndarray            # byte addresses, one per active lane
    kind: str                    # "stream" | "indirect"
    bound_id: int = 0            # row / expert / query id (loop instance)
    idx_pc: int = -1             # PC of the stream load producing the indices
    idx_values: np.ndarray | None = None  # indices backing indirect addrs
    base: int = 0                # base address of the indirectly-indexed array
    elem_shift: int = 0          # log2(bytes per indexed element row step)


@dataclass
class Compute:
    cycles: float


Op = VLoad | Compute


@dataclass
class Trace:
    """Instruction stream + region map (for NSB indirect-line filtering)."""

    ops: list
    name: str = ""
    indirect_regions: list = field(default_factory=list)  # (lo, hi) bytes
    dense_compute_scale: float = 1.0  # dense/sparse compute ratio (Fig. 5)
    meta: dict = field(default_factory=dict)

    def is_indirect_addr(self, addr: int) -> bool:
        for lo, hi in self.indirect_regions:
            if lo <= addr < hi:
                return True
        return False

    @property
    def n_vloads(self) -> int:
        return sum(1 for o in self.ops if isinstance(o, VLoad))

    def total_compute(self) -> float:
        return sum(o.cycles for o in self.ops if isinstance(o, Compute))


class TraceBuilder:
    """Helper that lays out arrays in a flat byte address space and emits
    (stream index load -> indirect gather -> compute) bundles the way the
    paper's SpMM listing does (Fig. 2)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.ops: list = []
        self._cursor = 0x1000_0000
        self.regions: dict[str, tuple[int, int]] = {}
        self.indirect_regions: list = []
        self._bound = 0

    def alloc(self, name: str, nbytes: int, indirect: bool = False) -> int:
        base = self._cursor
        self._cursor += (nbytes + 4095) // 4096 * 4096 + 4096
        self.regions[name] = (base, base + nbytes)
        if indirect:
            self.indirect_regions.append((base, base + nbytes))
        return base

    def new_bound(self) -> int:
        self._bound += 1
        return self._bound

    def stream_load(self, pc: int, base: int, offsets: np.ndarray,
                    elem_bytes: int, bound: int | None = None) -> None:
        addrs = base + offsets.astype(np.int64) * elem_bytes
        self.ops.append(VLoad(pc=pc, addrs=addrs, kind="stream",
                              bound_id=self._bound if bound is None else bound))

    def indirect_load(self, pc: int, base: int, idx: np.ndarray,
                      elem_shift: int, idx_pc: int,
                      bound: int | None = None) -> None:
        addrs = base + (idx.astype(np.int64) << elem_shift)
        self.ops.append(VLoad(
            pc=pc, addrs=addrs, kind="indirect",
            bound_id=self._bound if bound is None else bound,
            idx_pc=idx_pc, idx_values=idx.astype(np.int64), base=base,
            elem_shift=elem_shift))

    def compute(self, cycles: float) -> None:
        self.ops.append(Compute(cycles))

    def build(self, dense_compute_scale: float = 1.0, **meta) -> Trace:
        return Trace(ops=self.ops, name=self.name,
                     indirect_regions=self.indirect_regions,
                     dense_compute_scale=dense_compute_scale, meta=meta)


def chunk_lanes(values: np.ndarray, lanes: int = VECTOR_LANES):
    """Split an index vector into <=lanes-wide vector-instruction groups."""
    for i in range(0, len(values), lanes):
        yield values[i:i + lanes]
