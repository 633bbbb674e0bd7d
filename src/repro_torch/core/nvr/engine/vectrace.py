"""Structure-of-arrays trace compilation.

The seed loop recomputed ``np.unique(op.addrs // LINE_BYTES)`` for every op
on every ``simulate()`` call — a full Fig. 5 sweep touches each op seven
times from the engine plus O(window) more times from prefetcher runahead
scans.  :func:`compile_trace` does that work exactly once per trace and
lowers every per-op scalar the engine or a prefetcher reads (kind, bound,
PC, first/last address, line list) into flat arrays, so the hot loops do
plain list indexing instead of dataclass attribute access and isinstance
dispatch.

The compiled form is cached on the ``Trace`` object: all seven Fig. 5 mode
runs of ``run_modes()`` share one compilation.
"""

from __future__ import annotations

import numpy as np

from ..machine import LINE_BYTES
from ..trace import Compute, Trace

KIND_COMPUTE = 0
KIND_STREAM = 1
KIND_INDIRECT = 2

_CACHE_ATTR = "_vectrace"


class VecTrace:
    """Read-only structure-of-arrays view of a :class:`Trace`.

    Per-op scalars are Python lists (fastest for interpreter-loop access);
    the unique-line sets are additionally exposed flat (``lines_flat`` /
    ``lines_off``) for vectorized analytics (e.g. footprint statistics in
    the sweep runner).
    """

    __slots__ = (
        "trace", "n_ops", "kind", "cycles", "bound", "pc", "idx_pc",
        "addr_first", "addr_last", "n_addrs", "lines",
        "n_vloads", "total_compute", "_flat_cache",
    )

    # 64 is a power of two and addresses are non-negative, so the line id
    # is a plain right-shift — set/sort over <=16 Python ints beats
    # np.unique's fixed overhead by ~3x at trace-compile time
    _LINE_SHIFT = LINE_BYTES.bit_length() - 1

    def __init__(self, trace: Trace) -> None:
        self.trace = trace
        n = len(trace.ops)
        self.n_ops = n
        kind: list[int] = [0] * n
        cycles: list[float] = [0.0] * n
        bound: list[int] = [0] * n
        pc: list[int] = [0] * n
        idx_pc: list[int] = [-1] * n
        addr_first: list[int] = [0] * n
        addr_last: list[int] = [0] * n
        n_addrs: list[int] = [0] * n
        lines: list[tuple] = [()] * n
        shift = self._LINE_SHIFT
        n_vloads = 0
        total_compute = 0.0
        for i, op in enumerate(trace.ops):
            if isinstance(op, Compute):
                cycles[i] = op.cycles
                total_compute += op.cycles
                continue
            n_vloads += 1
            kind[i] = KIND_INDIRECT if op.kind == "indirect" else KIND_STREAM
            bound[i] = op.bound_id
            pc[i] = op.pc
            idx_pc[i] = op.idx_pc
            addrs = op.addrs.tolist()
            addr_first[i] = addrs[0]
            addr_last[i] = addrs[-1]
            n_addrs[i] = len(addrs)
            lines[i] = tuple(sorted({a >> shift for a in addrs}))
        self.kind = kind
        self.cycles = cycles
        self.bound = bound
        self.pc = pc
        self.idx_pc = idx_pc
        self.addr_first = addr_first
        self.addr_last = addr_last
        self.n_addrs = n_addrs
        self.lines = lines
        self.n_vloads = n_vloads
        self.total_compute = total_compute
        self._flat_cache = None

    # -- analytics ---------------------------------------------------------
    @property
    def lines_flat(self) -> np.ndarray:
        """All per-op unique lines, concatenated (lazy; analytics only)."""
        if self._flat_cache is None:
            off = np.zeros(self.n_ops + 1, dtype=np.int64)
            for i, ln in enumerate(self.lines):
                off[i + 1] = off[i] + len(ln)
            flat = np.fromiter(
                (l for ln in self.lines for l in ln), dtype=np.int64,
                count=int(off[-1]))
            self._flat_cache = (flat, off)
        return self._flat_cache[0]

    @property
    def lines_off(self) -> np.ndarray:
        """Per-op offsets into :attr:`lines_flat` (length ``n_ops + 1``)."""
        self.lines_flat  # ensure built
        return self._flat_cache[1]

    def footprint_lines(self) -> int:
        """Distinct cache lines touched by the whole trace."""
        return int(np.unique(self.lines_flat).size)

    def line_reuse(self) -> float:
        """Mean touches per distinct line (>1 means temporal reuse)."""
        fp = self.footprint_lines()
        return float(self.lines_flat.size / fp) if fp else float("nan")


def compile_trace(trace: Trace) -> VecTrace:
    """Compile (and cache on the trace) the structure-of-arrays form."""
    vt = getattr(trace, _CACHE_ATTR, None)
    if vt is None or vt.trace is not trace:
        vt = VecTrace(trace)
        setattr(trace, _CACHE_ATTR, vt)
    return vt
