"""Simulation result records + sweep accumulation (CSV/JSON)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class SimResult:
    workload: str
    mode: str                 # execution model: dense | inorder | ooo
    dtype_bytes: int
    nsb_kb: int
    total: float
    base: float
    stall: float
    compute: float
    n_vloads: int
    demand_misses: int
    l2_accesses: int
    demand_offchip: float
    prefetch_offchip: float
    pf_issued: int
    pf_used: int
    prefetcher: str = ""      # registry name, "" when no prefetcher ran
    nsb_hits: int = 0
    coverage: float = float("nan")  # filled by sweeps vs baseline

    @property
    def label(self) -> str:
        """Fig. 5 bar label: the prefetcher when one ran, else the mode.
        (The seed overwrote ``mode`` with the prefetcher name; the two are
        now separate fields and ``label`` is the display key.)"""
        return self.prefetcher or self.mode

    @property
    def offchip(self) -> float:
        return self.demand_offchip + self.prefetch_offchip

    @property
    def accuracy(self) -> float:
        return self.pf_used / self.pf_issued if self.pf_issued else float("nan")

    @property
    def miss_rate(self) -> float:
        return self.demand_misses / max(1, self.l2_accesses)


CSV_HEADER = ("workload,mode,prefetcher,dtype_bytes,nsb_kb,total,base,stall,"
              "compute,n_vloads,demand_misses,miss_rate,accuracy,coverage,"
              "demand_offchip,prefetch_offchip,offchip")


def _csv_row(r: SimResult) -> str:
    return (f"{r.workload},{r.mode},{r.prefetcher},{r.dtype_bytes},"
            f"{r.nsb_kb},{r.total:.0f},{r.base:.0f},{r.stall:.0f},"
            f"{r.compute:.0f},{r.n_vloads},{r.demand_misses},"
            f"{r.miss_rate:.4f},{r.accuracy:.4f},{r.coverage:.4f},"
            f"{r.demand_offchip:.0f},{r.prefetch_offchip:.0f},"
            f"{r.offchip:.0f}")


@dataclass
class SweepResult:
    rows: list = field(default_factory=list)

    def add(self, r: SimResult) -> None:
        self.rows.append(r)

    def extend(self, rs) -> None:
        self.rows.extend(rs)

    def csv(self) -> str:
        return "\n".join([CSV_HEADER] + [_csv_row(r) for r in self.rows])

    def to_records(self) -> list[dict]:
        keys = CSV_HEADER.split(",")
        out = []
        for r in self.rows:
            rec = {k: getattr(r, k) for k in keys
                   if k not in ("miss_rate", "accuracy", "offchip")}
            rec.update(miss_rate=r.miss_rate, accuracy=r.accuracy,
                       offchip=r.offchip, label=r.label)
            out.append(rec)
        return out

    def json(self, **meta) -> str:
        return json.dumps({"meta": meta, "rows": self.to_records()},
                          indent=1, default=float)
