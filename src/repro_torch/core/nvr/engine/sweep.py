"""Grid sweep runner: workload x dtype x prefetcher x nsb_kb.

``run_sweep(SweepSpec(...))`` drives the event-driven engine over the full
grid and returns a :class:`~.result.SweepResult`; ``write_artifacts``
persists any benchmark's rows as paired CSV + JSON files so downstream
tooling (plots, dashboards, regression diffs) has one artifact format.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from .config import SimConfig
from .core import SimEngine
from .result import SimResult, SweepResult

#: Fig. 5 bar set: three execution models + four prefetchers on in-order.
POINTS_FIG5 = ("dense", "inorder", "ooo", "stream", "imp", "dvr", "nvr")


def _point_config(point: str, **kw) -> SimConfig:
    """A sweep *point* is either an execution mode or a prefetcher name
    riding on the in-order core (the Fig. 5 convention)."""
    if point in ("dense", "inorder", "ooo"):
        return SimConfig(mode=point, **kw)
    return SimConfig(mode="inorder", prefetcher=point, **kw)


@dataclass
class SweepSpec:
    workloads: tuple = ()            # () -> all Table-II workloads
    dtypes: tuple = (1, 2, 4)        # INT8 / FP16 / INT32
    points: tuple = POINTS_FIG5
    nsb_kbs: tuple = (0, 16)
    l2_kb: int = 256
    scale: float = 0.5
    pf_kwargs: dict = field(default_factory=dict)

    def grid_size(self) -> int:
        from ..traces import WORKLOADS
        n_wl = len(self.workloads or WORKLOADS)
        return n_wl * len(self.dtypes) * len(self.points) * len(self.nsb_kbs)


def _run_cell(spec: SweepSpec, wl: str, dtb: int) -> list[SimResult]:
    """All (nsb_kb x point) runs for one (workload, dtype) cell.  The trace
    is generated inside the cell so worker processes never pickle traces;
    one VecTrace compilation is shared by every run in the cell."""
    from ..traces import make_trace

    trace = make_trace(wl, dtype_bytes=dtb, scale=spec.scale)
    out: list[SimResult] = []
    for nsb_kb in spec.nsb_kbs:
        baseline: SimResult | None = None
        for point in spec.points:
            cfg = _point_config(point, l2_kb=spec.l2_kb, nsb_kb=nsb_kb,
                                pf_kwargs=dict(spec.pf_kwargs))
            r = SimEngine(cfg).run(trace, dtype_bytes=dtb)
            if point == "inorder":
                baseline = r
            if baseline is not None and baseline.demand_misses:
                r.coverage = 1.0 - r.demand_misses / baseline.demand_misses
            out.append(r)
    return out


def _run_cell_star(args) -> list[SimResult]:
    return _run_cell(*args)


def run_sweep(spec: SweepSpec, workers: int = 1) -> SweepResult:
    """Run the grid; coverage is annotated per (workload, dtype, nsb_kb)
    against that cell's in-order baseline.

    ``workers > 1`` fans the (workload, dtype) cells out over a process
    pool — every cell is independent, results are deterministic and
    returned in grid order regardless of worker count."""
    from ..traces import WORKLOADS

    cells = [(spec, wl, dtb)
             for wl in (spec.workloads or tuple(WORKLOADS))
             for dtb in spec.dtypes]
    out = SweepResult()
    if workers > 1 and len(cells) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # spawn, not fork: the caller may have a multithreaded jax
        # runtime loaded, and the workers only need numpy anyway
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=ctx) as ex:
            for rows in ex.map(_run_cell_star, cells):
                out.extend(rows)
    else:
        for cell in cells:
            out.extend(_run_cell_star(cell))
    return out


def write_artifacts(name: str, header: str, rows: list, out_dir: str,
                    **meta) -> dict:
    """Write ``rows`` (sequences matching the comma-separated ``header``)
    as ``<name>.csv`` and ``<name>.json`` under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, f"{name}.csv")
    with open(csv_path, "w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    keys = header.split(",")
    json_path = os.path.join(out_dir, f"{name}.json")
    with open(json_path, "w") as f:
        json.dump({"meta": meta,
                   "rows": [dict(zip(keys, r)) for r in rows]},
                  f, indent=1, default=float)
    return {"csv": csv_path, "json": json_path}


def write_sweep(result: SweepResult, out_dir: str, name: str = "sweep",
                **meta) -> dict:
    """Persist a SweepResult as CSV + JSON artifacts."""
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, f"{name}.csv")
    with open(csv_path, "w") as f:
        f.write(result.csv() + "\n")
    json_path = os.path.join(out_dir, f"{name}.json")
    with open(json_path, "w") as f:
        f.write(result.json(**meta))
    return {"csv": csv_path, "json": json_path}
