"""Table I — NVR hardware overhead accounting (bit-exact reimplementation).

We re-derive every structure's storage from its fields.  The paper's printed
per-row subtotals contain small arithmetic inconsistencies (e.g. SCD row
prints ``48 + 32×77 = 2464`` which is not self-consistent); we report both
the field-sum and the paper's printed subtotal, and the headline total
(9.72 KiB + optional 16 KiB NSB) as printed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class Structure:
    name: str
    n: int
    fields: dict          # field name -> bits (already multiplied by N where due)
    paper_bits: int

    @property
    def bits(self) -> int:
        return int(sum(self.fields.values()))


def table1(n: int = 16) -> list[Structure]:
    lg = int(math.ceil(math.log2(n)))
    n2 = 2 * n
    lg2 = int(math.ceil(math.log2(n2)))
    sd = Structure("SD", n, {
        "pc": 48, "entry_id": n * lg, "prev_addr": 48 * n, "stride": 8 * n,
        "last_prefetch_addr": 48 * n, "stride_conf": 2 * n,
    }, paper_bits=1808)
    scd = Structure("SCD", n2, {
        "pc": 48, "entry_id": n2 * lg2, "lpi": 10 * n2, "ss_start": 48 * n2,
        "ss_offset": 10 * n2, "vector_size": 4 * n2, "valid": n2,
    }, paper_bits=2464)
    lbd = Structure("LBD", n, {
        "pc": 48 * n, "entry_id": n * lg, "loop_boundary": 16 * n,
        "iteration_counter": 16 * n, "increment": 16 * n,
        "boundary_conf": 4 * n, "sparse_mode": n, "level_conf": 2 * n,
    }, paper_bits=3424)
    vmig = Structure("VMIG", n2, {
        "pc": 48 * n2, "entry_id": n2 * lg2, "vrf": 64 * n2, "pie": 64 * n2,
        "iru": 4 * n2 + 4, "vigu": 256,
    }, paper_bits=3204)
    snoop = Structure("Snooper", n, {
        "cpu_pc": 48, "cpu_reg": 64, "npu_pc": 48,
        "sparse_structure": (48 + 10 + 10) * n,
    }, paper_bits=1248)
    return [sd, scd, lbd, vmig, snoop]


PAPER_TOTAL_KIB = 9.72
NSB_KIB = 16.0


def report(n: int = 16) -> str:
    rows = table1(n)
    out = ["structure,N,field_sum_bits,paper_bits"]
    for s in rows:
        out.append(f"{s.name},{s.n},{s.bits},{s.paper_bits}")
    field_total = sum(s.bits for s in rows)
    out.append(f"TOTAL_field_sum_bits,,{field_total},"
               f"{sum(s.paper_bits for s in rows)}")
    out.append(f"TOTAL_paper_headline_KiB,,{PAPER_TOTAL_KIB},"
               f"(+{NSB_KIB} KiB optional NSB)")
    return "\n".join(out)
