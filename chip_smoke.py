#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero and suppresses the
final result line):

1. the card's name and power limit (``nvidia-smi``);
2. every CUDA kernel built from ``src/repro_torch/kernels/csrc`` with
   ``nvcc -Xptxas -v`` (registers, shared memory, spills printed; for
   each tensor-core ``flash_prefill`` and grouped-GEMM instantiation one
   line with its dynamic shared memory too, and one line for each
   instantiation of the decode-attention body ``decode_split_kernel``
   and its merge; a grouped-GEMM instantiation that spills fails the
   phase);
3. each kernel against its plain PyTorch version at the serve path's
   shapes, with times (CUDA events), the plain version's time, the
   bound (bytes or operations at the card's peak rates) and one
   PyTorch library call timed as a yardstick; ``paged_decode_attn`` also
   at gemma-7b's head_dim 256, and bitwise on a repeated call and row by
   row (a row alone equals its row in the batch);
4. the port's main path: ``PagedEngine`` serving 8 requests of about
   1500 prompt tokens on qwen2-1.5b at full width in bfloat16 (seeded
   random weights), with the kernels' launch counts, decode and prefill
   rates, the NSB hit rate and the device busy share of one profiled
   decode step, with the decode-attention kernels' share of it;
5. teacher-forced per-layer check: every layer's decode attention
   inputs of one step go to the kernel and to the plain version;
6. full width in float32, first decode step, ``kernel="cuda"`` against
   ``kernel="torch"``: TopK selections and logits;
7. reduced qwen2-1.5b in float32: the card against the CPU;
8. the MoE kernels against their plain versions at qwen3-moe-235b-a22b's
   decode shapes in bfloat16 and float32, timed beside their bound, the
   plain versions and a ``torch.bmm`` over weights gathered beforehand;
   the attention kernels again at qwen3-moe's head shapes (decode in
   bfloat16, int8 and float32, bitwise on repeat and row by row);
9. the MoE path: ``PagedEngine(expert_pool="paged")`` serving the same
   8 requests on qwen3-moe-235b-a22b at full width, cut to 8 layers,
   in bfloat16 — all four kernels' launches, decode and prefill rates,
   expert hit rates, the host time of the expert-page accounting, peak
   memory and one profiled decode step; then one fresh prefill chunk
   profiled through the grouped GEMM and through ``torch.matmul``: the
   kernel's device-time cost a chunk;
10. teacher-forced per-layer check of the MoE kernels in all 8 layers;
11. 2 layers at full width in float32: ``kernel="cuda"`` against
    ``"torch"`` (routed experts and logits; the cuda route's prefill runs
    the grouped GEMM), and dense against paged experts with
    ``kernel="torch"`` (bitwise);
12. reduced qwen3-moe in float32 with paged experts: card against CPU;
13. the single-batch path's new kernels against their plain versions:
    ``sparse_decode_attn`` at qwen2-1.5b's decode shapes (bfloat16,
    float32 and int8 K/V, with the frontier, and the TPU kernel's
    contract without it), at gemma-7b's head_dim 256 and at
    qwen3-moe's heads (KV=4, G=16) on the single-batch MoE cache, and
    ``gather_rows`` at the embedding lookups of a decode step and of the
    batched prefill (and on ids outside the table, zero rows as on the
    CPU), and ``flash_prefill`` at the path's batched prefill (B=8,
    S=1536) and dense decode step (one query row at the prompt's end),
    timed beside their bound, the plain versions and a PyTorch
    yardstick; ``sparse_decode_attn`` bitwise on a repeated call and row
    by row;
14. the single-batch ``Engine`` on qwen2-1.5b at full width in bfloat16:
    a batch of 8 prompts of 1536 tokens prefilled together, 32 tokens
    decoded in lockstep with TopK sparse attention, then a few dense
    steps — launches, decode ms/step, prefill tokens/s, NSB hit rate,
    peak memory, one profiled decode step and one profiled prefill (the
    share of ``flash_prefill`` in its device time);
15. teacher-forced check of ``sparse_decode_attn`` in all 28 layers of
    one sparse step, and of ``flash_prefill`` in all 28 layers of one
    batched prefill;
16. full width in float32, ``kernel="cuda"`` against ``"torch"``: TopK
    selections of every layer, logits and tokens;
17. the reduced single-batch ``Engine`` (sparse and dense): the card
    against the CPU;
18. the capacity dispatch's grouped GEMM ``moe_dispatch_matmul`` against
    its plain version at the three shapes the MoE paths give it (a
    paged prefill chunk, the single-batch prefill and decode of
    qwen3-moe-235b-a22b) in bfloat16 and at the chunk in float32,
    through the packed experts' strided gate, up and down views; the
    nine bfloat16 rows timed (CUDA events and the profiler's device
    time) beside the bound, the plain version and ``torch.matmul`` over
    ``[E, B*cap, D]``; and
    ``flash_prefill`` at the single-batch MoE prefill (B=8, S=1024,
    H=64, KV=4);
19. the single-batch ``Engine`` on qwen3-moe-235b-a22b at full width,
    cut to 8 layers, in bfloat16: 8 prompts of 1024 tokens prefilled
    together, 16 tokens decoded in lockstep with TopK sparse attention
    and the capacity dispatch — launches, decode ms/step, prefill
    tokens/s, peak memory, one profiled decode step and one profiled
    prefill;
20. teacher-forced check of every kernel of that path in all 8 layers:
    the grouped GEMMs and ``flash_prefill`` (B=8, S=1024, H=64, KV=4)
    of one prefill, then the grouped GEMMs and ``sparse_decode_attn``
    (KV=4, G=16) of one decode step, each call's inputs to the kernel
    and the plain version;
21. ``gather_spmm`` against its plain version at the kernel bench's
    shape and at a pruned qwen2-1.5b down projection over a prefill
    chunk, timed beside its bound, the plain version and
    ``torch.sparse.mm`` on the same matrix in CSR;
22. the port's kernel quickstart (``repro_torch.launch.quickstart``),
    the NVR simulator and the two kernel demos, on the card.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  With ``CHIP_SMOKE_JSON=<path>`` in
the environment a JSON record of every number is written there too.
The script needs a CUDA card and the repository around it: without
either it exits non-zero.

``python3 chip_smoke.py --flash-rows [--src DIR]`` runs phase 1 and only
the ``flash_prefill`` rows at every shape of ``flash_shapes`` (checked
and timed), importing the port from ``DIR/src`` (default: this
checkout's), and prints them as one JSON line: two checkouts timed in
one process each, on one card, compare the kernel's versions.
``--dispatch-rows [--src DIR]`` does the same for the grouped GEMM
``moe_dispatch_matmul`` at its nine rows (three path shapes x gate, up,
down), and ``--decode-rows [--src DIR]`` for ``paged_decode_attn`` and
``sparse_decode_attn`` at the five rows of ``decode_shapes``.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# serve-path shapes of qwen2-1.5b (full width)
N_REQ, PROMPT, GEN, CHUNK = 8, 1500, 32, 256

# the MoE path: qwen3-moe-235b-a22b at full width, cut to 8 layers (one
# card holds 8 layers of experts: 38.7 GB in bfloat16)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 8

DECODE_TPU = "src/repro/kernels/paged_decode_attn.py:129"
PREFILL_TPU = "src/repro/kernels/flash_prefill.py:106"
GATEUP_TPU = "src/repro/kernels/moe_dispatch.py:147"
DOWN_TPU = "src/repro/kernels/moe_dispatch.py:213"
SPARSE_TPU = "src/repro/kernels/sparse_decode_attn.py:98"
GATHER_TPU = "src/repro/kernels/gather_rows.py:45"
DISPATCH_TPU = "src/repro/kernels/moe_dispatch.py:81"
SPMM_TPU = "src/repro/kernels/gather_spmm.py:52"

# the device kernels of flash_prefill.cu (tensor cores, the merge of the
# key splits, the float32 loop) and, for --src of an older checkout, the
# first port's flash_prefill_kernel
FLASH_KERNELS = ("flash_wgmma_kernel", "flash_merge_kernel",
                 "flash_simt_kernel", "flash_prefill_kernel")

# the device kernels of the two decode-attention kernels (the split-page
# body and its merge pass) and, for --src of an older checkout, the first
# port's paged_decode_kernel and sparse_decode_kernel
DECODE_KERNELS = ("decode_split_kernel", "decode_merge_kernel",
                  "paged_decode_kernel", "sparse_decode_kernel")

# the single-batch path: 8 prompts of 1536 tokens, 32 generated, TopK 64
# of 98 pages of 16
SB_BATCH, SB_PROMPT, SB_GEN, SB_DENSE_STEPS = 8, 1536, 32, 4

# the single-batch MoE path: 8 prompts of 1024 tokens, 16 generated
MSB_BATCH, MSB_PROMPT, MSB_GEN = 8, 1024, 16

record: dict = {"phases": {}}
failures: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def run_phase(name: str, fn) -> None:
    t0 = time.perf_counter()
    log(f"== phase {name}")
    try:
        fn()
        ok = True
    except Exception:                       # a phase failure is reported,
        traceback.print_exc()               # the later phases still run
        failures.append(name)
        ok = False
    dt = time.perf_counter() - t0
    record["phases"][name] = {"ok": ok, "seconds": dt}
    log(f"== phase {name}: {'ok' if ok else 'FAILED'} ({dt:.1f} s)")


def free_cuda() -> None:
    """Free the card memory that dropped objects held, reference cycles
    included, and hand the cached blocks back to the device."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, replays: int = 20) -> float:
    """Device time of ``fn()`` without the host's launch path: ``fn`` is
    captured once in a CUDA graph, then the graph is replayed between two
    CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / replays


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# -- phase 1 -------------------------------------------------------------------

def phase_card() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    record["card"] = out[0]
    log(out[0])


# -- phase 2 -------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import _build
    reports = _build.build_all()
    for name, rep in reports.items():
        log(f"[build] {name}.cu -> {_build.build_dir() / f'lib{name}.so'}")
        for line in rep.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                log(f"[ptxas] {line.strip()}")
    record["ptxas"] = reports
    flash_ptxas()
    dispatch_ptxas()
    decode_ptxas()


def flash_ptxas() -> None:
    """One line per instantiation of the tensor-core ``flash_prefill``:
    registers and spills from ``-Xptxas -v``, and its dynamic shared
    memory (which ptxas does not see)."""
    import re

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_prefill import wgmma_smem_bytes
    rows = []
    for block in _build.ptxas_reports["flash_prefill"].split(
            "Compiling entry function")[1:]:
        kern = re.search(r"flash_wgmma_kernelILi(\d+)ELb(\d)", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if not (kern and regs and spill):
            continue
        d, int8 = int(kern[1]), kern[2] == "1"
        smem = wgmma_smem_bytes(d, torch.int8 if int8 else torch.bfloat16)
        rows.append({"D": d, "int8": int8, "registers": int(regs[1]),
                     "spill_stores": int(spill[1]),
                     "spill_loads": int(spill[2]), "smem_bytes": smem})
        log(f"[ptxas] flash_wgmma_kernel D={d} {'int8' if int8 else 'bf16'} "
            f"K/V: {regs[1]} registers, {spill[1]} bytes spill stores, "
            f"{spill[2]} bytes spill loads, {smem} bytes dynamic shared "
            f"memory")
    record["flash_prefill_ptxas"] = rows
    assert len(rows) == 8, "not every flash_wgmma_kernel reported"


def dispatch_ptxas() -> None:
    """One line per instantiation of the grouped GEMM's tensor-core
    kernel (128 x 256 tiles, B K- or MN-major): registers and spills from
    ``-Xptxas -v`` and its dynamic shared memory.  Fails if one
    spills."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_dispatch import gemm_smem_bytes
    rows = []
    for block in _build.ptxas_reports["moe_dispatch"].split(
            "Compiling entry function")[1:]:
        kern = re.search(r"grouped_wgmma_kernelILb(\d)", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if not (kern and regs and spill):
            continue
        mn = kern[1] == "1"
        smem = gemm_smem_bytes()
        rows.append({"BM": 128, "BN": 256, "mn_major": mn,
                     "registers": int(regs[1]),
                     "spill_stores": int(spill[1]),
                     "spill_loads": int(spill[2]), "smem_bytes": smem})
        log(f"[ptxas] grouped_wgmma_kernel 128x256 "
            f"{'MN' if mn else 'K'}-major w: {regs[1]} registers, "
            f"{spill[1]} bytes spill stores, {spill[2]} bytes spill loads, "
            f"{smem} bytes dynamic shared memory")
    record["moe_dispatch_ptxas"] = rows
    assert len(rows) == 2, "not every grouped_wgmma_kernel reported"
    spilled = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    assert not spilled, f"grouped_wgmma_kernel spills: {spilled}"


def decode_ptxas() -> None:
    """One line per instantiation of the decode-attention body
    (``decode_split_kernel``, q dtype x K/V dtype x D, in each of its two
    libraries) and of its merge pass: registers and spills from
    ``-Xptxas -v``.  The aim, not a gate: no bf16 instantiation spills."""
    import re

    from repro_torch.kernels import _build
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8"}
    rows = []
    for lib in ("paged_decode_attn", "sparse_decode_attn"):
        for block in _build.ptxas_reports[lib].split(
                "Compiling entry function")[1:]:
            # a second bfloat16 in a mangled name is a substitution, S<n>_
            kern = re.search(r"decode_(split|merge)_kernelI(f|13__nv_bfloat16)"
                             r"(?:(f|13__nv_bfloat16|a|S\d*_)Li(\d+)E)?",
                             block)
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            if not (kern and regs and spill):
                continue
            row = {"library": lib, "kernel": f"decode_{kern[1]}_kernel",
                   "q": types[kern[2]],
                   "kv": types.get(kern[3], "bf16") if kern[3] else None,
                   "D": int(kern[4]) if kern[4] else None,
                   "registers": int(regs[1]), "spill_stores": int(spill[1]),
                   "spill_loads": int(spill[2])}
            rows.append(row)
            what = (f"q {row['q']} K/V {row['kv']} D={row['D']}"
                    if row["kv"] else f"out {row['q']}")
            log(f"[ptxas] {lib}: {row['kernel']} {what}: {regs[1]} "
                f"registers, {spill[1]} bytes spill stores, {spill[2]} "
                f"bytes spill loads")
    record["decode_ptxas"] = rows
    n_split = sum(r["kernel"] == "decode_split_kernel" for r in rows)
    assert n_split == 48, f"{n_split} of 48 decode_split_kernel reported"
    bf16 = [r for r in rows if r["kv"] == "bf16"
            and (r["spill_stores"] or r["spill_loads"])]
    log(f"[ptxas] bf16 K/V instantiations of decode_split_kernel that "
        f"spill: {len(bf16)} (aim: none)")


# -- phase 3 -------------------------------------------------------------------

def decode_case(gen, pool_dtype, q_dtype, n_layers=1, R=N_REQ, KV=2, G=6,
                D=128, page=16, K=64, NL=96):
    """A pool in the allocator's conventions (page 0 = NULL scratch),
    one block table per row, TopK selection by the real scorer.  Row 0
    is short (fewer valid pages than K: NULL-padded slots, a page that
    straddles the frontier); the last row is a padded batch row."""
    import torch

    from repro_torch.models.sparse_attention import (kv_quant,
                                                     select_pages_blocktable)
    dev = "cuda"
    P = 1 + R * NL
    shape = (n_layers, P, page, KV, D)
    kp = kv_quant(torch.randn(shape, generator=gen, device=dev), pool_dtype)
    vp = kv_quant(torch.randn(shape, generator=gen, device=dev), pool_dtype)
    spool = torch.randn((P, KV, D), generator=gen, device=dev)
    bt = torch.stack([torch.randperm(P - 1, generator=gen, device=dev)[:NL]
                      + 1 for _ in range(R)])
    pos = torch.randint(page, NL * page, (R,), generator=gen, device=dev)
    pos[0] = 3 * page + 5
    bt[R - 1] = 0
    pos[R - 1] = 0
    pos = pos.to(torch.int32)
    q = torch.randn((R, KV, G, D), generator=gen, device=dev).to(q_dtype)
    idx, phys = select_pages_blocktable(q, spool, bt, pos // page + 1, K)
    return dict(q=q, kp=kp, vp=vp, idx=idx, phys=phys, pos=pos, page=page)


def decode_bound(c, pool_dtype) -> tuple[float, str, dict]:
    """Least time for this call's work on the card: each input byte read
    once (the pages this data selects, not the pool), each output byte
    written once; flops of the valid tokens only."""
    q, idx, pos, page = c["q"], c["idx"], c["pos"], c["page"]
    r, kv, g, d = q.shape
    tok0 = idx.long() * page
    live = (pos.long()[:, None, None] - tok0 + 1).clamp(0, page)
    n_pages = int((live > 0).sum())
    n_tok = int(live.sum())
    item = c["kp"].element_size()
    nbytes = (2 * q.numel() * q.element_size()           # q in, out
              + 2 * idx.numel() * 4 + pos.numel() * 4    # phys, idx, pos
              + 2 * n_pages * page * d * item)           # K and V pages
    flops = 4 * g * d * n_tok
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype_name(pool_dtype)] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations"), {
        "bytes": nbytes, "flops": flops, "pages_read": n_pages}


def prefill_bound(q, k, q_offset) -> tuple[float, str, dict]:
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    need_k = min(sk, q_offset + sq)                  # keys any row sees
    vis = sum(min(sk, q_offset + i + 1) for i in range(sq))
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * b * need_k * kv * d * k.element_size())
    flops = 4 * b * h * d * vis
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype_name(q.dtype)] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations"), {
        "bytes": nbytes, "flops": flops}


def flash_shapes() -> dict:
    """(B, Sq, Sk, H, KV, q_offset) at D=128 of every ``flash_prefill``
    call the serve paths make: a paged prefill chunk at each config's
    heads, each config's single-batch prefill and the single-batch dense
    decode step (one query row at the prompt's end)."""
    sk = -(-(PROMPT + GEN) // 16) * 16
    sb_len = -(-(SB_PROMPT + SB_GEN) // 16) * 16
    return {
        "qwen2-1.5b paged chunk": (1, CHUNK, sk, 12, 2, sk - CHUNK),
        "qwen3-moe paged chunk": (1, CHUNK, sk, 64, 4, sk - CHUNK),
        "qwen2-1.5b single-batch prefill": (SB_BATCH, SB_PROMPT, SB_PROMPT,
                                            12, 2, 0),
        "qwen3-moe single-batch prefill": (MSB_BATCH, MSB_PROMPT, MSB_PROMPT,
                                           64, 4, 0),
        "qwen2-1.5b dense decode": (SB_BATCH, 1, sb_len, 12, 2, SB_PROMPT)}


def flash_rows(gen, tags) -> list:
    """``flash_prefill`` in bfloat16 at the named ``flash_shapes``: the
    kernel against the plain version (1e-2 abs + rel), then its time
    (CUDA events, and the profiler's device time a call) beside the
    bound, the plain version's and that of
    ``scaled_dot_product_attention`` with ``enable_gqa`` and the causal
    (q_offset 0) or offset mask.  Returns one row each; a row that
    disagrees has ``ok`` False."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.models.layers import chunked_attention
    rows = []
    for tag in tags:
        b, sq, sk, h, kv, off = flash_shapes()[tag]
        q = torch.randn((b, sq, h, 128), generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, sk, kv, 128), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        got = flash_prefill(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        err, ok = close_enough(got, chunked_attention(
            q, k, v, q_offset=off, chunk=min(1024, sk)), 1e-2)
        del got
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if off == 0 and sq == sk:
            def sdpa():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        else:
            mask = (torch.arange(sk, device="cuda")[None, :]
                    <= off + torch.arange(sq, device="cuda")[:, None])

            def sdpa():
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True)

        def plain():
            chunked_attention(q, k, v, q_offset=off, chunk=min(1024, sk))
        bound, by, work = prefill_bound(q, k, off)
        p1 = cuda_ms(plain, iters=3, warmup=1)
        k_ms = cuda_ms(lambda: flash_prefill(q, k, v, q_offset=off))
        lib_ms = cuda_ms(sdpa)
        p2 = cuda_ms(plain, iters=3, warmup=1)
        # the kernels' own device time a call (merge pass included), which
        # the events' time exceeds where the host's launch is slower; only
        # if the profiler recorded all 10 launches (late in a long process
        # it was seen to record fewer)
        prof = profile_call(lambda: [flash_prefill(q, k, v, q_offset=off)
                                     for _ in range(10)], FLASH_KERNELS)
        n_main = sum(n for name, n in prof.get("counted_n", {}).items()
                     if name != "flash_merge_kernel")
        dev_ms = (sum(prof["counted_ms"].values()) / 10 if n_main == 10
                  else None)
        row = dict(shape=tag, B=b, Sq=sq, Sk=sk, H=h, KV=kv, q_offset=off,
                   ms=k_ms, device_ms=dev_ms, plain_ms=min(p1, p2),
                   bound_ms=bound, bound_by=by, library_ms=lib_ms, work=work,
                   tflops=work["flops"] / k_ms / 1e9, max_abs_err=err, ok=ok)
        dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        log(f"[flash_prefill] bf16 {tag} B={b} Sq={sq} Sk={sk} H={h} KV={kv}"
            f" D=128 q_offset={off}: max |err| {err:.3e} (tolerance 0.01 "
            f"abs + 0.01 rel) {'ok' if ok else 'FAIL'}; kernel {k_ms:.4f} "
            f"ms = {row['tflops']:.1f} TFLOP/s of causal work (device time "
            f"{dev} a call), plain {row['plain_ms']:.4f} ms, bound "
            f"{bound:.5f} ms ({by}: {work}), library "
            f"scaled_dot_product_attention {lib_ms:.4f} ms")
        record.setdefault("flash_prefill_rows", []).append(row)
        rows.append(row)
        del q, k, v, qt, kt, vt
        free_cuda()
    return rows


def phase_kernels() -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_decode_attn import paged_decode_attn
    from repro_torch.models.layers import chunked_attention
    from repro_torch.models.sparse_attention import attend_pages_paged
    gen = torch.Generator(device="cuda").manual_seed(1)
    bad = []
    # paged decode: R=8, KV=2, G=6, D=128, page=16, K=64
    for pool_dt, q_dt, tol in ((torch.bfloat16, torch.bfloat16, 1e-2),
                               (torch.int8, torch.bfloat16, 1e-2),
                               (torch.float32, torch.float32, 1e-5)):
        c = decode_case(gen, pool_dt, q_dt)
        args = (c["phys"], c["idx"], c["pos"], c["q"], c["kp"][0],
                c["vp"][0])
        got = paged_decode_attn(*args, page_size=c["page"]).float()
        torch.cuda.synchronize()
        want = attend_pages_paged(c["q"], c["kp"][0], c["vp"][0], c["idx"],
                                  c["phys"], c["pos"], c["page"]).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and bool(
            ((got - want).abs() <= tol + tol * want.abs()).all())
        log(f"[paged_decode_attn] pool {dtype_name(pool_dt)}: max |err| "
            f"{err:.3e} (tolerance {tol:g} abs + {tol:g} rel) "
            f"{'ok' if ok else 'FAIL'}")
        record.setdefault("decode_checks", []).append(
            {"pool": dtype_name(pool_dt), "max_abs_err": err, "tol": tol,
             "ok": ok})
        if not ok:
            bad.append(f"paged_decode_attn {dtype_name(pool_dt)}")
        log_bitwise("paged_decode_attn", f"pool {dtype_name(pool_dt)}",
                    *bitwise_checks(paged_call(c), N_REQ), bad)
    # gemma-7b's heads: 16 KV heads, G=1, head_dim 256
    for pool_dt in (torch.bfloat16, torch.int8):
        c = decode_case(gen, pool_dt, torch.bfloat16, KV=16, G=1, D=256)
        got = paged_decode_attn(c["phys"], c["idx"], c["pos"], c["q"],
                                c["kp"][0], c["vp"][0], page_size=c["page"])
        torch.cuda.synchronize()
        err, ok = close_enough(got, attend_pages_paged(
            c["q"], c["kp"][0], c["vp"][0], c["idx"], c["phys"], c["pos"],
            c["page"]), 1e-2)
        log(f"[paged_decode_attn] gemma-7b heads KV=16 G=1 D=256 pool "
            f"{dtype_name(pool_dt)}: max |err| {err:.3e} (tolerance 0.01 "
            f"abs + 0.01 rel) {'ok' if ok else 'FAIL'}")
        record.setdefault("decode_checks", []).append(
            {"pool": dtype_name(pool_dt), "heads": "gemma-7b",
             "max_abs_err": err, "tol": 1e-2, "ok": ok})
        if not ok:
            bad.append(f"paged_decode_attn D=256 {dtype_name(pool_dt)}")
        log_bitwise("paged_decode_attn", f"D=256 pool {dtype_name(pool_dt)}",
                    *bitwise_checks(paged_call(c), N_REQ), bad)
        del c, got
    # timing at the main path's bf16 pools, rotating over 8 layers of
    # pool (~100 MB)
    row = decode_rows(gen, ["paged qwen2-1.5b"])[0]
    record["paged_decode_attn"] = dict(
        row, max_abs_err=record["decode_checks"][0]["max_abs_err"])
    if not row["ok"]:
        bad.append("paged_decode_attn timed row")

    # flash prefill: B=1, Sq=chunk, Sk=max_len, H=12, KV=2, D=128
    sk = -(-(PROMPT + GEN) // 16) * 16
    for q_dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 2e-5)):
        for off in (sk - CHUNK, 0):
            q = torch.randn((1, CHUNK, 12, 128), generator=gen,
                            device="cuda").to(q_dt)
            k = torch.randn((1, sk, 2, 128), generator=gen,
                            device="cuda").to(q_dt)
            v = torch.randn((1, sk, 2, 128), generator=gen,
                            device="cuda").to(q_dt)
            got = flash_prefill(q, k, v, q_offset=off).float()
            torch.cuda.synchronize()
            want = chunked_attention(q, k, v, q_offset=off,
                                     chunk=min(1024, sk)).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.isfinite(got).all()) and bool(
                ((got - want).abs() <= tol + tol * want.abs()).all())
            log(f"[flash_prefill] {dtype_name(q_dt)} q_offset={off}: max "
                f"|err| {err:.3e} (tolerance {tol:g} abs + {tol:g} rel) "
                f"{'ok' if ok else 'FAIL'}")
            record.setdefault("prefill_checks", []).append(
                {"dtype": dtype_name(q_dt), "q_offset": off,
                 "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                bad.append(f"flash_prefill {dtype_name(q_dt)} {off}")
            if q_dt == torch.bfloat16 and off > 0:
                main = (q, k, v, off, err)
    q, k, v, off, err = main
    mask = (torch.arange(sk, device="cuda")[None, :]
            <= off + torch.arange(CHUNK, device="cuda")[:, None])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound, by, work = prefill_bound(q, k, off)
    plain_ms = cuda_ms(lambda: chunked_attention(q, k, v, q_offset=off,
                                                 chunk=min(1024, sk)))
    k_ms = cuda_ms(lambda: flash_prefill(q, k, v, q_offset=off))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    plain_ms2 = cuda_ms(lambda: chunked_attention(q, k, v, q_offset=off,
                                                  chunk=min(1024, sk)))
    record["flash_prefill"] = dict(
        ms=k_ms, plain_ms=min(plain_ms, plain_ms2), bound_ms=bound,
        bound_by=by, library_ms=lib_ms, work=work, max_abs_err=err)
    log(f"[flash_prefill] bf16 B=1 Sq={CHUNK} Sk={sk} H=12 KV=2 D=128 "
        f"q_offset={off}: kernel {k_ms:.4f} ms, plain "
        f"{min(plain_ms, plain_ms2):.4f} ms, bound {bound:.5f} ms ({by}: "
        f"{work}), library scaled_dot_product_attention {lib_ms:.4f} ms")
    if bad:
        raise AssertionError(f"kernel disagrees with plain: {bad}")


# -- phase 4 -------------------------------------------------------------------

def serve_workload(cfg, seed: int = 0) -> list:
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(0.0, rng.integers(1, cfg.vocab, size=int(n)), GEN)
            for n in rng.integers(PROMPT - 100, PROMPT + 1, size=N_REQ)]


def full_engine(cfg, params, **kw):
    from repro_torch.serve.engine import PagedEngine
    max_len = -(-(PROMPT + GEN) // cfg.kv_page) * cfg.kv_page
    kw.setdefault("chunk", CHUNK)
    return PagedEngine(cfg, params, max_len=max_len, max_batch=N_REQ,
                       device="cuda", **kw)


def profile_step(eng, count: tuple = ()) -> dict:
    """Device busy share and top kernels of one ``eng.step()``; with
    ``count``, also the device ms of the kernels whose names hold each
    of those substrings."""
    return profile_call(eng.step, count)


def profile_call(fn, count: tuple = ()) -> dict:
    """``profile_step`` for any call ``fn()``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name, n_by_name = [], {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            s, t = e.time_range.start, e.time_range.end
            spans.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
            n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
    if not spans:
        return {"busy_share": None, "wall_ms": wall_us / 1e3}
    counted = {c: sum(us for n, us in by_name.items() if c in n) / 1e3
               for c in count}
    counted_n = {c: sum(k for n, k in n_by_name.items() if c in n)
                 for c in count}
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, t in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"busy_share": busy / wall_us, "wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3, "n_kernels": len(spans),
            "top": [{"name": n[:90], "ms": us / 1e3} for n, us in top],
            "counted_ms": counted, "counted_n": counted_n}


def drive_serve(eng, work, kernels: dict) -> dict:
    """Serve ``work`` to the end, one timed ``eng.step()`` at a time, and
    profile one decode-only step.  Every kernel's launch count is set to
    0 just before and read just after."""
    import numpy as np
    import torch
    for t, p, g in work:
        eng.submit(p, g, arrival=t)
    torch.cuda.synchronize()
    decode_s, prefill_s, profiled = [], 0.0, None
    for fn in kernels.values():
        fn.launches = 0
    t_run = time.perf_counter()
    while eng.scheduler.has_work:
        sch = eng.scheduler
        decode_only = (not sch.waiting and sch.running
                       and not any(r.in_prefill for r in sch.running))
        if decode_only and profiled is None and len(decode_s) >= 4:
            profiled = profile_step(eng, DECODE_KERNELS)
            continue
        n_it = eng.stats.iterations
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_p, n_d = eng.stats.iter_log[n_it]
        if n_p:
            prefill_s += dt
        elif n_d:
            decode_s.append(dt)
    run_s = time.perf_counter() - t_run
    launches = {name: fn.launches for name, fn in kernels.items()}
    ms = np.asarray(decode_s) * 1e3
    return {"launches": launches, "run_s": run_s, "decode_ms": ms,
            "prefill_s": prefill_s, "profiled": profiled}


def log_profile(tag: str, profiled) -> None:
    if profiled and profiled["busy_share"] is not None:
        log(f"[{tag}] profiled decode step: wall {profiled['wall_ms']:.2f} "
            f"ms, device busy {profiled['device_ms']:.2f} ms = "
            f"{100 * profiled['busy_share']:.1f}% over "
            f"{profiled['n_kernels']} kernels; top by device time:")
        for t in profiled["top"]:
            log(f"[{tag}]   {t['ms']:.3f} ms  {t['name']}")
        ms = {n: profiled["counted_ms"][n] for n in DECODE_KERNELS
              if profiled["counted_n"].get(n)}
        if ms:
            n = sum(profiled["counted_n"][k] for k in ms)
            share = sum(ms.values()) / profiled["device_ms"]
            profiled["decode_attn"] = {"ms": sum(ms.values()),
                                       "launches": n, "share": share}
            log(f"[{tag}] decode attention kernels: "
                + ", ".join(f"{k} {v:.3f} ms ({profiled['counted_n'][k]} "
                            f"launches)" for k, v in ms.items())
                + f" = {100 * share:.1f}% of the step's device time")
    else:
        log(f"[{tag}] device busy share: not measured (the profiler "
            "recorded no device events)")


def profile_prefill(tag: str, eng, tokens) -> dict:
    """One single-batch ``eng.prefill`` under the profiler: its device
    time, and the shares of it in the ``flash_prefill`` kernels and in
    the grouped GEMM's (``grouped_*``, MoE configs)."""
    prof = profile_call(lambda: eng.prefill({"tokens": tokens}),
                        FLASH_KERNELS + ("grouped_",))
    if prof["busy_share"] is None:
        log(f"[{tag}] profiled prefill: not measured (the profiler "
            "recorded no device events)")
        return prof
    gemm_ms = prof["counted_ms"].pop("grouped_")
    gemm_n = prof["counted_n"].pop("grouped_")
    fp = sum(prof["counted_ms"].values())
    prof["flash_prefill_share"] = fp / prof["device_ms"]
    prof["grouped_gemm"] = {"ms": gemm_ms, "launches": gemm_n,
                            "share": gemm_ms / prof["device_ms"]}
    log(f"[{tag}] profiled prefill of {tokens.numel()} tokens: wall "
        f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
        f"over {prof['n_kernels']} kernels; grouped GEMM {gemm_ms:.2f} ms "
        f"({gemm_n} launches, {100 * gemm_ms / prof['device_ms']:.1f}%); "
        f"flash_prefill "
        + ", ".join(f"{n} {ms:.2f} ms ({prof['counted_n'][n]} launches)"
                    for n, ms in prof["counted_ms"].items())
        + f" = {100 * prof['flash_prefill_share']:.1f}% of device time; "
        f"top: " + "; ".join(f"{t['ms']:.2f} ms {t['name'][:60]}"
                             for t in prof["top"][:5]))
    return prof


def phase_serve(state: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.gather_rows import gather_rows
    from repro_torch.kernels.paged_decode_attn import paged_decode_attn
    from repro_torch.params import init_params
    cfg = get_config("qwen2-1.5b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    state.update(cfg=cfg, params=params)
    eng = full_engine(cfg, params, kernel="cuda")
    work = serve_workload(cfg)
    run = drive_serve(eng, work, {"paged_decode_attn": paged_decode_attn,
                                  "flash_prefill": flash_prefill,
                                  "gather_rows": gather_rows})
    launches, run_s, ms = run["launches"], run["run_s"], run["decode_ms"]
    prefill_s, profiled = run["prefill_s"], run["profiled"]
    state["launches"] = launches
    m = eng.metrics()
    st = eng.stats
    L = cfg.n_layers
    done = sum(len(r.out_tokens) == r.max_new_tokens
               for r in eng.requests.values())
    log(f"[serve] qwen2-1.5b full width bf16, kernel=cuda: {done}/{N_REQ} "
        f"requests finished, {m['tokens_out']} tokens, {st.steps} decode "
        f"steps, {st.prefill_calls} prefill chunks, {m['iterations']} "
        f"iterations in {run_s:.2f} s")
    log(f"[serve] decode-only steps: {len(ms)}, ms/step mean "
        f"{ms.mean():.2f} median {np.median(ms):.2f}; prefill "
        f"{st.prefill_tokens} tokens in {prefill_s:.2f} s of iterations "
        f"with prefill = {st.prefill_tokens / prefill_s:.0f} tokens/s")
    log(f"[serve] launches: paged_decode_attn {launches['paged_decode_attn']}"
        f" (decode steps x {L} = {st.steps * L}), flash_prefill "
        f"{launches['flash_prefill']} (prefill chunks x {L} = "
        f"{st.prefill_calls * L}), gather_rows {launches['gather_rows']} "
        f"(decode steps + prefill chunks = {st.steps + st.prefill_calls})")
    per_step = st.pages_touched / max(st.steps, 1)
    why = ("more than the LRU holds, so each step evicts the pages the "
           "next one needs and the LRU thrashes"
           if per_step > eng.hot.capacity else
           "which the LRU can hold, so steps reuse each other's pages")
    log(f"[serve] NSB hit rate {m['nsb_hot_hit_rate']}: each decode step "
        f"touches {per_step:.1f} unique layer-0 pages on average against a "
        f"{eng.hot.capacity}-page LRU, {why}")
    log_profile("serve", profiled)
    record["serve"] = {
        "finished": done, "tokens": m["tokens_out"],
        "decode_steps": st.steps, "prefill_chunks": st.prefill_calls,
        "iterations": m["iterations"], "run_s": run_s,
        "decode_ms_mean": float(ms.mean()),
        "decode_ms_median": float(np.median(ms)),
        "decode_steps_timed": len(ms),
        "prefill_tokens": st.prefill_tokens,
        "prefill_tokens_per_s": st.prefill_tokens / prefill_s,
        "launches": launches, "nsb_hit_rate": m["nsb_hot_hit_rate"],
        "nsb_pages_per_step": per_step, "profile": profiled,
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    assert done == N_REQ, f"{done}/{N_REQ} requests finished"
    assert launches["paged_decode_attn"] == st.steps * L
    assert launches["flash_prefill"] == st.prefill_calls * L
    assert launches["gather_rows"] == st.steps + st.prefill_calls
    assert all(np.isfinite(r.last_logits).all()
               for r in eng.requests.values())
    state["engine"] = eng
    state["work"] = work


# -- phase 5 -------------------------------------------------------------------

def phase_teacher_forced(state: dict) -> None:
    import torch

    from repro_torch.models.sparse_attention import attend_pages_paged
    eng = state["engine"]
    tol = 1e-2
    errs: dict[int, float] = {}
    fails = []

    def probe(li, x):
        want = attend_pages_paged(x["q"], x["k_pool"], x["v_pool"],
                                  x["idx"], x["phys"], x["pos"],
                                  eng.page).float()
        got = x["out"].float()
        diff = (got - want).abs()
        errs[li] = max(errs.get(li, 0.0), float(diff.max()))
        if not bool((diff <= tol + tol * want.abs()).all()):
            fails.append(li)
    eng.attend_probe = probe
    try:
        # the same prompts again: their pages are still in the prefix
        # cache, so prefill is short, then one decode step per request
        eng.run([(eng.now, p, 2) for _, p, _ in state["work"]])
    finally:
        eng.attend_probe = None
    torch.cuda.synchronize()
    log(f"[teacher-forced] bf16 full width: {len(errs)} layers checked, "
        f"max |kernel - plain| per layer "
        f"{[round(errs[i], 5) for i in sorted(errs)]} (tolerance {tol:g} "
        f"abs + {tol:g} rel)")
    record["teacher_forced"] = {"max_abs_err": errs, "tol": tol,
                                "failed_layers": sorted(set(fails))}
    assert len(errs) == state["cfg"].n_layers, "not every layer checked"
    assert not fails, f"layers {sorted(set(fails))} disagree"


# -- phase 6 -------------------------------------------------------------------

def phase_f32_topk(state: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.models.sparse_attention import page_scores
    cfg = replace(state["cfg"], param_dtype="float32")
    params = _map(state["params"], lambda t: t.float())
    max_len = -(-(PROMPT + GEN) // cfg.kv_page) * cfg.kv_page
    runs = {}
    for kernel in ("cuda", "torch"):
        sel: dict = {}

        def probe(li, x, sel=sel):
            kp = x["s_pool"][x["bt"]]
            s = page_scores(x["q"], kp)
            nl = s.shape[-1]
            valid = (torch.arange(nl, device=s.device)[None, None]
                     < x["n_valid"][:, None, None])
            sel[li] = (x["phys"].cpu().numpy(),
                       torch.where(valid, s, float("-inf")).cpu().numpy(),
                       x["bt"].cpu().numpy())
        # every prompt prefills in one chunk, so all rows decode together
        eng = full_engine(cfg, params, kernel=kernel, chunk=max_len,
                          token_budget=N_REQ * max_len + N_REQ)
        eng.attend_probe = probe
        eng.run([(0.0, p, 2) for _, p, _ in state["work"]])
        runs[kernel] = (eng, sel)
    (ec, sc), (et, stc) = runs["cuda"], runs["torch"]
    assert ec.stats.steps == et.stats.steps == 1
    k = min(cfg.kv_topk_pages, ec.n_logical)
    worst_gap, n_diff = 0.0, 0
    for li in range(cfg.n_layers):
        pc, s_c, bt = sc[li]
        pt, s_t, _ = stc[li]
        for r in range(pc.shape[0]):
            for h in range(pc.shape[1]):
                a, b = set(pc[r, h].tolist()), set(pt[r, h].tolist())
                if a == b:
                    continue
                n_diff += 1
                # logical ids of the pages only one route chose, scored by
                # each route: each must sit at that route's K-th boundary
                lids = [int(np.nonzero(bt[r] == p)[0][0]) for p in a ^ b]
                for s in (s_c[r, h], s_t[r, h]):
                    srt = np.sort(s)[::-1]
                    edge = 0.5 * (srt[k - 1] + srt[k])
                    scale = max(abs(srt[k - 1]), 1e-30)
                    gap = max(abs(s[j] - edge) for j in lids) / scale
                    worst_gap = max(worst_gap, float(gap))
                    log(f"[f32 topk] layer {li} row {r} head {h}: "
                        f"selection differs, relative gap to the K-th "
                        f"boundary {gap:.3e}")
    lc = np.stack([ec.requests[i].last_logits for i in sorted(ec.requests)])
    lt = np.stack([et.requests[i].last_logits for i in sorted(et.requests)])
    rel = float(np.linalg.norm(lc - lt) / np.linalg.norm(lt))
    same_tok = all(ec.requests[i].out_tokens == et.requests[i].out_tokens
                   for i in ec.requests)
    log(f"[f32 topk] full width f32, first decode step: {n_diff} of "
        f"{cfg.n_layers * pc.shape[0] * pc.shape[1]} (layer, row, head) "
        f"selections differ (largest relative gap {worst_gap:.3e}, limit "
        f"1e-5); logits relative L2 {rel:.3e} (limit 1e-4); tokens equal: "
        f"{same_tok}")
    record["f32_topk"] = {"n_differ": n_diff, "worst_gap": worst_gap,
                          "logits_rel_l2": rel, "tokens_equal": same_tok}
    assert worst_gap <= 1e-5, "a TopK difference is not a score tie"
    assert rel <= 1e-4, f"logits relative L2 {rel:.3e} > 1e-4"
    assert same_tok, "tokens differ"
    del runs, params
    torch.cuda.empty_cache()


# -- phase 7 -------------------------------------------------------------------

def phase_reduced_cpu(arch: str = "qwen2-1.5b", key: str = "reduced_cpu",
                      **engine_kw) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serve.engine import PagedEngine
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    sys_prompts = [rng.integers(1, cfg.vocab, size=12) for _ in range(2)]
    work = [(0.5 * i, np.concatenate(
        [sys_prompts[i % 2],
         rng.integers(1, cfg.vocab, size=int(rng.integers(2, 20)))]), 8)
        for i in range(8)]
    engines = {}
    for dev in ("cuda", "cpu"):
        eng = PagedEngine(cfg, params, max_len=48, max_batch=4, chunk=8,
                          nsb_pages=32, device=dev, **engine_kw)
        eng.run([(t, p.copy(), g) for t, p, g in work])
        engines[dev] = eng
    worst = 0.0
    same = True
    for rid, a in engines["cuda"].requests.items():
        b = engines["cpu"].requests[rid]
        same &= a.out_tokens == b.out_tokens
        worst = max(worst, float(np.max(np.abs(a.last_logits - b.last_logits)
                                        / (1 + np.abs(b.last_logits)))))
    opts = "".join(f", {k}={v}" for k, v in engine_kw.items())
    log(f"[reduced] {arch} reduced f32{opts}, card (kernels) vs CPU "
        f"(plain): tokens equal {same}, max |logit diff| / (1 + |logit|) "
        f"{worst:.3e} (limit 1e-4)")
    record[key] = {"tokens_equal": same, "max_rel_err": worst}
    assert same, "tokens differ between card and CPU"
    assert worst <= 1e-4


# -- MoE phases: qwen3-moe-235b-a22b ------------------------------------------

def moe_config(n_layers: int = MOE_LAYERS, dtype: str = "bfloat16"):
    from repro_torch.configs import get_config
    return replace(get_config(MOE_ARCH), n_layers=n_layers,
                   param_dtype=dtype)


def moe_case(gen, dtype, R=N_REQ, K=8, E=128, TF=32, D=4096, F=1536):
    """One layer's expert pool in the engine's layout (page 0 = zeros,
    page 1 + ((e*3 + plane)*NT + t)) with weights of std D**-0.5, and
    one decode step's routing drawn from ``gen``: each row routes to K
    distinct experts."""
    import torch
    nt = F // TF
    n_pages = 1 + E * 3 * nt
    pool = torch.empty((n_pages, TF, D), dtype=dtype, device="cuda")
    for a in range(0, n_pages, 2048):
        b = min(n_pages, a + 2048)
        pool[a:b] = torch.randn((b - a, TF, D), generator=gen,
                                device="cuda") * D ** -0.5
    pool[0] = 0
    eids = torch.stack([torch.randperm(E, generator=gen, device="cuda")[:K]
                        for _ in range(R)])                    # [R,K]
    t = torch.arange(nt, device="cuda")

    def pids(plane):
        return (1 + (eids[..., None] * 3 + plane) * nt + t).to(
            torch.int32).contiguous()
    x = torch.randn((R, D), generator=gen, device="cuda").to(dtype)
    h = torch.randn((R, K, F), generator=gen, device="cuda").to(dtype)
    return dict(pool=pool, gate=pids(0), down=pids(2), x=x, h=h, eids=eids)


def moe_bound(pids, a, pool, out_numel) -> tuple[float, str, dict]:
    """Least time of one call on this data: the unique pages it reads,
    x or h, the page ids and the output, each moved once; two flops per
    weight of every routed (row, expert) pair."""
    import torch
    r, k, nt = pids.shape
    _, tf, d = pool.shape
    n_pages = int(torch.unique(pids).numel())
    item = pool.element_size()
    nbytes = (n_pages * tf * d * item + a.numel() * a.element_size()
              + pids.numel() * 4 + out_numel * a.element_size())
    flops = 2 * r * k * nt * tf * d
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype_name(a.dtype)] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations"), {
        "bytes": nbytes, "flops": flops, "pages_read": n_pages}


def close_enough(got, want, tol) -> tuple[float, bool]:
    import torch
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= tol + tol * want.abs()).all())
    return err, ok


def phase_moe_kernels() -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.moe_dispatch import (moe_paged_down,
                                                  moe_paged_down_plain,
                                                  moe_paged_gateup,
                                                  moe_paged_gateup_plain)
    from repro_torch.kernels.paged_decode_attn import paged_decode_attn
    from repro_torch.models.layers import chunked_attention
    from repro_torch.models.sparse_attention import attend_pages_paged
    gen = torch.Generator(device="cuda").manual_seed(2)
    bad = []
    shape = "R=8 K=8 E=128 tile=32 D=4096 NT=48"
    for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        c = moe_case(gen, dt)
        pool, x, h = c["pool"], c["x"], c["h"]
        g_args, d_args = (c["gate"], x, pool), (c["down"], h, pool)
        g = moe_paged_gateup(*g_args)
        y = moe_paged_down(*d_args)
        torch.cuda.synchronize()
        errs = {}
        for name, got, want in (
                ("moe_paged_gateup", g, moe_paged_gateup_plain(*g_args)),
                ("moe_paged_down", y, moe_paged_down_plain(*d_args))):
            err, ok = close_enough(got, want, tol)
            errs[name] = err
            log(f"[{name}] {dtype_name(dt)} {shape}: max |err| {err:.3e} "
                f"(tolerance {tol:g} abs + {tol:g} rel) "
                f"{'ok' if ok else 'FAIL'}")
            record.setdefault("moe_checks", []).append(
                {"kernel": name, "dtype": dtype_name(dt), "max_abs_err": err,
                 "tol": tol, "ok": ok})
            if not ok:
                bad.append(f"{name} {dtype_name(dt)}")
        # the yardstick: one batched product over weights gathered
        # beforehand (the gather itself is left out of its time)
        r, k, nt = c["gate"].shape
        wg = pool[c["gate"].long()].reshape(r * k, -1, pool.shape[-1])
        wd = pool[c["down"].long()].reshape(r * k, -1, pool.shape[-1])
        xk = x[:, None, :, None].expand(r, k, -1, 1).reshape(r * k, -1, 1)
        hk = h.reshape(r * k, 1, -1)
        timed = (
            ("moe_paged_gateup", g_args, moe_paged_gateup,
             moe_paged_gateup_plain, lambda: torch.bmm(wg, xk), g.numel()),
            ("moe_paged_down", d_args, moe_paged_down, moe_paged_down_plain,
             lambda: torch.bmm(hk, wd), y.numel()))
        for name, args, kern, plain, bmm, n_out in timed:
            bound, by, work = moe_bound(args[0], args[1], pool, n_out)
            plain_ms = cuda_ms(lambda: plain(*args), iters=10)
            k_ms = cuda_ms(lambda: kern(*args))
            bmm_ms = cuda_ms(bmm)
            plain_ms2 = cuda_ms(lambda: plain(*args), iters=10)
            row = dict(ms=k_ms, plain_ms=min(plain_ms, plain_ms2),
                       bound_ms=bound, bound_by=by, library_ms=None,
                       bmm_pregathered_ms=bmm_ms, work=work,
                       max_abs_err=errs[name], dtype=dtype_name(dt))
            record.setdefault(name + "_runs", []).append(row)
            if dt == torch.bfloat16:
                record[name] = row
            log(f"[{name}] {dtype_name(dt)} {shape}: kernel {k_ms:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, bound {bound:.5f} ms "
                f"({by}: {work}); library: none (no single PyTorch call "
                f"gathers pages through a page table); yardstick "
                f"torch.bmm over weights gathered beforehand, gather "
                f"excluded: {bmm_ms:.4f} ms")
        del c, pool, wg, wd, g_args, d_args, timed
        torch.cuda.empty_cache()

    # the attention kernels again at qwen3-moe's head shapes
    for pool_dt, q_dt, tol in ((torch.bfloat16, torch.bfloat16, 1e-2),
                               (torch.int8, torch.bfloat16, 1e-2),
                               (torch.float32, torch.float32, 1e-5)):
        c = decode_case(gen, pool_dt, q_dt, KV=4, G=16)
        args = (c["phys"], c["idx"], c["pos"], c["q"], c["kp"][0],
                c["vp"][0])
        got = paged_decode_attn(*args, page_size=c["page"])
        torch.cuda.synchronize()
        want = attend_pages_paged(c["q"], c["kp"][0], c["vp"][0], c["idx"],
                                  c["phys"], c["pos"], c["page"])
        err, ok = close_enough(got, want, tol)
        log(f"[paged_decode_attn] qwen3-moe KV=4 G=16 pool "
            f"{dtype_name(pool_dt)}: max |err| {err:.3e} (tolerance {tol:g} "
            f"abs + {tol:g} rel) {'ok' if ok else 'FAIL'}")
        record.setdefault("moe_attn_checks", []).append(
            {"kernel": "paged_decode_attn", "dtype": dtype_name(pool_dt),
             "max_abs_err": err, "ok": ok})
        if not ok:
            bad.append(f"paged_decode_attn qwen3 {dtype_name(pool_dt)}")
        log_bitwise("paged_decode_attn",
                    f"qwen3-moe heads pool {dtype_name(pool_dt)}",
                    *bitwise_checks(paged_call(c), N_REQ), bad)
    row = decode_rows(gen, ["paged qwen3-moe"])[0]
    record["paged_decode_attn_qwen3"] = row
    if not row["ok"]:
        bad.append("paged_decode_attn qwen3 timed row")
    sk = -(-(PROMPT + GEN) // 16) * 16
    off = sk - CHUNK
    for q_dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 2e-5)):
        q = torch.randn((1, CHUNK, 64, 128), generator=gen,
                        device="cuda").to(q_dt)
        k = torch.randn((1, sk, 4, 128), generator=gen, device="cuda").to(q_dt)
        v = torch.randn((1, sk, 4, 128), generator=gen, device="cuda").to(q_dt)
        got = flash_prefill(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        want = chunked_attention(q, k, v, q_offset=off, chunk=min(1024, sk))
        err, ok = close_enough(got, want, tol)
        log(f"[flash_prefill] qwen3-moe H=64 KV=4 {dtype_name(q_dt)} "
            f"q_offset={off}: max |err| {err:.3e} (tolerance {tol:g} abs + "
            f"{tol:g} rel) {'ok' if ok else 'FAIL'}")
        record.setdefault("moe_attn_checks", []).append(
            {"kernel": "flash_prefill", "dtype": dtype_name(q_dt),
             "max_abs_err": err, "ok": ok})
        if not ok:
            bad.append(f"flash_prefill qwen3 {dtype_name(q_dt)}")
        if q_dt == torch.bfloat16:
            main = (q, k, v)
    q, k, v = main
    mask = (torch.arange(sk, device="cuda")[None, :]
            <= off + torch.arange(CHUNK, device="cuda")[:, None])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound, by, work = prefill_bound(q, k, off)
    p1 = cuda_ms(lambda: chunked_attention(q, k, v, q_offset=off,
                                           chunk=min(1024, sk)))
    k_ms = cuda_ms(lambda: flash_prefill(q, k, v, q_offset=off))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    p2 = cuda_ms(lambda: chunked_attention(q, k, v, q_offset=off,
                                           chunk=min(1024, sk)))
    record["flash_prefill_qwen3"] = dict(
        ms=k_ms, plain_ms=min(p1, p2), bound_ms=bound, bound_by=by,
        library_ms=lib_ms, work=work)
    log(f"[flash_prefill] qwen3-moe bf16 B=1 Sq={CHUNK} Sk={sk} H=64 KV=4 "
        f"D=128 q_offset={off}: kernel {k_ms:.4f} ms, plain "
        f"{min(p1, p2):.4f} ms, bound {bound:.5f} ms ({by}: {work}), "
        f"library scaled_dot_product_attention {lib_ms:.4f} ms")
    if bad:
        raise AssertionError(f"kernel disagrees with plain: {bad}")


def moe_kernels() -> dict:
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.gather_rows import gather_rows
    from repro_torch.kernels.moe_dispatch import (moe_dispatch_matmul,
                                                  moe_paged_down,
                                                  moe_paged_gateup)
    from repro_torch.kernels.paged_decode_attn import paged_decode_attn
    return {"paged_decode_attn": paged_decode_attn,
            "flash_prefill": flash_prefill,
            "moe_paged_gateup": moe_paged_gateup,
            "moe_paged_down": moe_paged_down,
            "moe_dispatch_matmul": moe_dispatch_matmul,
            "gather_rows": gather_rows}


def phase_moe_serve(state: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.params import init_params
    cfg = moe_config()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    eng = full_engine(cfg, params, kernel="cuda", expert_pool="paged")
    ptr = params["layers"]["we_down"].untyped_storage().data_ptr()
    one_copy = (eng.ep.pool.untyped_storage().data_ptr() == ptr
                and eng.params["layers"]["we_down"].untyped_storage()
                .data_ptr() == ptr)
    account_s = []
    account = eng._account_expert_pages

    def timed_account(es, occ):
        t = time.perf_counter()
        account(es, occ)
        account_s.append(time.perf_counter() - t)
    eng._account_expert_pages = timed_account
    work = serve_workload(cfg)
    run = drive_serve(eng, work, moe_kernels())
    launches, ms = run["launches"], run["decode_ms"]
    state["moe_launches"] = launches
    m = eng.metrics()
    st = eng.stats
    L = cfg.n_layers
    done = sum(len(r.out_tokens) == r.max_new_tokens
               for r in eng.requests.values())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[moe serve] {MOE_ARCH} full width, {L} layers, bf16, "
        f"expert_pool=paged, kernel=cuda: weights {weights_gib:.2f} GiB made "
        f"in {init_s:.1f} s, expert pool {m['expert_pool_mib'] / 1024:.2f} "
        f"GiB as a view of the weights: {one_copy}")
    log(f"[moe serve] {done}/{N_REQ} requests finished, {m['tokens_out']} "
        f"tokens, {st.steps} decode steps, {st.prefill_calls} prefill "
        f"chunks, {m['iterations']} iterations in {run['run_s']:.2f} s")
    log(f"[moe serve] decode-only steps: {len(ms)}, ms/step mean "
        f"{ms.mean():.2f} median {np.median(ms):.2f}; prefill "
        f"{st.prefill_tokens} tokens in {run['prefill_s']:.2f} s of "
        f"iterations with prefill = "
        f"{st.prefill_tokens / run['prefill_s']:.0f} tokens/s")
    log(f"[moe serve] launches: moe_paged_gateup "
        f"{launches['moe_paged_gateup']} (decode steps x 2 x {L} = "
        f"{st.steps * 2 * L}), moe_paged_down {launches['moe_paged_down']} "
        f"({st.steps * L}), paged_decode_attn "
        f"{launches['paged_decode_attn']} ({st.steps * L}), flash_prefill "
        f"{launches['flash_prefill']} (prefill chunks x {L} = "
        f"{st.prefill_calls * L}), moe_dispatch_matmul "
        f"{launches['moe_dispatch_matmul']} (prefill chunks x 3 x {L} = "
        f"{st.prefill_calls * 3 * L}), gather_rows {launches['gather_rows']} "
        f"({st.steps + st.prefill_calls})")
    acc = np.asarray(account_s) * 1e3
    log(f"[moe serve] expert pages: {st.expert_pages_touched} unique-per-"
        f"step touches ({st.expert_pages_touched / max(st.steps, 1):.0f} a "
        f"step), hit rate {m['expert_nsb_hit_rate']} (demand-LRU of "
        f"{eng.ep_hot.capacity} pages: {m['expert_demand_lru_hit_rate']}); "
        f"_account_expert_pages host time {acc.mean():.2f} ms/step mean, "
        f"{acc.max():.2f} max")
    log(f"[moe serve] peak device memory {peak:.2f} GiB (set-up included)")
    log_profile("moe serve", run["profiled"])
    record["moe_serve"] = {
        "layers": L, "finished": done, "tokens": m["tokens_out"],
        "decode_steps": st.steps, "prefill_chunks": st.prefill_calls,
        "iterations": m["iterations"], "run_s": run["run_s"],
        "init_s": init_s, "weights_gib": weights_gib,
        "decode_ms_mean": float(ms.mean()),
        "decode_ms_median": float(np.median(ms)),
        "decode_steps_timed": len(ms),
        "prefill_tokens": st.prefill_tokens,
        "prefill_tokens_per_s": st.prefill_tokens / run["prefill_s"],
        "launches": launches,
        "expert_pages_touched": st.expert_pages_touched,
        "expert_hit_rate": m["expert_nsb_hit_rate"],
        "expert_demand_lru_hit_rate": m["expert_demand_lru_hit_rate"],
        "account_ms_mean": float(acc.mean()),
        "account_ms_max": float(acc.max()),
        "nsb_hit_rate": m["nsb_hot_hit_rate"], "profile": run["profiled"],
        "max_memory_gib": peak, "pool_is_weights_view": one_copy}
    assert one_copy, "the expert pool is not a view of the weights"
    assert done == N_REQ, f"{done}/{N_REQ} requests finished"
    assert launches["moe_paged_gateup"] == 2 * st.steps * L
    assert launches["moe_paged_down"] == st.steps * L
    assert launches["paged_decode_attn"] == st.steps * L
    assert launches["flash_prefill"] == st.prefill_calls * L
    assert launches["moe_dispatch_matmul"] == 3 * st.prefill_calls * L
    assert launches["gather_rows"] == st.steps + st.prefill_calls
    assert all(np.isfinite(r.last_logits).all()
               for r in eng.requests.values())
    assert peak < 80
    state["moe_engine"] = eng
    state["moe_work"] = work
    moe_chunk_cost(eng, cfg)


# device kernels that run the expert products: the grouped GEMM, and the
# cuBLAS GEMMs of torch.matmul on an H100 (nvjet, sm90_xmma, cutlass)
GEMM_NAMES = ("grouped_", "nvjet", "gemm", "cutlass")


def moe_chunk_cost(eng, cfg) -> None:
    """The grouped GEMM's cost per prefill chunk: one fresh CHUNK-token
    prompt profiled through the kernel, then through ``torch.matmul``
    (``moe_ffn``'s "torch" route for the expert products only), twice
    each, alternating; the second of each is kept."""
    import numpy as np

    from repro_torch.models import moe
    products = moe._expert_products
    rng = np.random.default_rng(1)
    runs = {}
    try:
        for route in ("cuda", "torch", "cuda", "torch"):
            moe._expert_products = products if route == "cuda" else (
                lambda xe, p, kernel: products(xe, p, "torch"))
            eng.submit(rng.integers(1, cfg.vocab, size=CHUNK), 1,
                       arrival=eng.now)
            n_chunks = eng.stats.prefill_calls
            runs[route] = profile_step(eng, GEMM_NAMES)
            assert eng.stats.prefill_calls == n_chunks + 1
            while eng.scheduler.has_work:
                eng.step()
    finally:
        moe._expert_products = products
    k, t = runs["cuda"], runs["torch"]
    if k["busy_share"] is None or t["busy_share"] is None:
        log("[moe chunk cost] not measured (the profiler recorded no "
            "device events)")
        record["moe_chunk_cost"] = None
        return
    diff = k["device_ms"] - t["device_ms"]
    n_per_prompt = -(-PROMPT // CHUNK)
    log(f"[moe chunk cost] one {CHUNK}-token prefill chunk, {cfg.n_layers} "
        f"layers: device {k['device_ms']:.2f} ms (wall {k['wall_ms']:.2f}) "
        f"with the grouped GEMM, {t['device_ms']:.2f} ms (wall "
        f"{t['wall_ms']:.2f}) with torch.matmul; GEMM kernels "
        f"{k['counted_ms']} against {t['counted_ms']}; the kernel costs "
        f"{diff:.2f} ms of device time a chunk, {diff * n_per_prompt:.1f} ms "
        f"a {PROMPT}-token prompt ({n_per_prompt} chunks)")
    record["moe_chunk_cost"] = {"kernel": k, "torch_matmul": t,
                                "device_ms_added": diff,
                                "chunks_per_prompt": n_per_prompt}


def phase_moe_teacher_forced(state: dict) -> None:
    import torch

    from repro_torch.kernels.moe_dispatch import (moe_paged_down_plain,
                                                  moe_paged_gateup_plain)
    eng = state["moe_engine"]
    pool = eng.ep.pool
    tol = 1e-2
    errs: dict[int, float] = {}
    fails = []

    def probe(li, p):
        pids = p["pids"]
        checks = (
            (p["g"], moe_paged_gateup_plain(pids[:, :, 0].contiguous(),
                                            p["x"], pool)),
            (p["u"], moe_paged_gateup_plain(pids[:, :, 1].contiguous(),
                                            p["x"], pool)),
            (p["y"], moe_paged_down_plain(pids[:, :, 2].contiguous(),
                                          p["h"], pool)))
        for got, want in checks:
            err, ok = close_enough(got, want, tol)
            errs[li] = max(errs.get(li, 0.0), err)
            if not ok:
                fails.append(li)
    eng.moe_probe = probe
    try:
        eng.run([(eng.now, p, 2) for _, p, _ in state["moe_work"]])
    finally:
        eng.moe_probe = None
    torch.cuda.synchronize()
    log(f"[moe teacher-forced] bf16 full width: {len(errs)} layers checked "
        f"(gate, up and down of every decode step), max |kernel - plain| "
        f"per layer {[round(errs[i], 5) for i in sorted(errs)]} (tolerance "
        f"{tol:g} abs + {tol:g} rel)")
    record["moe_teacher_forced"] = {"max_abs_err": errs, "tol": tol,
                                    "failed_layers": sorted(set(fails))}
    assert len(errs) == eng.cfg.n_layers, "not every layer checked"
    assert not fails, f"layers {sorted(set(fails))} disagree"


def phase_moe_f32(state: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.moe_dispatch import moe_dispatch_matmul
    from repro_torch.params import init_params
    cfg = moe_config(n_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         "cuda")
    max_len = -(-(PROMPT + GEN) // cfg.kv_page) * cfg.kv_page
    runs, grouped = {}, {}
    for name, kernel, mode in (("cuda", "cuda", "paged"),
                               ("torch", "torch", "paged"),
                               ("dense", "torch", "dense")):
        eng = full_engine(cfg, params, kernel=kernel, expert_pool=mode,
                          chunk=max_len, token_budget=N_REQ * max_len + N_REQ)
        esel = []
        commit = eng._commit_decode

        def keep(pairs, logits, sel, rb, es=None, esel=esel, commit=commit):
            esel.append((es.cpu().numpy()[:, [s for s, _ in pairs]]))
            return commit(pairs, logits, sel, rb, es)
        eng._commit_decode = keep
        # every prompt prefills in one chunk, so all rows decode together
        n = moe_dispatch_matmul.launches
        eng.run([(0.0, p, 2) for _, p, _ in state["moe_work"]])
        grouped[name] = (moe_dispatch_matmul.launches - n,
                         3 * cfg.n_layers * eng.stats.prefill_calls)
        assert eng.stats.steps == 1
        logits = np.stack([eng.requests[i].last_logits
                           for i in sorted(eng.requests)])
        toks = [eng.requests[i].out_tokens for i in sorted(eng.requests)]
        runs[name] = (esel[0], logits, toks)
        del eng
        torch.cuda.empty_cache()
    (ec, lc, tc), (et, lt, tt), (ed, ld, td) = (runs[k] for k in
                                                ("cuda", "torch", "dense"))
    n_diff = int((np.sort(ec, -1) != np.sort(et, -1)).any(-1).sum())
    rel = float(np.linalg.norm(lc - lt) / np.linalg.norm(lt))
    bitwise = bool(np.array_equal(ld, lt) and td == tt
                   and np.array_equal(ed, et))
    n_sets = ec.shape[0] * ec.shape[1]
    log(f"[moe f32] {MOE_ARCH} full width, 2 layers, f32, first decode "
        f"step: kernel=cuda vs kernel=torch: {n_diff} of {n_sets} "
        f"(layer, row) routed expert sets differ, logits "
        f"relative L2 {rel:.3e} (limit 1e-4), tokens equal {tc == tt} "
        f"(prefill grouped GEMMs through the kernel: {grouped['cuda'][0]} "
        f"of {grouped['cuda'][1]}); kernel=torch dense vs paged: tokens, "
        f"logits and routed ids bitwise equal {bitwise}")
    record["moe_f32"] = {"esel_differ": n_diff, "logits_rel_l2": rel,
                         "tokens_equal": tc == tt,
                         "dense_paged_bitwise": bitwise}
    assert grouped["cuda"][0] == grouped["cuda"][1] > 0
    assert grouped["torch"][0] == grouped["dense"][0] == 0
    assert n_diff == 0 and np.array_equal(ec, et), "routed ids differ"
    assert rel <= 1e-4, f"logits relative L2 {rel:.3e} > 1e-4"
    assert tc == tt, "tokens differ"
    assert bitwise, "dense and paged experts are not bitwise equal"
    del params
    torch.cuda.empty_cache()


# -- single-batch phases: the Engine on qwen2-1.5b ---------------------------

def sb_max_len(cfg) -> int:
    return -(-(SB_PROMPT + SB_GEN) // cfg.kv_page) * cfg.kv_page


def sparse_case(gen, kv_dtype, q_dtype, n_layers=1, B=SB_BATCH, KV=2, G=6,
                D=128, page=16, K=64, S=SB_PROMPT + SB_GEN,
                pos=SB_PROMPT + 15):
    """One step of the single-batch decode: ``n_layers`` of a contiguous
    cache with zeros past the frontier ``pos``, and the TopK pages of
    each (row, head) chosen by the real scorer from random summaries."""
    import torch

    from repro_torch.models.sparse_attention import kv_quant, select_pages
    shape = (n_layers, B, S, KV, D)
    k, v = (kv_quant(torch.randn(shape, generator=gen, device="cuda"),
                     kv_dtype) for _ in range(2))
    k[:, :, pos + 1:] = 0
    v[:, :, pos + 1:] = 0
    q = torch.randn((B, KV, G, D), generator=gen, device="cuda").to(q_dtype)
    kpage = torch.randn((B, S // page, KV, D), generator=gen, device="cuda")
    idx = select_pages(q, kpage, pos // page + 1, K)
    return dict(q=q, k=k, v=v, idx=idx, pos=pos, page=page)


def sparse_bound(c) -> tuple[float, str, dict]:
    """Least time of one call: q, out and the ids moved once, and the K
    and V rows of the live tokens (at or before the frontier) of the
    selected pages, each read once; 4 * G * D flops per live token."""
    q, idx, pos, page = c["q"], c["idx"], c["pos"], c["page"]
    b, kv, g, d = q.shape
    tok0 = idx.long() * page
    n_tok = int((pos - tok0 + 1).clamp(0, page).sum())
    item = c["k"].element_size()
    nbytes = (2 * q.numel() * q.element_size() + idx.numel() * 4
              + 2 * n_tok * d * item)
    flops = 4 * g * d * n_tok
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype_name(c["k"].dtype)] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations"), {
        "bytes": nbytes, "flops": flops, "live_tokens": n_tok,
        "pages": int(idx.numel())}


def decode_shapes() -> dict:
    """(kernel, case keywords) of every decode-attention call the serve
    paths make, bfloat16, page 16, K=64: ``paged_decode_attn`` at
    qwen2-1.5b's and qwen3-moe's heads (``decode_case``), and
    ``sparse_decode_attn`` at the single-batch shapes of both
    (``sparse_case``) and at gemma-7b's heads (KV=16, G=1, D=256)."""
    return {
        "paged qwen2-1.5b": ("paged", {}),
        "paged qwen3-moe": ("paged", dict(KV=4, G=16)),
        "single-batch qwen2-1.5b": ("sparse", {}),
        "single-batch qwen3-moe": ("sparse", dict(
            KV=4, G=16, S=MSB_PROMPT + MSB_GEN, pos=MSB_PROMPT + 15)),
        "gemma-7b heads": ("sparse", dict(KV=16, G=1, D=256))}


def decode_rows(gen, tags) -> list:
    """The two decode-attention kernels in bfloat16 at the named
    ``decode_shapes``, over 8 layers of cache: the kernel against its
    plain version on layer 0 (1e-2 abs + rel), then its time (CUDA
    events rotating over the 8 layers, the replay of a CUDA graph of one
    call a layer, the profiler's device time a call and the wrapper's
    host time a call) beside the bound, the plain version's time and that of
    ``scaled_dot_product_attention`` over the selected pages gathered
    beforehand with the frontier as its mask (the gather not counted).
    Returns one row each; a row that disagrees has ``ok`` False."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_decode_attn import paged_decode_attn
    from repro_torch.kernels.sparse_decode_attn import sparse_decode_attn
    from repro_torch.models.sparse_attention import (attend_pages,
                                                     attend_pages_paged,
                                                     gather_pages,
                                                     page_token_positions)
    bf16 = torch.bfloat16
    rows = []
    for tag in tags:
        kind, kw = decode_shapes()[tag]
        if kind == "paged":
            c = decode_case(gen, bf16, bf16, n_layers=8, **kw)
            q, idx, pos, phys, page = (c["q"], c["idx"], c["pos"],
                                       c["phys"], c["page"])

            def kern(li, c=c):
                return paged_decode_attn(c["phys"], c["idx"], c["pos"],
                                         c["q"], c["kp"][li], c["vp"][li],
                                         page_size=c["page"])

            def plain(li, c=c):
                return attend_pages_paged(c["q"], c["kp"][li], c["vp"][li],
                                          c["idx"], c["phys"], c["pos"],
                                          c["page"])
            r, kv, g, d = q.shape
            hi = torch.arange(kv, device="cuda")[None, :, None]
            kgs, vgs = ([t[li].permute(0, 2, 1, 3)[phys.long(), hi].reshape(
                r, kv, -1, d) for li in range(8)] for t in (c["kp"], c["vp"]))
            tok = page_token_positions(idx, page)
            mask = (tok <= pos.long()[:, None, None, None]).reshape(
                r, kv, 1, -1)
            bound, by, work = decode_bound(c, bf16)
            shape = f"R={r} KV={kv} G={g} D={d} page={page} K={idx.shape[2]}"
        else:
            c = sparse_case(gen, bf16, bf16, n_layers=8, **kw)
            q, idx, pos, page = c["q"], c["idx"], c["pos"], c["page"]

            def kern(li, c=c):
                return sparse_decode_attn(c["idx"], c["q"], c["k"][li],
                                          c["v"][li], page_size=c["page"],
                                          pos=c["pos"])

            def plain(li, c=c):
                return attend_pages(c["q"], c["k"][li], c["v"][li],
                                    c["idx"], c["pos"], c["page"])
            b, kv, g, d = q.shape
            kgs, vgs = ([gather_pages(t[li], idx, page).reshape(b, kv, -1, d)
                         for li in range(8)] for t in (c["k"], c["v"]))
            mask = (page_token_positions(idx, page) <= pos).reshape(
                b, kv, 1, -1)
            bound, by, work = sparse_bound(c)
            shape = (f"B={b} KV={kv} G={g} D={d} page={page} "
                     f"K={idx.shape[2]} S={c['k'].shape[2]} pos={pos}")
        got = kern(0)
        torch.cuda.synchronize()
        err, ok = close_enough(got, plain(0), 1e-2)
        del got
        layers = itertools.cycle(range(8))

        def sdpa(q=q, kgs=kgs, vgs=vgs, mask=mask):
            li = next(layers)
            F.scaled_dot_product_attention(q, kgs[li], vgs[li],
                                           attn_mask=mask)
        p1 = cuda_ms(lambda: plain(next(layers)))
        k_ms = cuda_ms(lambda: kern(next(layers)))
        lib_ms = cuda_ms(sdpa)
        p2 = cuda_ms(lambda: plain(next(layers)))
        # the card's time a call without the host: 8 calls, one a layer,
        # captured in a CUDA graph and replayed
        g_ms = graph_ms(lambda: [kern(li) for li in range(8)]) / 8
        # the wrapper's host time a call: 50 calls enqueued, no sync
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for li in range(50):
            kern(li % 8)
        host_ms = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        # the kernels' own device time a call (the merge pass included)
        prof = profile_call(lambda: [kern(li % 8) for li in range(10)],
                            DECODE_KERNELS)
        # (late in a process it was seen to miss the first of the 10: the
        # mean over the calls it recorded, split kernel and merge alike)
        n_main = sum(n for name, n in prof.get("counted_n", {}).items()
                     if name != "decode_merge_kernel")
        dev_ms = (sum(prof["counted_ms"].values()) / n_main if n_main >= 5
                  else None)
        row = dict(shape=tag, kernel=f"{kind}_decode_attn", dims=shape,
                   profiled_ms=prof.get("counted_ms"),
                   ms=k_ms, device_ms=dev_ms, graph_ms=g_ms,
                   profiled_launches=prof.get("counted_n"), host_ms=host_ms,
                   plain_ms=min(p1, p2), bound_ms=bound, bound_by=by,
                   library_ms=lib_ms,
                   library="scaled_dot_product_attention over the pages "
                   "gathered beforehand, gather excluded", work=work,
                   max_abs_err=err, ok=ok)
        dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        log(f"[{row['kernel']}] bf16 {tag} {shape}: max |err| {err:.3e} "
            f"(tolerance 0.01 abs + 0.01 rel) {'ok' if ok else 'FAIL'}; "
            f"kernel {k_ms:.4f} ms (CUDA graph {g_ms:.4f} ms a call; "
            f"profiler device time {dev} a call; the wrapper's host time "
            f"{host_ms:.4f} ms a call), plain "
            f"{row['plain_ms']:.4f} ms, bound {bound:.6f} ms ({by}: {work}),"
            f" library scaled_dot_product_attention over pages gathered "
            f"beforehand (gather excluded) {lib_ms:.4f} ms")
        record.setdefault("decode_rows", []).append(row)
        rows.append(row)
        del c, q, kgs, vgs, mask
        free_cuda()
    return rows


def bitwise_checks(call, n_rows: int) -> tuple[bool, bool]:
    """``call(None)`` runs a decode kernel on the whole batch, ``call(r)``
    on row r alone.  Returns (a repeated call is bitwise equal, every row
    alone is bitwise its row of the batch)."""
    import torch
    a, b = call(None), call(None)
    alone = [call(r) for r in range(n_rows)]
    torch.cuda.synchronize()
    return (torch.equal(a, b),
            all(torch.equal(alone[r], a[r:r + 1]) for r in range(n_rows)))


def paged_call(c, li: int = 0):
    """``call`` of ``bitwise_checks`` for a ``decode_case``."""
    from repro_torch.kernels.paged_decode_attn import paged_decode_attn

    def call(r):
        rows = slice(None) if r is None else slice(r, r + 1)
        return paged_decode_attn(
            *(c[n][rows].contiguous() for n in ("phys", "idx", "pos", "q")),
            c["kp"][li], c["vp"][li], page_size=c["page"])
    return call


def sparse_call(c, pos, li: int = 0):
    """``call`` of ``bitwise_checks`` for a ``sparse_case`` (or any
    idx/q/k/v), with the frontier ``pos`` (None: every token counts)."""
    from repro_torch.kernels.sparse_decode_attn import sparse_decode_attn

    def call(r):
        rows = slice(None) if r is None else slice(r, r + 1)
        return sparse_decode_attn(
            c["idx"][rows].contiguous(), c["q"][rows].contiguous(),
            c["k"][li][rows], c["v"][li][rows], page_size=c["page"],
            pos=pos)
    return call


def log_bitwise(kernel: str, what: str, repeat: bool, invariant: bool,
                bad: list) -> None:
    log(f"[{kernel}] {what}: repeated call bitwise equal: {repeat}; each "
        f"row alone bitwise equal to its row in the batch: {invariant}")
    record.setdefault("decode_bitwise", []).append(
        {"kernel": kernel, "case": what, "repeat": repeat,
         "batch_invariant": invariant})
    if not (repeat and invariant):
        bad.append(f"{kernel} {what} bitwise")


def phase_sb_kernels() -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.gather_rows import (gather_rows,
                                                 gather_rows_plain)
    from repro_torch.kernels.sparse_decode_attn import (
        sparse_decode_attn, sparse_decode_attn_plain)
    from repro_torch.models.sparse_attention import attend_pages
    gen = torch.Generator(device="cuda").manual_seed(3)
    bad = []
    for kv_dt, q_dt, tol in ((torch.bfloat16, torch.bfloat16, 1e-2),
                             (torch.int8, torch.bfloat16, 1e-2),
                             (torch.float32, torch.float32, 1e-5)):
        c = sparse_case(gen, kv_dt, q_dt)
        q, k, v, idx, pos = c["q"], c["k"][0], c["v"][0], c["idx"], c["pos"]
        page = c["page"]
        checks = [("pos", sparse_decode_attn(idx, q, k, v, page_size=page,
                                             pos=pos),
                   attend_pages(q, k, v, idx, pos, page))]
        if kv_dt == torch.bfloat16:
            # the TPU kernel's contract: no frontier, repeated ids count
            rep = torch.randint(0, k.shape[1] // page, idx.shape,
                                generator=gen, device="cuda").to(torch.int32)
            checks.append(("no frontier", sparse_decode_attn(
                rep, q, k, v, page_size=page), sparse_decode_attn_plain(
                rep, q, k, v, page_size=page)))
        torch.cuda.synchronize()
        for what, got, want in checks:
            err, ok = close_enough(got, want, tol)
            log(f"[sparse_decode_attn] {dtype_name(kv_dt)} K/V, {what}: max "
                f"|err| {err:.3e} (tolerance {tol:g} abs + {tol:g} rel) "
                f"{'ok' if ok else 'FAIL'}")
            record.setdefault("sparse_checks", []).append(
                {"kv": dtype_name(kv_dt), "case": what, "max_abs_err": err,
                 "tol": tol, "ok": ok})
            if not ok:
                bad.append(f"sparse_decode_attn {dtype_name(kv_dt)} {what}")
        log_bitwise("sparse_decode_attn", f"{dtype_name(kv_dt)} K/V, pos",
                    *bitwise_checks(sparse_call(c, pos), SB_BATCH), bad)
    # gemma-7b's heads (16 KV heads, G=1, head_dim 256): 4 query heads a
    # block, 8 elements a lane; qwen3-moe's (KV=4, G=16) at the
    # single-batch MoE path's cache: 16 query heads split over two blocks
    heads = (("gemma-7b heads B=8 KV=16 G=1 D=256", "D=256",
              dict(KV=16, G=1, D=256)),
             (f"qwen3-moe heads B=8 KV=4 G=16 D=128 S={MSB_PROMPT + MSB_GEN}",
              "KV=4 G=16", dict(KV=4, G=16, S=MSB_PROMPT + MSB_GEN,
                                pos=MSB_PROMPT + 15)))
    for shape_tag, case, kw in heads:
        for kv_dt in (torch.bfloat16, torch.int8):
            c = sparse_case(gen, kv_dt, torch.bfloat16, **kw)
            q, k, v, idx, pos = (c["q"], c["k"][0], c["v"][0], c["idx"],
                                 c["pos"])
            page, tol = c["page"], 1e-2
            for what, got, want in (
                    (f"{case} pos", sparse_decode_attn(
                        idx, q, k, v, page_size=page, pos=pos),
                     attend_pages(q, k, v, idx, pos, page)),
                    (f"{case} no frontier", sparse_decode_attn(
                        idx, q, k, v, page_size=page),
                     sparse_decode_attn_plain(idx, q, k, v,
                                              page_size=page))):
                torch.cuda.synchronize()
                err, ok = close_enough(got, want, tol)
                log(f"[sparse_decode_attn] {shape_tag} {dtype_name(kv_dt)} "
                    f"K/V, {what}: max |err| {err:.3e} (tolerance {tol:g} "
                    f"abs + {tol:g} rel) {'ok' if ok else 'FAIL'}")
                record.setdefault("sparse_checks", []).append(
                    {"kv": dtype_name(kv_dt), "case": what,
                     "max_abs_err": err, "tol": tol, "ok": ok})
                if not ok:
                    bad.append(f"sparse_decode_attn {dtype_name(kv_dt)} "
                               f"{what}")
            for what, at in ((f"{case} pos", pos), (f"{case} no frontier",
                                                    None)):
                log_bitwise("sparse_decode_attn",
                            f"{shape_tag} {dtype_name(kv_dt)} K/V, {what}",
                            *bitwise_checks(sparse_call(c, at), SB_BATCH),
                            bad)
            del c, q, k, v
    # timing at the main path's bf16 cache, rotating over 8 layers
    # (~200 MB)
    row = decode_rows(gen, ["single-batch qwen2-1.5b"])[0]
    record["sparse_decode_attn"] = dict(
        row, max_abs_err=record["sparse_checks"][0]["max_abs_err"])
    if not row["ok"]:
        bad.append("sparse_decode_attn timed row")

    # gather_rows: the embedding lookups of a decode step and the prefill
    cfg = get_config("qwen2-1.5b")
    table = (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                         device="cuda") * 0.02).to(torch.bfloat16)
    for tag, n_rows in (("decode", SB_BATCH),
                        ("prefill", SB_BATCH * SB_PROMPT)):
        # four id sets of the prefill's size (4 x 37.7 MB) outrun the L2
        ids = [torch.randint(0, cfg.vocab, (n_rows,), generator=gen,
                             device="cuda") for _ in range(4)]
        got = gather_rows(ids[0], table)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, gather_rows_plain(ids[0], table)))
        log(f"[gather_rows] {tag} K={n_rows} table [{cfg.vocab}, "
            f"{cfg.d_model}] bf16: bitwise equal to the plain version: "
            f"{same}")
        if not same:
            bad.append(f"gather_rows {tag}")
        it = itertools.cycle(ids)
        nbytes = 2 * n_rows * table.shape[1] * table.element_size() \
            + n_rows * 8
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        p1 = cuda_ms(lambda: gather_rows_plain(next(it), table))
        k_ms = cuda_ms(lambda: gather_rows(next(it), table))
        lib_ms = cuda_ms(lambda: torch.index_select(table, 0, next(it)))
        p2 = cuda_ms(lambda: gather_rows_plain(next(it), table))
        row = dict(ms=k_ms, plain_ms=min(p1, p2), bound_ms=bound,
                   bound_by="bytes", library_ms=lib_ms, max_abs_err=0.0,
                   bitwise=same, rows=n_rows, bytes=nbytes)
        record["gather_rows_" + tag] = row
        log(f"[gather_rows] {tag} K={n_rows}: kernel {k_ms:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {bound:.5f} ms (bytes: "
            f"{nbytes}), library torch.index_select {lib_ms:.4f} ms")
    record["gather_rows"] = record["gather_rows_prefill"]
    # ids outside [0, N): zero rows on the card, as on the CPU
    n = cfg.vocab
    ids = torch.tensor([5, -1, n, n + 7, n - 1], device="cuda")
    got = gather_rows(ids, table)
    torch.cuda.synchronize()
    same = (torch.equal(got, gather_rows_plain(ids, table))
            and not bool(got[1:4].any()))
    log(f"[gather_rows] ids {ids.tolist()} (N = {n}): zero rows for the "
        f"ids outside [0, N), bitwise equal to the plain version: {same}")
    record["gather_rows_out_of_range_equal"] = same
    if not same:
        bad.append("gather_rows out of range")
    del table
    # flash_prefill at the single-batch path's own shapes: its batched
    # prefill and its dense decode step
    bad += [f"flash_prefill {r['shape']}" for r in flash_rows(
        gen, ("qwen2-1.5b single-batch prefill", "qwen2-1.5b dense decode"))
        if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with plain: {bad}")


def sb_kernels() -> dict:
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.gather_rows import gather_rows
    from repro_torch.kernels.sparse_decode_attn import sparse_decode_attn
    return {"sparse_decode_attn": sparse_decode_attn,
            "flash_prefill": flash_prefill, "gather_rows": gather_rows}


def sb_prompts(cfg):
    import torch
    gen = torch.Generator().manual_seed(0)
    return torch.randint(0, cfg.vocab, (SB_BATCH, SB_PROMPT), generator=gen)


def phase_sb_serve(state: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serve.engine import Engine
    cfg = get_config("qwen2-1.5b")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    state.update(sb_cfg=cfg, sb_params=params)
    max_len = sb_max_len(cfg)
    tokens = sb_prompts(cfg)
    kernels = sb_kernels()
    for fn in kernels.values():
        fn.launches = 0
    # sparse: prefill, then SB_GEN - 1 lockstep steps (generate's loop,
    # each step timed; one decode step profiled)
    eng = Engine(cfg, params, max_len=max_len, sparse=True, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = [eng.prefill({"tokens": tokens})]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_s, profiled = [], None
    for i in range(SB_GEN - 1):
        if i == 4:
            profiled = profile_step(eng, DECODE_KERNELS)
            toks.append(eng._last)
            continue
        t0 = time.perf_counter()
        toks.append(eng.step())
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
    out = np.stack([t.cpu().numpy() for t in toks], axis=1)
    sparse_logits = eng.logits
    # dense: a fresh prefill of the same prompts, then a few steps
    dense = Engine(cfg, params, max_len=max_len, sparse=False, device="cuda")
    prefill_prof = profile_prefill("sb serve", dense, tokens)
    dense_s = []
    for _ in range(SB_DENSE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense.step()
        torch.cuda.synchronize()
        dense_s.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in kernels.items()}
    state["sb_launches"] = launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = eng.stats
    L = cfg.n_layers
    ms, dms = np.asarray(decode_s) * 1e3, np.asarray(dense_s) * 1e3
    n_prompt = SB_BATCH * SB_PROMPT
    log(f"[sb serve] qwen2-1.5b full width bf16, single-batch Engine, "
        f"kernel=cuda: batch {SB_BATCH} x {SB_PROMPT} prompt tokens, "
        f"{out.shape[1]} tokens each, max_len {max_len} ({max_len // 16} "
        f"pages, TopK {cfg.kv_topk_pages})")
    log(f"[sb serve] sparse: prefill {n_prompt} tokens in {prefill_s:.3f} s "
        f"= {n_prompt / prefill_s:.0f} tokens/s; decode {len(ms)} timed "
        f"steps, ms/step mean {ms.mean():.2f} median {np.median(ms):.2f}")
    log(f"[sb serve] dense: decode {len(dms)} steps, ms/step mean "
        f"{dms.mean():.2f} median {np.median(dms):.2f}")
    log(f"[sb serve] launches: sparse_decode_attn "
        f"{launches['sparse_decode_attn']} (sparse steps x {L} = "
        f"{st.steps * L}), flash_prefill {launches['flash_prefill']} (2 "
        f"prefills x {L} + dense steps x {L} = "
        f"{(2 + SB_DENSE_STEPS) * L}), gather_rows "
        f"{launches['gather_rows']} (2 prefills + {st.steps} + "
        f"{SB_DENSE_STEPS} steps = {2 + st.steps + SB_DENSE_STEPS})")
    log(f"[sb serve] NSB hit rate {st.hot_hit_rate} ({st.pages_touched} "
        f"layer-0 proxy pages touched, {st.pages_touched / st.steps:.1f} a "
        f"step, against a {eng.hot.capacity}-page LRU); peak device memory "
        f"{peak:.2f} GiB (set-up included)")
    log_profile("sb serve", profiled)
    record["sb_serve"] = {
        "batch": SB_BATCH, "prompt": SB_PROMPT, "gen": SB_GEN,
        "prefill_s": prefill_s, "prefill_tokens_per_s": n_prompt / prefill_s,
        "decode_ms_mean": float(ms.mean()),
        "decode_ms_median": float(np.median(ms)),
        "decode_steps_timed": len(ms),
        "dense_decode_ms_mean": float(dms.mean()),
        "dense_decode_ms_median": float(np.median(dms)),
        "launches": launches, "nsb_hit_rate": st.hot_hit_rate,
        "pages_touched": st.pages_touched, "profile": profiled,
        "prefill_profile": prefill_prof, "max_memory_gib": peak}
    assert out.shape == (SB_BATCH, SB_GEN) and st.steps == SB_GEN - 1
    assert launches["sparse_decode_attn"] == st.steps * L
    assert launches["flash_prefill"] == (2 + SB_DENSE_STEPS) * L
    assert launches["gather_rows"] == 2 + st.steps + SB_DENSE_STEPS
    assert bool(torch.isfinite(sparse_logits).all())
    assert bool(torch.isfinite(dense.logits).all())
    assert ((out >= 0) & (out < cfg.vocab)).all()
    state["sb_engine"] = eng


def phase_sb_teacher_forced(state: dict) -> None:
    import torch

    from repro_torch.models import transformer
    from repro_torch.models.layers import chunked_attention
    from repro_torch.models.sparse_attention import attend_pages
    eng = state["sb_engine"]
    tol = 1e-2
    errs: dict[int, float] = {}
    fails = []

    def probe(li, x):
        want = attend_pages(x["q"], x["k"], x["v"], x["idx"], x["pos"],
                            eng.cfg.kv_page)
        err, ok = close_enough(x["out"], want, tol)
        errs[li] = err
        if not ok:
            fails.append(li)
    eng.attend_probe = probe
    try:
        eng.step()                           # the cache's last position
    finally:
        eng.attend_probe = None
    torch.cuda.synchronize()
    log(f"[sb teacher-forced] bf16 full width, pos {eng.cache['pos'] - 1}: "
        f"{len(errs)} layers checked, max |kernel - plain| per layer "
        f"{[round(errs[i], 5) for i in sorted(errs)]} (tolerance {tol:g} "
        f"abs + {tol:g} rel)")
    record["sb_teacher_forced"] = {"max_abs_err": errs, "tol": tol,
                                   "failed_layers": sorted(set(fails))}
    assert len(errs) == eng.cfg.n_layers, "not every layer checked"
    assert not fails, f"layers {sorted(set(fails))} disagree"

    # flash_prefill in every layer of one batched prefill (B=8, S=1536,
    # H=12, KV=2, q_offset 0): each layer's own q, k, v to the kernel and
    # to the plain version; the layer goes on from the kernel's output
    perrs: dict[int, float] = {}
    pfails = []
    attn = transformer.flash_prefill

    def checked_attn(q, k, v, *, q_offset, causal, chunk, logit_softcap):
        out = attn(q, k, v, q_offset=q_offset, causal=causal, chunk=chunk,
                   logit_softcap=logit_softcap)
        err, ok = close_enough(out, chunked_attention(
            q, k, v, causal=causal, q_offset=q_offset, chunk=chunk,
            logit_softcap=logit_softcap), tol)
        li = len(perrs)
        perrs[li] = err
        if not ok:
            pfails.append(li)
        return out
    transformer.flash_prefill = checked_attn
    try:
        eng.prefill({"tokens": sb_prompts(eng.cfg)})
    finally:
        transformer.flash_prefill = attn
    torch.cuda.synchronize()
    log(f"[sb teacher-forced] flash_prefill bf16 full width (B={SB_BATCH} "
        f"S={SB_PROMPT} H=12 KV=2 q_offset 0): {len(perrs)} layers checked, "
        f"max |kernel - plain| per layer "
        f"{[round(perrs[i], 5) for i in sorted(perrs)]} (tolerance {tol:g} "
        f"abs + {tol:g} rel)")
    record["sb_teacher_forced"]["flash_prefill"] = {
        "max_abs_err": perrs, "failed_layers": pfails}
    assert len(perrs) == eng.cfg.n_layers, "not every layer's prefill checked"
    assert not pfails, f"flash_prefill disagrees in layers {pfails}"


def phase_sb_f32(state: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.models.sparse_attention import page_scores
    from repro_torch.serve.engine import Engine
    cfg = replace(state["sb_cfg"], param_dtype="float32")
    params = _map(state["sb_params"], lambda t: t.float())
    state.pop("sb_params")
    free_cuda()
    tokens = sb_prompts(cfg)
    k = cfg.kv_topk_pages
    runs = {}
    for kernel in ("cuda", "torch"):
        sel: dict = {}

        def probe(li, x, sel=sel):
            s = page_scores(x["q"], x["kpage"])
            n_valid = x["pos"] // cfg.kv_page + 1
            s[..., n_valid:] = float("-inf")
            sel.setdefault(li, []).append(
                (x["idx"].cpu().numpy(), s.cpu().numpy()))
        eng = Engine(cfg, params, max_len=sb_max_len(cfg), sparse=True,
                     kernel=kernel, device="cuda")
        eng.attend_probe = probe
        out = eng.generate({"tokens": tokens}, 3)
        runs[kernel] = (out, eng.logits.cpu().numpy(), sel)
        del eng
        free_cuda()
    (oc, lc, sc), (ot, lt, stc) = runs["cuda"], runs["torch"]
    worst_gap, n_diff, n_sel = 0.0, 0, 0
    for li in sorted(sc):
        for (ic, s_c), (it, s_t) in zip(sc[li], stc[li]):
            for r, h in itertools.product(range(ic.shape[0]),
                                          range(ic.shape[1])):
                n_sel += 1
                a, b = set(ic[r, h].tolist()), set(it[r, h].tolist())
                if a == b:
                    continue
                n_diff += 1
                # pages only one route chose must sit at the K-th boundary
                for s in (s_c[r, h], s_t[r, h]):
                    srt = np.sort(s)[::-1]
                    edge = 0.5 * (srt[k - 1] + srt[k])
                    scale = max(abs(srt[k - 1]), 1e-30)
                    gap = max(abs(s[j] - edge) for j in a ^ b) / scale
                    worst_gap = max(worst_gap, float(gap))
    rel = float(np.linalg.norm(lc - lt) / np.linalg.norm(lt))
    same_tok = bool(np.array_equal(oc, ot))
    log(f"[sb f32] full width f32, prefill + 2 sparse steps: {n_diff} of "
        f"{n_sel} (step, layer, row, head) TopK selections differ between "
        f"kernel=cuda and kernel=torch (largest relative gap to the K-th "
        f"boundary {worst_gap:.3e}, limit 1e-5); last logits relative L2 "
        f"{rel:.3e} (limit 1e-4); tokens equal: {same_tok}")
    record["sb_f32"] = {"n_differ": n_diff, "n_selections": n_sel,
                        "worst_gap": worst_gap, "logits_rel_l2": rel,
                        "tokens_equal": same_tok}
    assert n_sel == 2 * cfg.n_layers * SB_BATCH * cfg.n_kv_heads
    assert worst_gap <= 1e-5, "a TopK difference is not a score tie"
    assert rel <= 1e-4, f"logits relative L2 {rel:.3e} > 1e-4"
    assert same_tok, "tokens differ"
    del runs, params
    free_cuda()


def phase_sb_reduced_cpu() -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serve.engine import Engine
    cfg = get_config("qwen2-1.5b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(4, 32))
    res = {}
    for sparse in (True, False):
        engines = [Engine(cfg, params, max_len=64, sparse=sparse,
                          nsb_pages=32, device=dev) for dev in ("cuda", "cpu")]
        outs = [eng.generate({"tokens": toks}, 16) for eng in engines]
        a, b = engines[0].logits.cpu().numpy(), engines[1].logits.numpy()
        worst = float(np.max(np.abs(a - b) / (1 + np.abs(b))))
        same = bool(np.array_equal(outs[0], outs[1]))
        stats = vars(engines[0].stats) == vars(engines[1].stats)
        res["sparse" if sparse else "dense"] = {
            "tokens_equal": same, "max_rel_err": worst, "stats_equal": stats}
        log(f"[sb reduced] qwen2-1.5b reduced f32, Engine sparse={sparse}, "
            f"card (kernels) vs CPU (plain): tokens equal {same}, NSB "
            f"counters equal {stats}, max |logit diff| / (1 + |logit|) "
            f"{worst:.3e} (limit 1e-4)")
    record["sb_reduced_cpu"] = res
    for r in res.values():
        assert r["tokens_equal"] and r["stats_equal"]
        assert r["max_rel_err"] <= 1e-4


# -- phases 18-20: the capacity dispatch's grouped GEMM on qwen3-moe ---------

def dispatch_shapes(cfg) -> list:
    """(tag, rows per expert) of the grouped GEMMs the MoE paths run: a
    paged prefill chunk (one request, CHUNK tokens), and the single-batch
    prefill and decode step (MSB_BATCH rows)."""
    from repro_torch.models.moe import _capacity
    e, k = cfg.n_experts, cfg.top_k
    return [("paged prefill chunk", _capacity(CHUNK, k, e, 1.25)),
            ("single-batch prefill",
             MSB_BATCH * _capacity(MSB_PROMPT, k, e, 1.25)),
            ("single-batch decode", MSB_BATCH * _capacity(1, k, e, 1.25))]


def packed_experts(gen, dtype, cfg) -> dict:
    """One layer's experts in the port's packed layout
    (``params._expert_views``): gate and up are [E, D, F] views of
    [E, F, D] memory, down is [E, F, D]; std D**-0.5."""
    import torch

    from repro_torch.params import _expert_views
    e, f, d = cfg.n_experts, cfg.d_ff_expert, cfg.d_model
    rows = torch.empty((f * (1 + e * 3), d), dtype=dtype, device="cuda")
    for a in range(0, rows.shape[0], 1 << 16):
        b = min(rows.shape[0], a + (1 << 16))
        rows[a:b] = torch.randn((b - a, d), generator=gen,
                                device="cuda") * d ** -0.5
    return {k: v[0] for k, v in _expert_views(rows, 1, e, f).items()}


def dispatch_bound(x, w, n_out) -> tuple[float, str, dict]:
    """Least time of one grouped GEMM: x, every expert's weights and the
    output moved once; two flops per multiply-add of every row."""
    t, k = x.shape
    e, _, n = w.shape
    item = x.element_size()
    nbytes = (x.numel() + e * k * n + n_out) * item + (t // 16) * 4
    flops = 2 * t * k * n
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype_name(x.dtype)] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations"), {
        "bytes": nbytes, "flops": flops}


def dispatch_rows(gen, plain: bool) -> list:
    """``moe_dispatch_matmul`` in bfloat16 at the nine rows of the MoE
    paths (``dispatch_shapes`` x gate, up, down) through one layer's
    packed experts: the kernel against the plain version (1e-2 abs +
    rel), then its time (CUDA events, and the profiler's device time a
    call of the ``grouped_*`` kernels) beside the bound and
    ``torch.matmul`` over ``[E, B*cap, K] x [E, K, N]``; with ``plain``
    the plain version's time too.  Returns one row each; a row that
    disagrees has ``ok`` False."""
    import torch

    from repro_torch.kernels.moe_dispatch import (moe_dispatch_matmul,
                                                  moe_dispatch_matmul_plain)
    cfg = moe_config()
    e, f, d = cfg.n_experts, cfg.d_ff_expert, cfg.d_model
    w = packed_experts(gen, torch.bfloat16, cfg)
    rows = []
    for tag, rpe in dispatch_shapes(cfg):
        t = e * rpe
        gids = torch.arange(e, dtype=torch.int32, device="cuda")
        gids = gids.repeat_interleave(rpe // 16)
        x = torch.randn((t, d), generator=gen, device="cuda").bfloat16()
        h = torch.randn((t, f), generator=gen, device="cuda").bfloat16()
        for name, a, wt in (("gate", x, w["we_gate"]), ("up", x, w["we_up"]),
                            ("down", h, w["we_down"])):
            def kern(a=a, wt=wt):
                return moe_dispatch_matmul(gids, a, wt, block_t=16)

            def slow(a=a, wt=wt):
                return moe_dispatch_matmul_plain(gids, a, wt, block_t=16)
            got = kern()
            torch.cuda.synchronize()
            err, ok = close_enough(got, slow(), 1e-2)
            del got
            bound, by, work = dispatch_bound(a, wt, t * wt.shape[2])
            ae = a.view(e, rpe, -1)
            p1 = cuda_ms(slow, iters=3, warmup=1) if plain else None
            k_ms = cuda_ms(kern)
            lib_ms = cuda_ms(lambda ae=ae, wt=wt: torch.matmul(ae, wt))
            p2 = cuda_ms(slow, iters=3, warmup=1) if plain else None
            # device time of the GEMM's kernels a call, only if the
            # profiler recorded all 10 main launches
            names = ("grouped_wgmma", "grouped_mma", "grouped_tiles")
            prof = profile_call(lambda: [kern() for _ in range(10)], names)
            n_main = sum(prof.get("counted_n", {}).get(k, 0)
                         for k in names[:2])
            dev_ms = (sum(prof["counted_ms"].values()) / 10 if n_main == 10
                      else None)
            row = dict(shape=tag, product=name, T=t, K=a.shape[1],
                       N=wt.shape[2], ms=k_ms, device_ms=dev_ms,
                       plain_ms=min(p1, p2) if plain else None,
                       bound_ms=bound, bound_by=by, library_ms=lib_ms,
                       work=work, tflops=work["flops"] / k_ms / 1e9,
                       max_abs_err=err, ok=ok)
            dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
            pl = "" if not plain else f"plain {row['plain_ms']:.4f} ms, "
            log(f"[moe_dispatch_matmul] bf16 {tag} {name} T={t} "
                f"K={a.shape[1]} N={wt.shape[2]} w strides "
                f"{tuple(wt.stride())}: max |err| {err:.3e} (tolerance "
                f"0.01 abs + 0.01 rel) {'ok' if ok else 'FAIL'}; kernel "
                f"{k_ms:.4f} ms = {row['tflops']:.1f} TFLOP/s (device time "
                f"{dev} a call), {pl}bound {bound:.5f} ms ({by}: {work}), "
                f"library torch.matmul {lib_ms:.4f} ms = "
                f"{k_ms / lib_ms:.2f}x")
            rows.append(row)
        del x, h, a, wt, ae, kern, slow
        free_cuda()
    del w
    free_cuda()
    return rows


def phase_dispatch_kernels() -> None:
    import torch

    from repro_torch.kernels.moe_dispatch import (moe_dispatch_matmul,
                                                  moe_dispatch_matmul_plain)
    cfg = moe_config()
    e, f, d = cfg.n_experts, cfg.d_ff_expert, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = dispatch_rows(gen, plain=True)
    record["moe_dispatch_matmul_runs"] = rows
    record["moe_dispatch_matmul"] = next(
        r for r in rows if r["shape"] == "paged prefill chunk"
        and r["product"] == "gate")
    bad = [f"bfloat16 {r['shape']} {r['product']}" for r in rows
           if not r["ok"]]
    # the float32 route (CUDA cores) at the paged chunk: checked, not timed
    w = packed_experts(gen, torch.float32, cfg)
    tag, rpe = dispatch_shapes(cfg)[0]
    t = e * rpe
    gids = torch.arange(e, dtype=torch.int32, device="cuda")
    gids = gids.repeat_interleave(rpe // 16)
    x = torch.randn((t, d), generator=gen, device="cuda")
    h = torch.randn((t, f), generator=gen, device="cuda")
    for name, a, wt in (("gate", x, w["we_gate"]), ("up", x, w["we_up"]),
                        ("down", h, w["we_down"])):
        got = moe_dispatch_matmul(gids, a, wt, block_t=16)
        torch.cuda.synchronize()
        want = moe_dispatch_matmul_plain(gids, a, wt, block_t=16)
        err, ok = close_enough(got, want, 1e-4)
        log(f"[moe_dispatch_matmul] float32 {tag} {name}: T={t} "
            f"K={a.shape[1]} N={wt.shape[2]} w strides {tuple(wt.stride())}:"
            f" max |err| {err:.3e} (tolerance 0.0001 abs + 0.0001 rel) "
            f"{'ok' if ok else 'FAIL'}")
        record.setdefault("dispatch_checks", []).append(
            {"dtype": "float32", "shape": tag, "product": name,
             "max_abs_err": err, "tol": 1e-4, "ok": ok})
        if not ok:
            bad.append(f"float32 {tag} {name}")
    del w, x, h, got, want, a, wt
    free_cuda()
    # flash_prefill at the single-batch MoE path's prefill
    bad += [f"flash_prefill {r['shape']}" for r in flash_rows(
        gen, ("qwen3-moe single-batch prefill",)) if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with plain: {bad}")


def msb_kernels() -> dict:
    from repro_torch.kernels.moe_dispatch import moe_dispatch_matmul
    return {**sb_kernels(), "moe_dispatch_matmul": moe_dispatch_matmul}


def phase_msb_serve(state: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.params import init_params
    from repro_torch.serve.engine import Engine
    cfg = moe_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab, (MSB_BATCH, MSB_PROMPT),
                           generator=torch.Generator().manual_seed(0))
    kernels = msb_kernels()
    for fn in kernels.values():
        fn.launches = 0
    eng = Engine(cfg, params, max_len=MSB_PROMPT + MSB_GEN, sparse=True,
                 device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = [eng.prefill({"tokens": tokens})]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_s, profiled = [], None
    for i in range(MSB_GEN - 1):
        if i == 4:
            profiled = profile_step(eng, ("grouped_",) + DECODE_KERNELS)
            toks.append(eng._last)
            continue
        t0 = time.perf_counter()
        toks.append(eng.step())
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in kernels.items()}
    state["msb_launches"] = launches
    out = np.stack([t.cpu().numpy() for t in toks], axis=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    logits = eng.logits
    # the same prompts prefilled once more under the profiler (after the
    # counts and the peak were read; phase 20 prefills afresh)
    prefill_prof = profile_prefill("msb serve", eng, tokens)
    st = eng.stats
    L = cfg.n_layers
    ms = np.asarray(decode_s) * 1e3
    n_prompt = MSB_BATCH * MSB_PROMPT
    log(f"[msb serve] {MOE_ARCH} full width, {L} layers, bf16, single-batch "
        f"Engine, kernel=cuda: weights made in {init_s:.1f} s; batch "
        f"{MSB_BATCH} x {MSB_PROMPT} prompt tokens, {out.shape[1]} tokens "
        f"each, TopK {cfg.kv_topk_pages} of {(MSB_PROMPT + MSB_GEN) // 16} "
        f"pages")
    log(f"[msb serve] prefill {n_prompt} tokens in {prefill_s:.3f} s = "
        f"{n_prompt / prefill_s:.0f} tokens/s; decode {len(ms)} timed steps, "
        f"ms/step mean {ms.mean():.2f} median {np.median(ms):.2f}")
    log(f"[msb serve] launches: moe_dispatch_matmul "
        f"{launches['moe_dispatch_matmul']} (3 x {L} x (1 prefill + "
        f"{st.steps} steps) = {3 * L * (1 + st.steps)}), sparse_decode_attn "
        f"{launches['sparse_decode_attn']} ({st.steps * L}), flash_prefill "
        f"{launches['flash_prefill']} ({L}), gather_rows "
        f"{launches['gather_rows']} ({1 + st.steps})")
    log(f"[msb serve] NSB hit rate {st.hot_hit_rate}; peak device memory "
        f"{peak:.2f} GiB (set-up included)")
    log_profile("msb serve", profiled)
    if profiled and profiled["busy_share"] is not None:
        log(f"[msb serve] profiled decode step: grouped GEMM "
            f"{profiled['counted_ms']['grouped_']:.2f} ms of device time "
            f"({profiled['counted_n']['grouped_']} launches)")
    record["msb_serve"] = {
        "layers": L, "batch": MSB_BATCH, "prompt": MSB_PROMPT,
        "gen": MSB_GEN, "init_s": init_s, "prefill_s": prefill_s,
        "prefill_tokens_per_s": n_prompt / prefill_s,
        "decode_ms_mean": float(ms.mean()),
        "decode_ms_median": float(np.median(ms)),
        "decode_steps_timed": len(ms), "launches": launches,
        "nsb_hit_rate": st.hot_hit_rate, "profile": profiled,
        "prefill_profile": prefill_prof, "max_memory_gib": peak}
    assert out.shape == (MSB_BATCH, MSB_GEN) and st.steps == MSB_GEN - 1
    assert launches["moe_dispatch_matmul"] == 3 * L * (1 + st.steps)
    assert launches["sparse_decode_attn"] == st.steps * L
    assert launches["flash_prefill"] == L
    assert launches["gather_rows"] == 1 + st.steps
    assert bool(torch.isfinite(logits).all())
    assert ((out >= 0) & (out < cfg.vocab)).all()
    assert peak < 80
    state.update(msb_engine=eng, msb_tokens=tokens)


def phase_msb_teacher_forced(state: dict) -> None:
    """Every kernel of path 2b held against its plain version in every
    layer, on the path's own activations: the grouped GEMMs and the
    causal ``flash_prefill`` (B=8, S=1024, H=64, KV=4, q_offset 0) of one
    prefill, then the grouped GEMMs and ``sparse_decode_attn`` (KV=4,
    G=16) of one decode step.  Each layer goes on from the kernel's
    output."""
    import torch

    from repro_torch.kernels.moe_dispatch import moe_dispatch_matmul_plain
    from repro_torch.models import moe, transformer
    from repro_torch.models.layers import chunked_attention
    from repro_torch.models.sparse_attention import attend_pages
    eng = state["msb_engine"]
    L = eng.cfg.n_layers
    tol = 1e-2
    errs: dict = {"moe_dispatch_matmul prefill": {}, "flash_prefill": {},
                  "moe_dispatch_matmul decode": {},
                  "sparse_decode_attn": {}}
    fails, shapes = [], {}

    def note(name, li, got, want, shape):
        err, ok = close_enough(got, want, tol)
        errs[name][li] = max(errs[name].get(li, 0.0), err)
        shapes[name] = shape
        if not ok:
            fails.append((name, li))
    gemm, attn = moe.moe_dispatch_matmul, transformer.flash_prefill
    n_gemm = []                 # the prefill's 3 * L calls, then the step's

    def checked_gemm(gids, x, w, *, block_t):
        out = gemm(gids, x, w, block_t=block_t)
        stage = "prefill" if len(n_gemm) < 3 * L else "decode"
        note(f"moe_dispatch_matmul {stage}", len(n_gemm) // 3 % L, out,
             moe_dispatch_matmul_plain(gids, x, w, block_t=block_t),
             f"T={x.shape[0]}")
        n_gemm.append(1)
        return out

    def checked_attn(q, k, v, *, q_offset, causal, chunk, logit_softcap):
        out = attn(q, k, v, q_offset=q_offset, causal=causal, chunk=chunk,
                   logit_softcap=logit_softcap)
        note("flash_prefill", len(errs["flash_prefill"]), out,
             chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                               chunk=chunk, logit_softcap=logit_softcap),
             f"q {tuple(q.shape)} k {tuple(k.shape)} q_offset {q_offset}")
        return out

    def probe(li, x):
        note("sparse_decode_attn", li, x["out"], attend_pages(
            x["q"], x["k"], x["v"], x["idx"], x["pos"], eng.cfg.kv_page),
            f"q {tuple(x['q'].shape)} pos {x['pos']}")
    moe.moe_dispatch_matmul = checked_gemm
    transformer.flash_prefill = checked_attn
    eng.attend_probe = probe
    try:
        eng.prefill({"tokens": state["msb_tokens"]})
        eng.step()
    finally:
        moe.moe_dispatch_matmul = gemm
        transformer.flash_prefill = attn
        eng.attend_probe = None
    torch.cuda.synchronize()
    for name, by_layer in errs.items():
        log(f"[msb teacher-forced] {name} ({shapes.get(name)}), bf16 full "
            f"width: {len(by_layer)} layers checked, max |kernel - plain| "
            f"per layer {[round(by_layer[i], 5) for i in sorted(by_layer)]} "
            f"(tolerance {tol:g} abs + {tol:g} rel)")
    record["msb_teacher_forced"] = {"max_abs_err": errs, "tol": tol,
                                    "shapes": shapes, "failed": fails}
    assert len(n_gemm) == 6 * L, "not every grouped GEMM checked"
    assert all(len(v) == L for v in errs.values()), "not every layer checked"
    assert not fails, f"(kernel, layer) pairs disagree: {fails}"


# -- phases 21-22: gather_spmm and the kernel quickstart -----------------------

def spmm_bound(cols, vals, dense, n_out) -> tuple[float, str, dict]:
    """Least time of one call on this data: the ELL arrays, the dense rows
    they name and the float32 output each moved once; two flops for each
    non-zero entry and output column, at the card's peak for the dense
    operand's type (the kernel's float32 FMAs on the CUDA cores do not
    set the least time: a tensor-core product of bf16 operands could)."""
    import torch
    n = dense.shape[1]
    rows = int(torch.unique(cols).numel())
    nnz = int((vals != 0).sum())
    nbytes = (cols.numel() * 4 + vals.numel() * vals.element_size()
              + rows * n * dense.element_size() + n_out * 4)
    flops = 2 * nnz * n
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype_name(dense.dtype)] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations"), {
        "bytes": nbytes, "flops": flops, "nnz": nnz, "dense_rows": rows}


def phase_spmm_kernels() -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.gather_spmm import (gather_spmm,
                                                 gather_spmm_plain)
    gen = torch.Generator(device="cuda").manual_seed(5)
    bad = []
    cfg = get_config("qwen2-1.5b")
    n_in = cfg.d_ff
    j_pruned = n_in // 10                  # 90 % unstructured sparsity
    cases = (
        ("kernel bench", 256, 16, 1024, 1024, torch.float32),
        (f"qwen2-1.5b down projection [{cfg.d_model}, {n_in}] at 90% "
         f"sparsity over a {CHUNK}-token chunk", cfg.d_model, j_pruned, n_in,
         CHUNK, torch.bfloat16))
    for tag, m, j, nin, n, dt in cases:
        if j == 16:
            cols = torch.randint(0, nin, (m, j), generator=gen, device="cuda")
        else:                              # distinct sorted ids per row
            cols = torch.rand((m, nin), generator=gen,
                              device="cuda").argsort(dim=1)[:, :j]
            cols = cols.sort(dim=1).values
        cols = cols.to(torch.int32).contiguous()
        vals = (torch.randn((m, j), generator=gen, device="cuda")
                * j ** -0.5).to(dt)
        dense = torch.randn((nin, n), generator=gen, device="cuda").to(dt)
        got = gather_spmm(cols, vals, dense)
        torch.cuda.synchronize()
        err, ok = close_enough(got, gather_spmm_plain(cols, vals, dense),
                               1e-5)
        log(f"[gather_spmm] {tag}: M={m} J={j} N_in={nin} N={n} "
            f"{dtype_name(dt)}: max |err| {err:.3e} (tolerance 1e-05 abs + "
            f"1e-05 rel) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(tag)
        # the yardstick: torch.sparse.mm on the same matrix in CSR
        crow = torch.arange(0, (m + 1) * j, j, device="cuda")

        def csr_of(v):
            return torch.sparse_csr_tensor(crow, cols.long().reshape(-1),
                                           v.reshape(-1), size=(m, nin))
        csr, lib_note = csr_of(vals), ""
        try:
            torch.sparse.mm(csr, dense)
            lib_fn = (lambda: torch.sparse.mm(csr, dense))
        except (RuntimeError, NotImplementedError):
            csr32, dense32 = csr_of(vals.float()), dense.float()
            lib_fn = (lambda: torch.sparse.mm(csr32, dense32))
            lib_note = " (float32 operands: no bf16 CSR product here)"
        bound, by, work = spmm_bound(cols, vals, dense, m * n)
        p1 = cuda_ms(lambda: gather_spmm_plain(cols, vals, dense))
        k_ms = cuda_ms(lambda: gather_spmm(cols, vals, dense))
        lib_ms = cuda_ms(lib_fn)
        p2 = cuda_ms(lambda: gather_spmm_plain(cols, vals, dense))
        row = dict(ms=k_ms, plain_ms=min(p1, p2), bound_ms=bound,
                   bound_by=by, library_ms=lib_ms, max_abs_err=err,
                   shape=tag, work=work, library_note=lib_note)
        record.setdefault("gather_spmm_runs", []).append(row)
        record["gather_spmm"] = row        # the pruned layer, the last case
        log(f"[gather_spmm] {tag}: kernel {k_ms:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {bound:.5f} ms ({by}: {work}),"
            f" library torch.sparse.mm (CSR){lib_note} {lib_ms:.4f} ms")
        del cols, vals, dense, csr, got
    if bad:
        raise AssertionError(f"kernel disagrees with plain: {bad}")


def phase_quickstart(state: dict) -> None:
    import torch

    from repro_torch.kernels.gather_spmm import gather_spmm
    from repro_torch.kernels.sparse_decode_attn import sparse_decode_attn
    from repro_torch.launch import quickstart
    kernels = {"gather_spmm": gather_spmm,
               "sparse_decode_attn": sparse_decode_attn}
    for fn in kernels.values():
        fn.launches = 0
    rc = quickstart.main([])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    state["qs_launches"] = launches
    log(f"[quickstart] exit {rc}, launches {launches}")
    record["quickstart"] = {"rc": rc, "launches": launches}
    assert rc == 0 and all(v > 0 for v in launches.values())


def _map(tree, fn):
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def flash_rows_only(src: Path) -> int:
    """``--flash-rows``: the card, then every ``flash_shapes`` row of the
    port under ``src``, as one JSON line."""
    import torch
    run_phase("1 card", phase_card)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows: list = []
    run_phase("flash_prefill rows", lambda: rows.extend(
        flash_rows(gen, list(flash_shapes()))))
    print(json.dumps({"src": str(src), "card": record.get("card"),
                      "flash_prefill_rows": rows}, default=str))
    return 1 if failures or not all(r["ok"] for r in rows) else 0


def dispatch_rows_only(src: Path) -> int:
    """``--dispatch-rows``: the card, then the grouped GEMM's nine rows
    (``dispatch_rows``, no plain timing) of the port under ``src``, as
    one JSON line."""
    import torch
    run_phase("1 card", phase_card)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows: list = []
    run_phase("moe_dispatch_matmul rows", lambda: rows.extend(
        dispatch_rows(gen, plain=False)))
    print(json.dumps({"src": str(src), "card": record.get("card"),
                      "moe_dispatch_rows": rows}, default=str))
    return 1 if failures or not all(r["ok"] for r in rows) else 0


def decode_rows_only(src: Path) -> int:
    """``--decode-rows``: the card, then every ``decode_shapes`` row of
    the two decode-attention kernels of the port under ``src``, as one
    JSON line."""
    import torch
    run_phase("1 card", phase_card)
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows: list = []
    run_phase("decode attention rows", lambda: rows.extend(
        decode_rows(gen, list(decode_shapes()))))
    print(json.dumps({"src": str(src), "card": record.get("card"),
                      "decode_rows": rows}, default=str))
    return 1 if failures or not all(r["ok"] for r in rows) else 0


def main(argv: list[str] | None = None) -> int:
    """Run with ``argv`` (no arguments when None)."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flash-rows", action="store_true",
                    help="time only the flash_prefill rows")
    ap.add_argument("--dispatch-rows", action="store_true",
                    help="time only the moe_dispatch_matmul rows")
    ap.add_argument("--decode-rows", action="store_true",
                    help="time only the paged_decode_attn and "
                    "sparse_decode_attn rows")
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="checkout whose src/ holds the port")
    args = ap.parse_args(argv or [])
    src = args.src.resolve() / "src"
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repro_torch package is not under {src}; "
              "run the script from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.flash_rows:
        return flash_rows_only(src)
    if args.dispatch_rows:
        return dispatch_rows_only(src)
    if args.decode_rows:
        return decode_rows_only(src)
    t0 = time.perf_counter()
    state: dict = {}
    run_phase("1 card", phase_card)
    run_phase("2 build", phase_build)
    run_phase("3 kernels vs plain", phase_kernels)
    run_phase("4 serve full width", lambda: phase_serve(state))
    run_phase("5 teacher-forced per layer",
              lambda: phase_teacher_forced(state))
    state.pop("engine", None)
    torch.cuda.empty_cache()
    run_phase("6 f32 topk cuda vs torch", lambda: phase_f32_topk(state))
    run_phase("7 reduced card vs cpu", phase_reduced_cpu)
    for k in ("cfg", "params", "engine", "work"):
        state.pop(k, None)
    free_cuda()
    run_phase("8 moe kernels vs plain", phase_moe_kernels)
    free_cuda()
    run_phase("9 moe serve full width", lambda: phase_moe_serve(state))
    run_phase("10 moe teacher-forced per layer",
              lambda: phase_moe_teacher_forced(state))
    state.pop("moe_engine", None)
    free_cuda()
    run_phase("11 moe f32 cuda vs torch, dense vs paged",
              lambda: phase_moe_f32(state))
    run_phase("12 moe reduced card vs cpu", lambda: phase_reduced_cpu(
        MOE_ARCH, "moe_reduced_cpu", expert_pool="paged"))
    for k in ("moe_engine", "moe_work"):
        state.pop(k, None)
    free_cuda()
    run_phase("13 single-batch kernels vs plain", phase_sb_kernels)
    free_cuda()
    run_phase("14 single-batch Engine full width",
              lambda: phase_sb_serve(state))
    run_phase("15 single-batch teacher-forced per layer",
              lambda: phase_sb_teacher_forced(state))
    state.pop("sb_engine", None)
    free_cuda()
    run_phase("16 single-batch f32 cuda vs torch",
              lambda: phase_sb_f32(state))
    run_phase("17 single-batch reduced card vs cpu", phase_sb_reduced_cpu)
    for k in ("sb_cfg", "sb_params", "sb_engine"):
        state.pop(k, None)
    free_cuda()
    run_phase("18 grouped GEMM vs plain", phase_dispatch_kernels)
    free_cuda()
    run_phase("19 moe single-batch Engine full width",
              lambda: phase_msb_serve(state))
    run_phase("20 moe single-batch teacher-forced per layer",
              lambda: phase_msb_teacher_forced(state))
    for k in ("msb_engine", "msb_tokens"):
        state.pop(k, None)
    free_cuda()
    run_phase("21 gather_spmm vs plain", phase_spmm_kernels)
    run_phase("22 quickstart on the card", lambda: phase_quickstart(state))
    record["seconds"] = time.perf_counter() - t0
    record["failures"] = failures
    if os.environ.get("CHIP_SMOKE_JSON"):
        out = Path(os.environ["CHIP_SMOKE_JSON"])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1, default=str))
    if failures:
        log(f"chip_smoke: FAILED phases {failures}")
        return 1
    # launches of the five paths, each counted from 0 around its run
    launches: dict = {}
    for run in ("launches", "moe_launches", "sb_launches", "msb_launches",
                "qs_launches"):
        for k, v in state[run].items():
            launches[k] = launches.get(k, 0) + v
    kernels = []
    csrc = "src/repro_torch/kernels/csrc/"
    for name, src, tpu in (
            ("paged_decode_attn", "paged_decode_attn.cu", DECODE_TPU),
            ("flash_prefill", "flash_prefill.cu", PREFILL_TPU),
            ("moe_paged_gateup", "moe_dispatch.cu", GATEUP_TPU),
            ("moe_paged_down", "moe_dispatch.cu", DOWN_TPU),
            ("sparse_decode_attn", "sparse_decode_attn.cu", SPARSE_TPU),
            ("gather_rows", "gather_rows.cu", GATHER_TPU),
            ("moe_dispatch_matmul", "moe_dispatch.cu", DISPATCH_TPU),
            ("gather_spmm", "gather_spmm.cu", SPMM_TPU)):
        r = record[name]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": tpu,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        log(f"chip_smoke: kernels never launched on a path: {idle}")
        return 1
    print(record["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
