#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero and suppresses the
final result line):

1. the card's name and power limit (``nvidia-smi``);
2. both CUDA kernels built from ``src/repro_torch/kernels/csrc`` with
   ``nvcc -Xptxas -v`` (registers, shared memory, spills printed);
3. each kernel against its plain PyTorch version at the serve path's
   shapes, with times (CUDA events), the plain version's time, the
   bound (bytes or operations at the card's peak rates) and one
   PyTorch library call timed as a yardstick;
4. the port's main path: ``PagedEngine`` serving 8 requests of about
   1500 prompt tokens on qwen2-1.5b at full width in bfloat16 (seeded
   random weights), with the kernels' launch counts, decode and prefill
   rates, the NSB hit rate and the device busy share of one profiled
   decode step;
5. teacher-forced per-layer check: every layer's decode attention
   inputs of one step go to the kernel and to the plain version;
6. full width in float32, first decode step, ``kernel="cuda"`` against
   ``kernel="torch"``: TopK selections and logits;
7. reduced qwen2-1.5b in float32: the card against the CPU.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  With ``CHIP_SMOKE_JSON=<path>`` in
the environment a JSON record of every number is written there too.
The script needs a CUDA card and the repository around it: without
either it exits non-zero.
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
SRC = ROOT / "src"

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# serve-path shapes of qwen2-1.5b (full width)
N_REQ, PROMPT, GEN, CHUNK = 8, 1500, 32, 256

DECODE_TPU = "src/repro/kernels/paged_decode_attn.py:129"
PREFILL_TPU = "src/repro/kernels/flash_prefill.py:106"

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
    # timing at the main path's bf16 pools, rotating over 8 layers of
    # pool (~100 MB) so pages come from device memory, not L2
    c = decode_case(gen, torch.bfloat16, torch.bfloat16, n_layers=8)
    layers = itertools.cycle(range(8))

    def kern():
        li = next(layers)
        paged_decode_attn(c["phys"], c["idx"], c["pos"], c["q"], c["kp"][li],
                          c["vp"][li], page_size=c["page"])

    def plain():
        li = next(layers)
        attend_pages_paged(c["q"], c["kp"][li], c["vp"][li], c["idx"],
                           c["phys"], c["pos"], c["page"])
    bound, by, work = decode_bound(c, torch.bfloat16)
    plain_ms = cuda_ms(plain)
    k_ms = cuda_ms(kern)
    plain_ms2 = cuda_ms(plain)
    record["paged_decode_attn"] = dict(
        ms=k_ms, plain_ms=min(plain_ms, plain_ms2), bound_ms=bound,
        bound_by=by, library_ms=None, work=work,
        max_abs_err=record["decode_checks"][0]["max_abs_err"])
    log(f"[paged_decode_attn] bf16 R=8 KV=2 G=6 D=128 page=16 K=64: "
        f"kernel {k_ms:.4f} ms, plain {min(plain_ms, plain_ms2):.4f} ms, "
        f"bound {bound:.5f} ms ({by}: {work}); library: none (no single "
        "PyTorch call gathers TopK pages through a block table and "
        "attends over them)")

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


def profile_step(eng) -> dict:
    """Device busy share and top kernels of one ``eng.step()``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            s, t = e.time_range.start, e.time_range.end
            spans.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    if not spans:
        return {"busy_share": None, "wall_ms": wall_us / 1e3}
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
            "top": [{"name": n[:90], "ms": us / 1e3} for n, us in top]}


def phase_serve(state: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_decode_attn import paged_decode_attn
    from repro_torch.params import init_params
    cfg = get_config("qwen2-1.5b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    state.update(cfg=cfg, params=params)
    eng = full_engine(cfg, params, kernel="cuda")
    work = serve_workload(cfg)
    for t, p, g in work:
        eng.submit(p, g, arrival=t)
    torch.cuda.synchronize()
    decode_s, prefill_s, profiled = [], 0.0, None
    paged_decode_attn.launches = 0
    flash_prefill.launches = 0
    t_run = time.perf_counter()
    while eng.scheduler.has_work:
        sch = eng.scheduler
        decode_only = (not sch.waiting and sch.running
                       and not any(r.in_prefill for r in sch.running))
        if decode_only and profiled is None and len(decode_s) >= 4:
            profiled = profile_step(eng)
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
    launches = {"paged_decode_attn": paged_decode_attn.launches,
                "flash_prefill": flash_prefill.launches}
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
    ms = np.asarray(decode_s) * 1e3
    log(f"[serve] decode-only steps: {len(ms)}, ms/step mean "
        f"{ms.mean():.2f} median {np.median(ms):.2f}; prefill "
        f"{st.prefill_tokens} tokens in {prefill_s:.2f} s of iterations "
        f"with prefill = {st.prefill_tokens / prefill_s:.0f} tokens/s")
    log(f"[serve] launches: paged_decode_attn {launches['paged_decode_attn']}"
        f" (decode steps x {L} = {st.steps * L}), flash_prefill "
        f"{launches['flash_prefill']} (prefill chunks x {L} = "
        f"{st.prefill_calls * L})")
    per_step = st.pages_touched / max(st.steps, 1)
    why = ("more than the LRU holds, so each step evicts the pages the "
           "next one needs and the LRU thrashes"
           if per_step > eng.hot.capacity else
           "which the LRU can hold, so steps reuse each other's pages")
    log(f"[serve] NSB hit rate {m['nsb_hot_hit_rate']}: each decode step "
        f"touches {per_step:.1f} unique layer-0 pages on average against a "
        f"{eng.hot.capacity}-page LRU, {why}")
    if profiled and profiled["busy_share"] is not None:
        log(f"[serve] profiled decode step: wall {profiled['wall_ms']:.2f} "
            f"ms, device busy {profiled['device_ms']:.2f} ms = "
            f"{100 * profiled['busy_share']:.1f}% over "
            f"{profiled['n_kernels']} kernels; top by device time:")
        for t in profiled["top"]:
            log(f"[serve]   {t['ms']:.3f} ms  {t['name']}")
    else:
        log("[serve] device busy share: not measured (the profiler "
            "recorded no device events)")
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

def phase_reduced_cpu() -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serve.engine import PagedEngine
    cfg = get_config("qwen2-1.5b").reduced()
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
                          nsb_pages=32, device=dev)
        eng.run([(t, p.copy(), g) for t, p, g in work])
        engines[dev] = eng
    worst = 0.0
    same = True
    for rid, a in engines["cuda"].requests.items():
        b = engines["cpu"].requests[rid]
        same &= a.out_tokens == b.out_tokens
        worst = max(worst, float(np.max(np.abs(a.last_logits - b.last_logits)
                                        / (1 + np.abs(b.last_logits)))))
    log(f"[reduced] qwen2-1.5b reduced f32, card (kernels) vs CPU (plain): "
        f"tokens equal {same}, max |logit diff| / (1 + |logit|) "
        f"{worst:.3e} (limit 1e-4)")
    record["reduced_cpu"] = {"tokens_equal": same, "max_rel_err": worst}
    assert same, "tokens differ between card and CPU"
    assert worst <= 1e-4


def _map(tree, fn):
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repro_torch package is not under {SRC}; "
              "run the script from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    record["seconds"] = time.perf_counter() - t0
    record["failures"] = failures
    if os.environ.get("CHIP_SMOKE_JSON"):
        out = Path(os.environ["CHIP_SMOKE_JSON"])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1, default=str))
    if failures:
        log(f"chip_smoke: FAILED phases {failures}")
        return 1
    launches = state.get("launches", {})
    kernels = []
    for name, src, tpu in (
            ("paged_decode_attn",
             "src/repro_torch/kernels/csrc/paged_decode_attn.cu", DECODE_TPU),
            ("flash_prefill", "src/repro_torch/kernels/csrc/flash_prefill.cu",
             PREFILL_TPU)):
        r = record[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(record["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
