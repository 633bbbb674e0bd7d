"""Serving engines with TopK sparse-KV decode: the port of the
reference's ``serve/engine.py``.

:class:`Engine` is the single-batch baseline: one fixed batch prefills
together (``api.prefill_fn``) into a contiguous ``[L, B, max_len, KV,
D]`` cache and decodes in lockstep (``api.decode_fn``), greedy, until
the batch drains.  With ``kernel="cuda"`` its sparse decode runs the
``sparse_decode_attn`` kernel in every layer, its prefill and dense
decode ``flash_prefill``.  Before each sparse step it scores the layer-0
label cache against an all-ones query (the traffic proxy) and counts
the selected pages against the NSB demand-LRU.  Host syncs: the layer-0
proxy selection and the sampled tokens, once a step.

:class:`PagedEngine` is the continuous-batching engine, the reference's
``PagedEngine`` main path (synchronous).
Requests arrive through an admission queue (:mod:`.scheduler`); each
iteration mixes prefill chunks and one ragged decode batch under a token
budget; the KV cache is a pool of physical pages managed by
:class:`.kv_allocator.KVBlockAllocator` (block table per request,
copy-on-write prefix cache, preemption by recompute).

One decode step advances R requests by one token each: per-request
positions, K/V written through the block table into physical pages, page
summaries recomputed exactly, TopK selection by physical page id and
attention over only the selected pages.  Chunked prefill writes a
prompt chunk's K/V into the pool and attends causally over the request's
block-table-gathered context.  The two attention calls are the port's
CUDA kernels (``kernel="cuda"``, the default: ``kernels.paged_decode_attn``
and ``kernels.flash_prefill``, which run their plain PyTorch versions
for tensors on the CPU) or the plain versions everywhere
(``kernel="torch"``).

MoE configs: the chunked prefill runs the capacity dispatch
(``models.moe.moe_ffn``, its expert products through the
``moe_dispatch_matmul`` kernel with ``kernel="cuda"``) in every layer,
as the reference's prefill does.  The decode step runs it too with
``expert_pool="off"``; with ``"dense"`` or ``"paged"`` it routes each
row to its top-k experts and reads their weights as row-tile pages of
:class:`.expert_pool.ExpertPool` (``"paged"`` with ``kernel="cuda"``
through the two MoE CUDA kernels), returns the routed ids of every
layer with the logits, and scores the pages they demand against a
demand-LRU (``expert_nsb_slots`` pages).

Preemption is by recompute: prompts re-prefill and generated tokens
replay through the decode path, so the same functions see the same
inputs.  Resume is bitwise at a fixed decode batch shape
(``row_bucketing=False``); with row buckets a replayed token may run in
a batch of another size, and a GEMM of another M may round a row
differently, so logits then agree to float32 rounding.  Physical page
ids are the one currency of the allocator, the TopK gather and the NSB
hot-set accounting (:class:`.page_cache.PageCache`).

Host syncs: one copy of the logits and one of the layer-0 selection (and
of the routed expert ids, with an expert pool) per decode step, one copy
of the logits per prefill chunk that finishes a prompt; none per layer.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels.paged_decode_attn import paged_decode_attn
from ..models import api
from ..models import layers as mlayers
from ..models import sparse_attention, transformer
from ..params import pack_experts, torch_dtype
from . import expert_pool as expert_pool_mod
from . import not_ported
from . import scheduler as scheduler_mod
from .kv_allocator import NULL_PAGE, KVBlockAllocator, PagePoolConfig
from .page_cache import PageCache
from .scheduler import PrefillJob, Request, Scheduler

KERNELS = ("cuda", "torch")
EXPERT_RUNAHEAD = ("off", "router")


def percentile(xs, q: float) -> float | None:
    """Nearest-rank (ceil-rank) percentile: the ``ceil(q*n)``-th order
    statistic, 1-indexed (numpy's ``inverted_cdf``).  Empty input gives
    None, so metrics stay strict JSON on zero-traffic runs."""
    xs = sorted(xs)
    if not xs:
        return None
    return float(xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))])


@dataclass
class ServeStats:
    steps: int = 0
    pages_touched: int = 0
    pages_unique: int = 0
    nsb_hits: int = 0
    nsb_misses: int = 0
    tokens_out: int = 0
    row_bytes: int = 0              # K+V bytes fetched per demanded page

    @property
    def hot_hit_rate(self) -> float | None:
        """NSB hit rate, or None before any traffic."""
        tot = self.nsb_hits + self.nsb_misses
        return self.nsb_hits / tot if tot else None

    @property
    def demand_bytes(self) -> int:
        """Off-chip demand: one K+V page fetch of ``row_bytes`` per
        touched page."""
        return (self.nsb_hits + self.nsb_misses) * self.row_bytes

    @property
    def offchip_reduction(self) -> float | None:
        """Bytes not fetched thanks to NSB hits over demand bytes; None
        before traffic."""
        tot = self.demand_bytes
        return (self.nsb_hits * self.row_bytes) / tot if tot else None


class Engine:
    """Single-batch baseline: batched prefill + lockstep sparse decode.

    * ``max_len`` — cache positions, allocated once: prompt plus
      generated tokens must fit; with the sparse path a multiple of
      ``cfg.kv_page``.
    * ``sparse`` — TopK sparse decode (when ``cfg.sparse_kv``), else
      dense attention over the whole cache.
    * ``nsb_pages`` — the demand-LRU the layer-0 proxy pages are scored
      against; ``kv_dtype_bytes`` — the K/V element size the byte
      metrics charge.
    * ``kernel="cuda" | "torch"`` — the port's kernels (which run their
      plain versions for CPU tensors) or the plain versions everywhere.
    * ``device`` — where weights, cache and compute live; the CUDA card
      by default, raising without one.
    * ``attend_probe`` (attribute, default None) — a callable
      ``probe(layer, inputs)`` run after each sparse decode layer's
      attention with that layer's inputs and output, for checks.

    ``capture_trace`` (the NVR simulator capture) belongs to a later
    slice and raises.
    """

    def __init__(self, cfg: ArchConfig, params: dict, max_len: int = 1024,
                 sparse: bool = True, nsb_pages: int = 64,
                 capture_trace: bool = False, kv_dtype_bytes: int = 2,
                 kernel: str = "cuda",
                 device: str | torch.device = "cuda") -> None:
        if capture_trace:
            raise not_ported("capture_trace (NVR simulator capture)",
                             "3. Online runahead staging")
        api.check_family(cfg)
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got "
                             f"{kernel!r}")
        self.sparse = sparse and cfg.sparse_kv
        if self.sparse and max_len % cfg.kv_page:
            raise ValueError(f"max_len {max_len} is not a multiple of "
                             f"kv_page {cfg.kv_page}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self._layers = transformer.layer_params(self.params)
        self.max_len = max_len
        self.kernel = kernel
        self.stats = ServeStats(
            row_bytes=2 * cfg.kv_page * cfg.hd * kv_dtype_bytes)
        self.hot = PageCache(nsb_pages)
        self._seen_pages: set[int] = set()
        self.attend_probe = None
        self.cache = None
        self.logits = None              # float32 logits of the last step
        self._last = None

    def prefill(self, batch: dict) -> torch.Tensor:
        """Prefill ``{"tokens": [B, S]}`` (numpy or torch ids) into a new
        cache of ``max_len`` positions; returns the first sampled tokens
        [B] (on the device)."""
        tokens = batch["tokens"]
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        tokens = tokens.to(self.device, torch.int64)
        self.logits, self.cache = api.prefill_fn(
            self.cfg, self.params, {"tokens": tokens}, max_len=self.max_len,
            kernel=self.kernel, layers=self._layers)
        # torch.argmax, like jnp.argmax, takes the first index of a tie
        self._last = torch.argmax(self.logits, dim=-1)
        return self._last

    def _track_pages(self) -> None:
        """NSB accounting: which pages would the next step's selection
        touch (the layer-0 label cache scored against an all-ones query
        as the traffic proxy, before the step writes its token)."""
        cfg = self.cfg
        kp0 = self.cache["kpage"][0]
        b = kp0.shape[0]
        q = torch.ones((b, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                        cfg.hd), dtype=kp0.dtype, device=kp0.device)
        n_valid = self.cache["pos"] // cfg.kv_page + 1
        k_pages = min(cfg.kv_topk_pages, kp0.shape[1])
        idx = sparse_attention.select_pages(q, kp0, n_valid, k_pages)
        uniq = np.unique(idx.cpu().numpy())
        self._seen_pages.update(int(p) for p in uniq)
        self.stats.pages_unique = len(self._seen_pages)  # run footprint
        for p in uniq:
            self.stats.pages_touched += 1
            if self.hot.touch(int(p)):
                self.stats.nsb_hits += 1
            else:
                self.stats.nsb_misses += 1

    def step(self) -> torch.Tensor:
        """One lockstep decode step of the whole batch; returns the
        sampled tokens [B] (on the device)."""
        if self.sparse:
            self._track_pages()
        self.logits, self.cache = api.decode_fn(
            self.cfg, self.params, self.cache, self._last,
            sparse=self.sparse, kernel=self.kernel, layers=self._layers,
            probe=self.attend_probe)
        self._last = torch.argmax(self.logits, dim=-1)
        self.stats.steps += 1
        self.stats.tokens_out += int(self._last.shape[0])
        return self._last

    def generate(self, batch: dict, n_steps: int) -> np.ndarray:
        """Prefill, then ``n_steps - 1`` decode steps: tokens [B, n_steps]."""
        toks = [self.prefill(batch)]
        for _ in range(n_steps - 1):
            toks.append(self.step())
        return np.stack([t.cpu().numpy() for t in toks], axis=1)


@dataclass
class PagedServeStats(ServeStats):
    iterations: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    preemptions: int = 0
    finished: int = 0
    cow_page_copies: int = 0
    decode_rows_padded: int = 0     # NULL rows computed across the run
    prefill_calls: int = 0          # executed prefill chunks
    # an iteration belongs to the prefill stream when it ran >= 1 prompt
    # chunk, to the decode stream when it ran a decode batch
    prefill_iterations: int = 0
    decode_iterations: int = 0
    overlap_iterations: int = 0     # iterations where both streams ran
    iter_log: list = field(default_factory=list)  # (n_chunks, n_rows)
    # expert-weight page traffic (expert_pool != "off"): unique tile
    # pages demanded per decode step, scored against the demand-LRU
    expert_pages_touched: int = 0
    expert_nsb_hits: int = 0
    expert_nsb_misses: int = 0

    @property
    def expert_hot_hit_rate(self) -> float | None:
        """Expert-tile hit rate (None before expert traffic)."""
        tot = self.expert_nsb_hits + self.expert_nsb_misses
        return self.expert_nsb_hits / tot if tot else None


def paged_decode(cfg: ArchConfig, params: dict, layer_params: list,
                 pools: tuple, host: np.ndarray, attend, probe=None,
                 expert_ffn=None, kernel: str = "cuda"):
    """One ragged decode step over the physical pools, updated in place.

    ``host`` int64 [R, 5 + NL] packs, per row, the token, position,
    frontier physical page, offset in it, valid-page count and the block
    table (NULL-padded; padded rows scribble on scratch page 0).
    ``expert_ffn(layer, layer_params, h)`` -> (out [R, 1, D], eids
    [R, k]) replaces the feed-forward of an MoE config served from an
    expert pool; without it the feed-forward runs ``kernel``'s route.
    Returns (float32 logits [R, V], layer-0 physical selection
    [R, KV, K], routed expert ids [L, R, k] or None)."""
    k_pool, v_pool, s_pool = pools
    dev = k_pool.device
    t = torch.from_numpy(host).to(dev)
    token, pos, phys_w, off, n_valid = t[:, :5].unbind(1)
    bt = t[:, 5:]
    pos32 = pos.to(torch.int32).contiguous()
    r, nl = bt.shape
    page = cfg.kv_page
    kv, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kv
    k_sel = int(min(cfg.kv_topk_pages, nl))
    x = transformer.embed(params, cfg, token[:, None])     # [R,1,D]
    pos_arr = pos[:, None]
    sel0 = None
    esel = []
    for li, lp in enumerate(layer_params):
        kp, vp, sp = k_pool[li], v_pool[li], s_pool[li]
        h = mlayers.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = mlayers.gqa_project(h, lp, cfg)
        q = mlayers.apply_rope(q, pos_arr, cfg.rope_theta)
        k_new = mlayers.apply_rope(k_new, pos_arr, cfg.rope_theta)
        # in-place pool writes stand in for the reference's donated pool
        # buffers: no pool-sized copy per step
        kp.index_put_((phys_w, off),
                      sparse_attention.kv_quant(k_new[:, 0], kp.dtype))
        vp.index_put_((phys_w, off),
                      sparse_attention.kv_quant(v_new[:, 0], vp.dtype))
        sp.index_put_((phys_w,), sparse_attention.page_summary_from_pool(
            kp, phys_w, off + 1))
        qh = q.reshape(r, kv, g, hd)
        idx, phys = sparse_attention.select_pages_blocktable(
            qh, sp, bt, n_valid, k_sel)
        o = attend(phys, idx, pos32, qh, kp, vp, page)
        if probe is not None:
            probe(li, {"q": qh, "k_pool": kp, "v_pool": vp, "idx": idx,
                       "phys": phys, "pos": pos32, "bt": bt,
                       "n_valid": n_valid, "s_pool": sp, "out": o})
        if li == 0:
            sel0 = phys
        x = x + mlayers.attn_out(o.reshape(r, 1, cfg.n_heads, hd), lp)
        h2 = mlayers.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if expert_ffn is None:
            x = x + transformer.ffn(h2, lp, cfg, kernel=kernel)
        else:
            y, eids = expert_ffn(li, lp, h2)
            x = x + y
            esel.append(eids)
    x = mlayers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (transformer.logits_last(params, cfg, x), sel0,
            torch.stack(esel) if esel else None)


def paged_prefill(cfg: ArchConfig, params: dict, layer_params: list,
                  pools: tuple, tokens: np.ndarray, start: int,
                  t_valid: int, bt: np.ndarray, attend,
                  kernel: str = "cuda") -> torch.Tensor:
    """One chunk of one request's prompt: ``t_valid <= len(tokens)``
    tokens from absolute position ``start``.  K/V go into the pools (in
    place) through the block table ``bt`` [NL], the touched pages'
    summaries are recomputed, and attention is causal over the
    block-table-gathered context.  An MoE config runs the capacity
    dispatch here whatever the engine's expert pool, as the reference's
    prefill does, through ``kernel``'s route.  Returns the float32
    logits [V] of the chunk's last valid token."""
    k_pool, v_pool, s_pool = pools
    dev = k_pool.device
    page = cfg.kv_page
    nl = bt.shape[0]
    c = tokens.shape[0]
    ntp = c // page + 2                     # touched-page bound per chunk
    pos = start + np.arange(c)
    lp_w = np.clip(pos // page, 0, nl - 1)
    phys_w = np.where(np.arange(c) < t_valid, bt[lp_w], 0)
    end = start + t_valid
    lps = start // page + np.arange(ntp)
    phys_s = np.where(lps <= (end - 1) // page,
                      bt[np.clip(lps, 0, nl - 1)], 0)
    cnts = np.clip(end - lps * page, 1, page)
    host = np.concatenate([tokens, pos, phys_w, pos % page, phys_s, cnts,
                           bt]).astype(np.int64)
    t = torch.from_numpy(host).to(dev)
    tok_t, pos_t, phys_w_t, off_t = t[:4 * c].view(4, c).unbind(0)
    phys_s_t, cnts_t = t[4 * c:4 * c + 2 * ntp].view(2, ntp).unbind(0)
    bt_t = t[4 * c + 2 * ntp:]
    kv, hd = cfg.n_kv_heads, cfg.hd
    x = transformer.embed(params, cfg, tok_t[None])        # [1,C,D]
    for li, lp in enumerate(layer_params):
        kp, vp, sp = k_pool[li], v_pool[li], s_pool[li]
        h = mlayers.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = mlayers.gqa_project(h, lp, cfg)
        q = mlayers.apply_rope(q, pos_t[None], cfg.rope_theta)
        k_new = mlayers.apply_rope(k_new, pos_t[None], cfg.rope_theta)
        kp.index_put_((phys_w_t, off_t),
                      sparse_attention.kv_quant(k_new[0], kp.dtype))
        vp.index_put_((phys_w_t, off_t),
                      sparse_attention.kv_quant(v_new[0], vp.dtype))
        sp.index_put_((phys_s_t,), sparse_attention.page_summary_from_pool(
            kp, phys_s_t, cnts_t))
        # the block table linearises the request's pages back into
        # logical order, so positions align with q_offset=start
        kctx = kp[bt_t].reshape(1, nl * page, kv, hd)
        vctx = vp[bt_t].reshape(1, nl * page, kv, hd)
        o = attend(q, kctx, vctx, start, min(1024, nl * page),
                   cfg.logit_softcap)
        x = x + mlayers.attn_out(o, lp)
        h2 = mlayers.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + transformer.ffn(h2, lp, cfg, kernel=kernel)
    x = mlayers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return transformer.logits_last(params, cfg,
                                   x[:, t_valid - 1:t_valid])[0]


def _decode_attend(kernel: str):
    if kernel == "cuda":
        return lambda phys, idx, pos, q, kp, vp, page: paged_decode_attn(
            phys, idx, pos, q, kp, vp, page_size=page)
    return lambda phys, idx, pos, q, kp, vp, page: \
        sparse_attention.attend_pages_paged(q, kp, vp, idx, phys, pos, page)


class PagedEngine:
    """Continuous-batching serve engine on a paged KV allocator.

    ``submit()`` enqueues requests; ``step()`` runs one scheduler
    iteration (admission, prefill chunks, one ragged decode batch);
    ``run()`` drives an arrival workload to completion.

    * ``device`` — where weights, pools and compute live.  Defaults to
      the CUDA card and raises without one; ``"cpu"`` runs the plain
      PyTorch versions (the kernel wrappers dispatch on the tensors'
      device).
    * ``kernel="cuda" | "torch"`` — the attention and capacity-dispatch
      implementation: ``"cuda"`` calls the kernel wrappers, ``"torch"``
      the plain versions even on the card (for comparison).
    * ``prefix_cache`` — share whole prompt pages across requests
      (copy-on-write); logits are bitwise-identical either way.
    * ``row_bucketing`` — pad ragged decode batches to power-of-two row
      buckets (NULL block-table rows) instead of ``max_batch``.
    * ``expert_pool="off" | "dense" | "paged"`` (MoE configs) — the
      decode step's expert FFN: the capacity dispatch, or routed experts'
      weights read as row-tile pages (``expert_tile_rows`` rows each)
      from a dense view or through the block table; dense and paged are
      bitwise equal with ``kernel="torch"``.  ``expert_nsb_slots`` sizes
      the demand-LRU the expert pages are scored against.
    * ``attend_probe`` (attribute, default None) — a callable
      ``probe(layer, inputs)`` run after each decode layer's attention
      with that layer's inputs and output, for checks.
    * ``moe_probe`` (attribute, default None) — the same for the MoE
      kernels of ``expert_pool="paged"`` with ``kernel="cuda"``: called
      with the layer and the kernels' inputs and outputs.

    Arguments of the reference engine that later slices port raise
    ``NotImplementedError``.
    """

    def __init__(self, cfg: ArchConfig, params: dict, max_len: int = 64,
                 n_pages: int = 0, max_batch: int = 8, chunk: int = 16,
                 token_budget: int = 0, nsb_pages: int = 64,
                 prefix_cache: bool = True, kernel: str = "cuda",
                 row_bucketing: bool = True,
                 device: str | torch.device = "cuda",
                 mesh=None, runahead: str = "off", spill_pages: int = 0,
                 executor: str = "sync", expert_pool: str = "off",
                 expert_tile_rows: int = 32, expert_nsb_slots: int = 32,
                 expert_runahead: str = "off",
                 expert_runahead_pages: int = 16,
                 capture_trace: bool = False,
                 session_hold: bool = False) -> None:
        if mesh is not None:
            raise not_ported("mesh= (tensor parallelism)",
                             "6. Tensor parallelism")
        if runahead != "off":
            raise not_ported(f"runahead={runahead!r}",
                             "3. Online runahead staging")
        if spill_pages:
            raise not_ported("spill_pages (host spill tier)",
                             "4. Host spill tier")
        if executor != "sync":
            raise not_ported(f"executor={executor!r}",
                             "5. Async executor and multi-turn sessions")
        if capture_trace:
            raise not_ported("capture_trace (NVR simulator capture)",
                             "3. Online runahead staging")
        if session_hold:
            raise not_ported("session_hold",
                             "5. Async executor and multi-turn sessions")
        if cfg.family not in ("dense", "moe") or cfg.mrope_sections:
            raise NotImplementedError(
                "PagedEngine serves dense and MoE decoder-only configs")
        if not cfg.sparse_kv:
            raise NotImplementedError(
                "PagedEngine requires the sparse-KV decode path")
        if max_len % cfg.kv_page:
            raise ValueError("max_len must be a multiple of cfg.kv_page")
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got "
                             f"{kernel!r}")
        if expert_pool not in expert_pool_mod.MODES:
            raise ValueError(f"expert_pool must be one of "
                             f"{expert_pool_mod.MODES}, got {expert_pool!r}")
        if expert_pool != "off" and not cfg.n_experts:
            raise ValueError("expert_pool requires an MoE-family config "
                             f"(cfg {cfg.name!r} has n_experts=0)")
        if expert_runahead not in EXPERT_RUNAHEAD:
            raise ValueError(f"expert_runahead must be one of "
                             f"{EXPERT_RUNAHEAD}, got {expert_runahead!r}")
        if expert_runahead != "off":
            # expert_runahead_pages only bounds this stage's copies
            raise not_ported(f"expert_runahead={expert_runahead!r}",
                             "3. Online runahead staging")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        if cfg.n_experts:
            # one buffer behind the expert weights, which the expert
            # pool wraps (a copy only when the caller's were not packed)
            self.params["layers"] = pack_experts(self.params["layers"])
        self._layers = transformer.layer_params(self.params)
        self.max_len = max_len
        self.page = cfg.kv_page
        self.n_logical = max_len // self.page
        chunk = min(chunk, max_len)
        # pool default: every batch slot can hold a full-length request,
        # +1 for the reserved scratch page
        self.n_pages = n_pages or (1 + max_batch * self.n_logical)
        self.allocator = KVBlockAllocator(self.n_pages, self.page,
                                          prefix_cache=prefix_cache)
        self.kernel = kernel
        self._attend_decode = _decode_attend(kernel)
        self._attend_prefill = transformer.attention(kernel)
        self.attend_probe = None
        self.row_buckets = (scheduler_mod.row_buckets(max_batch)
                            if row_bucketing else ())
        self.scheduler = Scheduler(
            self.allocator, max_batch=max_batch, chunk=chunk,
            token_budget=token_budget or (max_batch + chunk),
            row_buckets=self.row_buckets)
        self.max_batch = max_batch
        self.chunk = chunk
        self.stats = PagedServeStats()
        self.hot = PageCache(nsb_pages)
        self._seen_pages: set[int] = set()
        kv_dt = (torch.int8 if cfg.kv_dtype == "int8"
                 else torch_dtype(cfg.param_dtype))
        self.pool_cfg = PagePoolConfig(
            n_pages=self.n_pages, page_tokens=self.page,
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, dtype_bytes=kv_dt.itemsize)
        # the per-page fetch size the NSB byte metrics charge: K+V of
        # one page in bf16, the production KV dtype (as the reference)
        self.stats.row_bytes = 2 * self.page * cfg.hd * 2
        shape = (cfg.n_layers, self.n_pages, self.page, cfg.n_kv_heads,
                 cfg.hd)
        self.k_pool = torch.zeros(shape, dtype=kv_dt, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=kv_dt, device=self.device)
        self.s_pool = torch.zeros(
            (cfg.n_layers, self.n_pages, cfg.n_kv_heads, cfg.hd),
            dtype=torch.float32, device=self.device)
        self.expert_pool_mode = expert_pool
        self.expert_runahead = expert_runahead
        self.ep = None
        self.ep_hot = None
        self.moe_probe = None
        if expert_pool != "off":
            self.ep = expert_pool_mod.ExpertPool(
                cfg, self.params, tile_rows=expert_tile_rows)
            self.ep_hot = PageCache(expert_nsb_slots)
            self._ep_rows = self.ep.dense_rows()
            self._ep_bt = self.ep.table_device()
        self.now = 0
        self._next_rid = 0
        self.requests: dict[int, Request] = {}

    @property
    def _pools(self) -> tuple:
        return self.k_pool, self.v_pool, self.s_pool

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               arrival: float | None = None) -> int:
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt+gen {len(prompt)}+{max_new_tokens} exceeds "
                f"max_len {self.max_len}")
        if not len(prompt) or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and >=1 new token")
        need = self.allocator.pages_for_tokens(len(prompt) + max_new_tokens)
        if need > self.allocator.capacity:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.allocator.capacity}: even a lone request could "
                "never finish (preemption cannot help)")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      arrival=self.now if arrival is None else arrival)
        self.requests[rid] = req
        self.scheduler.add(req)
        return rid

    def _finish_if_done(self, req: Request) -> None:
        if req.done:
            self.scheduler.finish(req, self.now)
            self.stats.finished += 1

    def _apply_cow_copies(self) -> None:
        """Replay the allocator's pending copy-on-write page copies onto
        the pools (K, V and summaries), before this iteration's prefill
        or decode reads the destination pages."""
        copies = self.allocator.drain_copies()
        if not copies:
            return
        src = torch.as_tensor([s for s, _ in copies], device=self.device)
        dst = torch.as_tensor([d for _, d in copies], device=self.device)
        for pool in self._pools:
            pool[:, dst] = pool[:, src]
        self.stats.cow_page_copies += len(copies)

    def _dispatch_prefill(self, job: PrefillJob) -> torch.Tensor:
        """Run one prefill chunk; return its (device) logits."""
        req = job.req
        toks = np.zeros((self.chunk,), dtype=np.int64)
        toks[: job.n_tokens] = req.prompt[job.start:job.start + job.n_tokens]
        bt = self.allocator.table_array(req.rid, self.n_logical)
        logits = paged_prefill(self.cfg, self.params, self._layers,
                               self._pools, toks, job.start, job.n_tokens,
                               bt, self._attend_prefill, self.kernel)
        req.computed += job.n_tokens
        # whole prompt pages materialised by this chunk become
        # attachable by later requests with the same prefix
        self.allocator.register_prefix(req.rid, req.prompt,
                                       min(req.computed, req.prompt_len))
        self.stats.prefill_tokens += job.n_tokens
        self.stats.prefill_calls += 1
        return logits

    def _commit_prefill(self, job: PrefillJob, logits) -> None:
        """Sample the first token when the chunk finished the prompt."""
        req = job.req
        if req.computed == req.prompt_len:
            lg = logits.cpu().numpy()
            # a preemption resume already holds its first token and
            # moves on to decode replay
            if not req.out_tokens:
                req.out_tokens.append(int(lg.argmax()))
                req.first_token_at = self.now
                req.last_token_at = self.now
                req.token_ticks.append(self.now)
                req.last_logits = lg
                self.stats.tokens_out += 1
                if req.resumed_at >= 0:
                    req.resume_gaps.append(self.now - req.resumed_at)
                    req.resumed_at = -1.0
                self._finish_if_done(req)

    def _run_prefill(self, job: PrefillJob) -> None:
        self._commit_prefill(job, self._dispatch_prefill(job))

    def _dispatch_decode(self, pairs: list, rb: int):
        """Run one decode batch over ``(row_slot, request)`` pairs padded
        to ``rb`` rows; return device ``(logits, layer-0 selection,
        routed expert ids or None)``.
        Empty slots carry token 0, position 0 and a NULL block table, so
        every write of theirs lands on the scratch page."""
        host = np.zeros((rb, 5 + self.n_logical), dtype=np.int64)
        for slot, req in pairs:
            bt = self.allocator.table_array(req.rid, self.n_logical)
            p = req.computed
            host[slot, :5] = (req.seq[p], p, bt[p // self.page],
                              p % self.page, p // self.page + 1)
            host[slot, 5:] = bt
        for slot in set(range(rb)) - {s for s, _ in pairs}:
            host[slot, 4] = 1                 # n_valid of a NULL row
        return paged_decode(self.cfg, self.params, self._layers,
                            self._pools, host, self._attend_decode,
                            self.attend_probe,
                            self._expert_ffn if self.ep else None,
                            self.kernel)

    def _expert_ffn(self, li: int, lp: dict, h: torch.Tensor):
        """The decode step's expert FFN of layer ``li`` from the pool."""
        if self.expert_pool_mode == "dense":
            return expert_pool_mod.dense_moe_ffn(h, lp, self._ep_rows[li],
                                                 self.cfg)
        probe = self.moe_probe
        return expert_pool_mod.paged_moe_ffn(
            h, lp, self._ep_bt[li], self.ep.pool, self.cfg,
            kernel=self.kernel,
            probe=None if probe is None else lambda x: probe(li, x))

    def _commit_decode(self, pairs: list, logits, sel0, rb: int,
                       esel=None) -> None:
        """Sample, advance frontiers and score NSB traffic, in plan
        order (finishes free pages through the allocator's LIFO free
        list, so the order is observable in later page ids)."""
        lg = logits.cpu().numpy()
        sel0 = sel0.cpu().numpy()                   # layer-0 [R,KV,K]
        for slot, req in pairs:
            frontier = req.computed == req.total_len - 1
            req.computed += 1
            self.stats.decode_tokens += 1
            if frontier:
                req.out_tokens.append(int(lg[slot].argmax()))
                req.last_logits = lg[slot].copy()
                req.last_token_at = self.now
                req.token_ticks.append(self.now)
                self.stats.tokens_out += 1
                if req.resumed_at >= 0:
                    req.resume_gaps.append(self.now - req.resumed_at)
                    req.resumed_at = -1.0
                self._finish_if_done(req)
        self.stats.decode_rows_padded += rb - len(pairs)
        # NSB accounting over the step's unique physical pages of the
        # occupied rows (NULL-padded selections never enter); np.unique
        # sorts, so the touch order depends on the page set alone
        occ = np.asarray([slot for slot, _ in pairs], dtype=np.int64)
        uniq = np.unique(sel0[occ])
        uniq = uniq[uniq != NULL_PAGE]
        self._seen_pages.update(int(p) for p in uniq)
        self.stats.pages_unique = len(self._seen_pages)
        for p in uniq:
            self.stats.pages_touched += 1
            if self.hot.touch(int(p)):
                self.stats.nsb_hits += 1
            else:
                self.stats.nsb_misses += 1
        if esel is not None:
            self._account_expert_pages(esel.cpu().numpy(), occ)

    def _account_expert_pages(self, es: np.ndarray, occ: np.ndarray) -> None:
        """Expert-tile demand accounting for one committed decode step.

        ``es`` is the step's routed expert ids [L, R, top_k].  Every
        routed (row, layer, expert) demands the expert's full tile range
        (3 planes x NT pages); the step's unique pages (np.unique sorts,
        so the touch order depends on the page set alone) are scored
        against the demand-LRU.  The reference also records them per
        request for its capture and runahead predictor, which come with
        a later slice."""
        ep = self.ep
        uniq = np.unique(np.concatenate(
            [ep.pages_for_experts(li, es[li, occ])
             for li in range(ep.n_layers)]))
        for p in uniq:
            self.stats.expert_pages_touched += 1
            if self.ep_hot.touch(int(p)):
                self.stats.expert_nsb_hits += 1
            else:
                self.stats.expert_nsb_misses += 1

    def _run_decode(self, rows: list, bucket: int = 0) -> None:
        rb = bucket or self.max_batch
        pairs = list(enumerate(rows))
        logits, sel0, esel = self._dispatch_decode(pairs, rb)
        self._commit_decode(pairs, logits, sel0, rb, esel)

    # -- iteration loop ------------------------------------------------------

    def step(self) -> int:
        """One scheduler iteration; returns the scheduled token count."""
        self.now += 1
        self.stats.iterations += 1
        plan = self.scheduler.schedule(self.now)
        self._apply_cow_copies()
        for job in plan.prefill:
            self._run_prefill(job)
        if plan.decode:
            self._run_decode(plan.decode, plan.decode_bucket)
            self.stats.steps += 1
        n_p, n_d = len(plan.prefill), len(plan.decode)
        self.stats.prefill_iterations += bool(n_p)
        self.stats.decode_iterations += bool(n_d)
        self.stats.overlap_iterations += bool(n_p and n_d)
        self.stats.iter_log.append((n_p, n_d))
        self.stats.preemptions = self.scheduler.n_preemptions
        return plan.n_tokens

    def run(self, workload=None, max_iters: int = 100000) -> dict:
        """Drive ``(tick, prompt, max_new_tokens)`` arrivals to
        completion; returns the request table."""
        pending = deque(sorted(workload or [], key=lambda w: w[0]))
        while pending or self.scheduler.has_work:
            if max_iters <= 0:
                raise RuntimeError("run() exceeded max_iters")
            max_iters -= 1
            while pending and pending[0][0] <= self.now:
                tick, prompt, max_new = pending.popleft()
                self.submit(prompt, max_new, arrival=tick)
            self.step()
        return self.requests

    # -- reporting -----------------------------------------------------------

    def metrics(self) -> dict:
        done = [r for r in self.requests.values() if r.finished_at >= 0]
        lat = [x for x in (r.latency() for r in done) if x is not None]
        ttft = [x for x in (r.ttft() for r in done) if x is not None]
        tpot = [x for x in (r.tpot() for r in done) if x is not None]
        st = self.stats
        return {
            "n_finished": len(done),
            "iterations": st.iterations,
            "tokens_out": st.tokens_out,
            "p50_latency": percentile(lat, 0.50),
            "p99_latency": percentile(lat, 0.99),
            "p50_ttft": percentile(ttft, 0.50),
            "p99_ttft": percentile(ttft, 0.99),
            "p50_tpot": percentile(tpot, 0.50),
            "p99_tpot": percentile(tpot, 0.99),
            "executor": "sync",
            "kernel": self.kernel,
            "device": str(self.device),
            "prefill_iterations": st.prefill_iterations,
            "decode_iterations": st.decode_iterations,
            "overlap_iterations": st.overlap_iterations,
            "decode_steps": st.steps,
            "prefill_calls": st.prefill_calls,
            "nsb_hot_hit_rate": st.hot_hit_rate,
            "offchip_fetch_reduction": st.offchip_reduction,
            "preemptions": st.preemptions,
            "pages_peak_in_use": self.allocator.stats.peak_in_use,
            "kv_pool_mib": self.pool_cfg.pool_bytes / 2 ** 20,
            "prefill_tokens_run": st.prefill_tokens,
            "prefill_tokens_skipped": self.scheduler.prefill_tokens_skipped,
            "prefix_hit_pages": self.allocator.stats.prefix_hits,
            "prefix_evictions": self.allocator.stats.prefix_evictions,
            "cow_copies": self.allocator.stats.cow_copies,
            "decode_rows_padded": st.decode_rows_padded,
            "expert_pool": self.expert_pool_mode,
            **self._expert_metrics(),
        }

    def _expert_metrics(self) -> dict:
        if self.ep is None:
            return {}
        return {
            "expert_pool_pages": self.ep.n_pages,
            "expert_pool_mib": self.ep.pool_bytes / 2 ** 20,
            "expert_tile_rows": self.ep.tile_rows,
            "expert_pages_touched": self.stats.expert_pages_touched,
            "expert_nsb_hit_rate": self.stats.expert_hot_hit_rate,
            # without the staging tier the hit rate is the demand-LRU's
            "expert_demand_lru_hit_rate": self.ep_hot.hit_rate,
            "expert_runahead_mode": self.expert_runahead,
        }


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: (_to_device(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in tree.items()}
