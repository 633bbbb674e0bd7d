"""Dense and MoE decoder-only transformer: the port of the reference's
``models/transformer.py`` forward, prefill, KV cache and decode step.

Weights are the nested dicts of :mod:`..params` with a stacked ``[L,
...]`` layer axis; a Python loop over :func:`layer_params` stands in for
the reference's ``scan``.  The embedding lookup is the ``gather_rows``
kernel (its plain version on the CPU) on every path.  Attention runs the
port's kernels with ``kernel="cuda"`` (the wrappers run their plain
versions for CPU tensors) or the plain versions everywhere with
``kernel="torch"``:

* prefill: causal ``flash_prefill`` at ``q_offset=0``, plain
  ``layers.chunked_attention``;
* sparse decode: TopK pages from the label cache, then
  ``sparse_decode_attn`` with the frontier ``pos``, plain
  ``sparse_attention.attend_pages_full``;
* dense decode: ``flash_prefill`` with one query row at
  ``q_offset=pos`` over the layer's whole cache, plain
  ``chunked_attention`` with the same arguments.

The MoE feed-forward's expert products run ``moe_dispatch_matmul`` with
``kernel="cuda"`` and ``torch.matmul`` with ``kernel="torch"``.

The cache is a dict ``{"k", "v": [L, B, max_len, KV, D], "pos": int,
"kpage": [L, B, max_len / page, KV, D] float32}`` (``kpage`` for
sparse-KV configs), allocated at its full length once.  Unlike the
reference, whose arrays are immutable, :func:`decode_step` writes the new
K/V row and the page summary in place, and ``pos`` is a host int: the
batch decodes in lockstep, so no step reads a position from the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.flash_prefill import flash_prefill
from ..kernels.gather_rows import gather_rows
from ..kernels.sparse_decode_attn import sparse_decode_attn
from ..params import torch_dtype
from . import layers as mlayers
from . import moe, sparse_attention

Params = dict


def embed(params: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids [...] -> embeddings [..., d_model] in the param dtype,
    through the ``gather_rows`` kernel."""
    table = params["embed"]
    rows = gather_rows(tokens.reshape(-1).contiguous(), table)
    x = rows.reshape(*tokens.shape, table.shape[-1]).to(
        torch_dtype(cfg.param_dtype))
    if getattr(cfg, "scale_embed", False):
        x = x * (cfg.d_model ** 0.5)
    return x


def ffn(x: torch.Tensor, p: Params, cfg, *,
        kernel: str = "cuda") -> torch.Tensor:
    """The feed-forward block on [B, S, D]: dense, or the MoE capacity
    dispatch for MoE configs (the reference's ``transformer._ffn``),
    whose expert products run the ``moe_dispatch_matmul`` kernel with
    ``kernel="cuda"``."""
    if cfg.n_experts:
        return moe.moe_ffn(x, p, cfg, kernel=kernel)
    h = torch.matmul(x, p["wi"].to(x.dtype))
    if cfg.act in ("swiglu", "geglu"):
        g = torch.matmul(x, p["wg"].to(x.dtype))
        # the reference's jax.nn.gelu is the tanh approximation
        g = (F.silu(g) if cfg.act == "swiglu"
             else F.gelu(g, approximate="tanh"))
        h = g * h
    elif cfg.act == "gelu":
        h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, p["wo_mlp"].to(x.dtype))


def logits_last(params: Params, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """float32 logits of the last position: hidden [B, S, D] -> [B, V]."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(hidden[:, -1].float(), head.float())


def layer_params(params: Params) -> list[dict]:
    """One dict of views per layer of the stacked ``params["layers"]``."""
    stacked = params["layers"]
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[li] for k, v in stacked.items()} for li in range(n)]


def attention(kernel: str):
    """Causal attention ``(q, k, v, q_offset, chunk, softcap)`` with
    query row i at position ``q_offset + i``: the ``flash_prefill``
    kernel (``kernel="cuda"``) or its plain version, whose KV chunk is
    ``chunk``."""
    if kernel == "cuda":
        return lambda q, k, v, off, chunk, softcap: flash_prefill(
            q, k, v, q_offset=off, causal=True, chunk=chunk,
            logit_softcap=softcap)
    return lambda q, k, v, off, chunk, softcap: mlayers.chunked_attention(
        q, k, v, causal=True, q_offset=off, chunk=chunk,
        logit_softcap=softcap)


def layer_fwd(cfg, x: torch.Tensor, p: Params, pos: torch.Tensor, *,
              kernel: str = "cuda"):
    """One decoder layer on [B, S, D] at positions ``pos`` [1, S];
    returns (x, k, v) with this layer's K/V [B, S, KV, D] (roped, in the
    param dtype)."""
    h = mlayers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = mlayers.gqa_project(h, p, cfg)
    q = mlayers.apply_rope(q, pos, cfg.rope_theta)
    k = mlayers.apply_rope(k, pos, cfg.rope_theta)
    o = attention(kernel)(q, k, v, 0, 1024, cfg.logit_softcap)
    x = x + mlayers.attn_out(o, p)
    h2 = mlayers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn(h2, p, cfg, kernel=kernel), k, v


def forward(params: Params, cfg, tokens: torch.Tensor, *, collect_kv=None,
            kernel: str = "cuda", layers: list | None = None) -> torch.Tensor:
    """Run the stack on tokens [B, S]; returns the final-normed hidden
    [B, S, D].  ``collect_kv(layer, k, v)``, when given, receives each
    layer's K/V as it is computed (the reference stacks them; prefill
    writes them straight into its cache instead)."""
    x = embed(params, cfg, tokens)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    for li, lp in enumerate(layers or layer_params(params)):
        x, k, v = layer_fwd(cfg, x, lp, pos, kernel=kernel)
        if collect_kv is not None:
            collect_kv(li, k, v)
    return mlayers.rms_norm(x, params["ln_f"], cfg.norm_eps)


# -- KV cache -----------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device: str | torch.device = "cuda") -> dict:
    """A zeroed cache of ``max_len`` positions at ``pos`` 0 (int8 K/V for
    ``kv_dtype="int8"`` configs, else the param dtype)."""
    dev = resolve_device(device)
    dt = dtype or (torch.int8 if cfg.kv_dtype == "int8"
                   else torch_dtype(cfg.param_dtype))
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}
    if cfg.sparse_kv:
        cache["kpage"] = torch.zeros(
            (cfg.n_layers, batch, max_len // cfg.kv_page, cfg.n_kv_heads,
             cfg.hd), dtype=torch.float32, device=dev)
    return cache


def _put_kv(cfg, cache: dict, li: int, k: torch.Tensor,
            v: torch.Tensor) -> None:
    """Write one layer's prompt K/V [B, S, KV, D] at positions 0..S-1
    (quantised to the cache dtype) and its page summaries: the float32
    mean of each page's unquantised keys."""
    b, s, kv, hd = k.shape
    cache["k"][li, :, :s] = sparse_attention.kv_quant(k, cache["k"].dtype)
    cache["v"][li, :, :s] = sparse_attention.kv_quant(v, cache["v"].dtype)
    if "kpage" in cache:
        pg = cfg.kv_page
        cache["kpage"][li, :, :s // pg] = k.float().reshape(
            b, s // pg, pg, kv, hd).mean(dim=2)


def _check_prompt(cfg, s: int, max_len: int) -> None:
    if cfg.sparse_kv and s % cfg.kv_page:
        raise ValueError(f"prompt length {s} is not a multiple of kv_page "
                         f"{cfg.kv_page}: its pages cannot be summarised")
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")


def make_cache(cfg, k: torch.Tensor, v: torch.Tensor, pos: int,
               max_len: int | None = None) -> dict:
    """A cache from stacked prefill K/V [L, B, S, KV, D]: page summaries
    by pooling, K/V int8-quantised for int8 configs, zeros from S up to
    ``max_len`` (default S)."""
    l, b, s = k.shape[:3]
    _check_prompt(cfg, s, max_len or s)
    cache = init_cache(cfg, b, max_len or s,
                       dtype=None if cfg.kv_dtype == "int8" else k.dtype,
                       device=k.device)
    for li in range(l):
        _put_kv(cfg, cache, li, k[li], v[li])
    cache["pos"] = int(pos)
    return cache


def prefill(params: Params, cfg, tokens: torch.Tensor, *,
            max_len: int | None = None, kernel: str = "cuda",
            layers: list | None = None):
    """Forward pass over tokens [B, S] that fills a cache of ``max_len``
    positions (default S) layer by layer.  Returns (last-token float32
    logits [B, V], cache at ``pos`` S)."""
    b, s = tokens.shape
    max_len = max_len or s
    _check_prompt(cfg, s, max_len)
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    hidden = forward(params, cfg, tokens,
                     collect_kv=lambda li, k, v: _put_kv(cfg, cache, li, k, v),
                     kernel=kernel, layers=layers)
    cache["pos"] = s
    return logits_last(params, cfg, hidden), cache


# -- decode -------------------------------------------------------------------

def decode_step(params: Params, cfg, cache: dict, token: torch.Tensor, *,
                sparse: bool | None = None, kernel: str = "cuda",
                layers: list | None = None, probe=None):
    """One lockstep decode step: token [B] at ``cache["pos"]`` ->
    (float32 logits [B, V], cache).  The cache is updated in place and
    its ``pos`` advanced.  ``probe(layer, inputs)``, when given, runs
    after each sparse layer's attention with its inputs and output."""
    use_sparse = cfg.sparse_kv if sparse is None else sparse
    k_full, v_full = cache["k"], cache["v"]
    max_len = k_full.shape[2]
    pos = int(cache["pos"])
    if pos >= max_len:
        raise ValueError(f"the cache is full: pos {pos} = max_len {max_len}")
    x = embed(params, cfg, token[:, None])                 # [B,1,D]
    b = x.shape[0]
    kv, hd, page = cfg.n_kv_heads, cfg.hd, cfg.kv_page
    g = cfg.n_heads // kv
    pos_arr = torch.full((1, 1), pos, device=x.device)
    kpage = cache.get("kpage")
    if use_sparse and kpage is None:
        kpage = torch.zeros((cfg.n_layers, b, max_len // page, kv, hd),
                            dtype=torch.float32, device=x.device)
    k_pages = min(cfg.kv_topk_pages, max_len // page)
    attend = attention(kernel)
    for li, lp in enumerate(layers or layer_params(params)):
        h = mlayers.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = mlayers.gqa_project(h, lp, cfg)
        q = mlayers.apply_rope(q, pos_arr, cfg.rope_theta)
        k_new = mlayers.apply_rope(k_new, pos_arr, cfg.rope_theta)
        # the row at pos of the stacked caches, in place: no cache copy
        k_full[li, :, pos] = sparse_attention.kv_quant(k_new[:, 0],
                                                       k_full.dtype)
        v_full[li, :, pos] = sparse_attention.kv_quant(v_new[:, 0],
                                                       v_full.dtype)
        if use_sparse:
            qh = q.reshape(b, kv, g, hd)
            kp_li = sparse_attention.update_page_summary(kpage[li], k_new,
                                                         pos, page)
            idx = sparse_attention.select_pages(qh, kp_li, pos // page + 1,
                                                k_pages)
            if kernel == "cuda":
                o = sparse_decode_attn(idx, qh, k_full[li], v_full[li],
                                       page_size=page, pos=pos)
            else:
                o = sparse_attention.attend_pages_full(
                    qh, k_full, v_full, li, idx, pos, page)
            if probe is not None:
                probe(li, {"q": qh, "k": k_full[li], "v": v_full[li],
                           "idx": idx, "pos": pos, "kpage": kp_li,
                           "out": o})
            o = o.reshape(b, 1, cfg.n_heads, hd)
        else:
            o = attend(q, k_full[li], v_full[li], pos, min(4096, max_len),
                       cfg.logit_softcap)
        x = x + mlayers.attn_out(o, lp)
        h2 = mlayers.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn(h2, lp, cfg, kernel=kernel)
    x = mlayers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return logits_last(params, cfg, x), cache
