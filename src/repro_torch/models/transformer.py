"""Decoder pieces the paged serve path shares: the embedding lookup, the
SwiGLU/GeGLU/GELU feed-forward (or the MoE capacity dispatch of
:mod:`.moe` for MoE configs) and the float32 last-token logits.  The
large products are plain ``torch.matmul``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..params import torch_dtype
from . import moe

Params = dict


def embed(params: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids [...] -> embeddings [..., d_model] in the param dtype."""
    x = params["embed"][tokens].to(torch_dtype(cfg.param_dtype))
    if getattr(cfg, "scale_embed", False):
        x = x * (cfg.d_model ** 0.5)
    return x


def ffn(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """The feed-forward block on [B, S, D]: dense, or the MoE capacity
    dispatch for MoE configs (the reference's ``transformer._ffn``)."""
    if cfg.n_experts:
        return moe.moe_ffn(x, p, cfg)
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
