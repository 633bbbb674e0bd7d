"""Uniform model API of the single-batch engine: prefill, cache and
decode entry points per model family (the reference's ``models/api.py``).

The dense and MoE decoder families run :mod:`.transformer`; the ssm,
hybrid, encdec and vlm families are a later slice of the port and raise.
"""

from __future__ import annotations

import torch

from ..serve import not_ported
from . import transformer

FAMILIES = ("dense", "moe")


def check_family(cfg) -> None:
    """Raise for a model family the port does not run yet."""
    if cfg.family not in FAMILIES or cfg.mrope_sections:
        raise not_ported(f"the {cfg.family} model family ({cfg.name})",
                         "7. The single-batch Engine and the other model "
                         "families")


def prefill_fn(cfg, params: dict, batch: dict, *, max_len: int | None = None,
               kernel: str = "cuda", layers: list | None = None):
    """batch ``{"tokens": [B, S]}`` -> (last logits [B, V], cache of
    ``max_len`` positions)."""
    check_family(cfg)
    return transformer.prefill(params, cfg, batch["tokens"],
                               max_len=max_len, kernel=kernel, layers=layers)


def init_cache(cfg, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    check_family(cfg)
    return transformer.init_cache(cfg, batch, max_len, device=device)


def decode_fn(cfg, params: dict, cache: dict, token: torch.Tensor, *,
              sparse: bool | None = None, kernel: str = "cuda",
              layers: list | None = None, probe=None):
    """token [B] -> (logits [B, V], cache), the cache updated in place."""
    check_family(cfg)
    return transformer.decode_step(params, cfg, cache, token, sparse=sparse,
                                   kernel=kernel, layers=layers, probe=probe)
