"""Dense decoder weights as nested dicts of torch tensors.

Same keys and the same stacked ``[L, ...]`` layer axis as the JAX
reference's ``models/transformer.py::init_params``: ``embed``, ``ln_f``,
``lm_head`` (untied embeddings only) and, under ``layers``, ``ln1``,
``ln2``, ``wq``/``wk``/``wv``/``wo``, ``bq``/``bk``/``bv`` (QKV bias
configs) and ``wi``/``wg``/``wo_mlp``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

Params = dict

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.param_dtype`` / ``cfg.kv_dtype`` string -> torch dtype."""
    return _TORCH_DTYPES[str(name)]


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))       # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax(np_params: Params, device: str | torch.device = "cuda",
             dtype: torch.dtype | None = None) -> Params:
    """Convert the reference's ``init_params`` pytree, given as numpy
    arrays, into torch tensors with the same keys and layer axis.

    ``dtype`` casts every weight except the ``ln*`` norms, which the
    reference keeps in float32 whatever the parameter dtype."""
    dev = resolve_device(device)

    def conv(tree):
        return {k: (conv(v) if isinstance(v, dict) else _to_tensor(
            v, dev, None if k.startswith("ln") else dtype))
            for k, v in tree.items()}
    return conv(np_params)


def init_params(cfg, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Random weights at the config's width, made on ``device``.

    Matches the reference's shapes and initialisation scheme: dense
    weights are normal with std ``fan_in ** -0.5`` (embeddings 0.02),
    norms and biases start at zero.  ``generator`` must live on
    ``device``; the numbers differ from ``jax.random``'s for the same
    seed (tests that compare with the reference use :func:`from_jax`)."""
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE weights belong to the MoE slice of the port")
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)
    d, hd, nl = cfg.d_model, cfg.hd, cfg.n_layers

    def dense(shape, scale=None):
        s = scale if scale is not None else shape[-2] ** -0.5
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * s).to(dt)

    def zeros(shape, dtype):
        return torch.zeros(shape, device=dev, dtype=dtype)

    layers = {
        "ln1": zeros((nl, d), torch.float32),
        "ln2": zeros((nl, d), torch.float32),
        "wq": dense((nl, d, cfg.n_heads * hd)),
        "wk": dense((nl, d, cfg.n_kv_heads * hd)),
        "wv": dense((nl, d, cfg.n_kv_heads * hd)),
        "wo": dense((nl, cfg.n_heads * hd, d)),
    }
    if cfg.qkv_bias:
        layers["bq"] = zeros((nl, cfg.n_heads * hd), dt)
        layers["bk"] = zeros((nl, cfg.n_kv_heads * hd), dt)
        layers["bv"] = zeros((nl, cfg.n_kv_heads * hd), dt)
    layers["wi"] = dense((nl, d, cfg.d_ff))
    if cfg.act in ("swiglu", "geglu"):
        layers["wg"] = dense((nl, d, cfg.d_ff))
    layers["wo_mlp"] = dense((nl, cfg.d_ff, d))
    params = {"embed": dense((cfg.vocab, d), 0.02), "layers": layers,
              "ln_f": zeros((d,), torch.float32)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab))
    return params
