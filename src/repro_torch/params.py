"""Decoder weights as nested dicts of torch tensors.

Same keys and the same stacked ``[L, ...]`` layer axis as the JAX
reference's ``models/transformer.py::init_params``: ``embed``, ``ln_f``,
``lm_head`` (untied embeddings only) and, under ``layers``, ``ln1``,
``ln2``, ``wq``/``wk``/``wv``/``wo``, ``bq``/``bk``/``bv`` (QKV bias
configs) and either ``wi``/``wg``/``wo_mlp`` (dense) or the MoE
``router`` [L, D, E] (float32 whatever the parameter dtype, as the
reference's ``models/moe.py::init_moe``) with ``we_gate``/``we_up``
[L, E, D, F] and ``we_down`` [L, E, F, D].

Packed expert weights: the three expert planes are views of one buffer
of rows ``[F + L*E*3*F, D]`` (:func:`pack_experts`).  Its first ``F``
rows are zeros; the rest is ``[L, E, 3, F, D]`` with gate and up
transposed to ``[F, D]`` — exactly the demand region of the paged
expert pool (``serve/expert_pool.py``), which wraps the buffer without a
copy, with its zero scratch page 0 cut from the leading zero rows.  At
full width the experts are most of the card's memory, so a second copy
must never exist.
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

    ``dtype`` casts every weight except the ``ln*`` norms and the MoE
    ``router``, which the reference keeps in float32 whatever the
    parameter dtype (its routing runs in float32 on that weight).
    Expert weights come back packed (:func:`pack_experts`)."""
    dev = resolve_device(device)

    def conv(tree):
        return {k: (conv(v) if isinstance(v, dict) else _to_tensor(
            v, dev, None if k == "router" or k.startswith("ln")
            else dtype))
            for k, v in tree.items()}
    params = conv(np_params)
    if "we_gate" in params["layers"]:
        params["layers"] = pack_experts(params["layers"])
    return params


def _expert_buffer(n_layers: int, n_experts: int, d_ff: int, d: int,
                   dtype: torch.dtype, device) -> torch.Tensor:
    """Zeroed packed expert rows ``[F + L*E*3*F, D]``."""
    return torch.zeros((d_ff * (1 + n_layers * n_experts * 3), d),
                       dtype=dtype, device=device)


def _expert_views(rows: torch.Tensor, n_layers: int, n_experts: int,
                  d_ff: int) -> dict:
    """``we_gate``/``we_up`` [L, E, D, F] and ``we_down`` [L, E, F, D] as
    views of the packed rows."""
    d = rows.shape[-1]
    planes = rows[d_ff:].view(n_layers, n_experts, 3, d_ff, d)
    return {"we_gate": planes[:, :, 0].transpose(-1, -2),
            "we_up": planes[:, :, 1].transpose(-1, -2),
            "we_down": planes[:, :, 2]}


def expert_rows(layers: Params) -> torch.Tensor | None:
    """The packed rows ``[F + L*E*3*F, D]`` that ``layers``' expert
    weights are views of, or None when they are not packed."""
    g, u, dn = layers["we_gate"], layers["we_up"], layers["we_down"]
    l, e, f, d = dn.shape
    base = g.storage_offset() - f * d
    n_rows = f * (1 + l * e * 3)
    if base < 0 or not (g.dtype == u.dtype == dn.dtype) or not (
            g.device == u.device == dn.device):
        return None
    ptr = dn.untyped_storage().data_ptr()
    if any(t.untyped_storage().data_ptr() != ptr for t in (g, u)):
        return None
    if (base + n_rows * d) * dn.element_size() > dn.untyped_storage().nbytes():
        return None
    rows = torch.as_strided(dn, (n_rows, d), (d, 1), base)
    want = _expert_views(rows, l, e, f)
    for k, t in (("we_gate", g), ("we_up", u), ("we_down", dn)):
        w = want[k]
        if (t.shape, t.stride(), t.storage_offset()) != (
                w.shape, w.stride(), w.storage_offset()):
            return None
    return rows


def pack_experts(layers: Params) -> Params:
    """``layers`` with its expert weights as views of one packed buffer.

    Already packed weights come back as they are; otherwise the three
    planes are copied once into a new buffer (on their device, in
    ``we_down``'s dtype) and the returned dict holds only the views."""
    if expert_rows(layers) is not None:
        return layers
    dn = layers["we_down"]
    l, e, f, d = dn.shape
    rows = _expert_buffer(l, e, f, d, dn.dtype, dn.device)
    views = _expert_views(rows, l, e, f)
    for k, v in views.items():
        v.copy_(layers[k])
    return {**layers, **views}


def init_params(cfg, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Random weights at the config's width, made on ``device``.

    Matches the reference's shapes and initialisation scheme: dense
    weights are normal with std ``fan_in ** -0.5`` (embeddings 0.02),
    norms and biases start at zero.  ``generator`` must live on
    ``device``; the numbers differ from ``jax.random``'s for the same
    seed (tests that compare with the reference use :func:`from_jax`).

    MoE configs get packed expert weights (:func:`pack_experts`), drawn
    straight into the buffer one (layer, plane) at a time, so the
    float32 draw never holds more than one plane of one layer."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)
    d, hd, nl = cfg.d_model, cfg.hd, cfg.n_layers

    def dense(shape, scale=None, dtype=dt):
        s = scale if scale is not None else shape[-2] ** -0.5
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * s).to(dtype)

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
    if cfg.n_experts:
        e, f = cfg.n_experts, cfg.d_ff_expert or cfg.d_ff
        layers["router"] = dense((nl, d, e), dtype=torch.float32)
        rows = _expert_buffer(nl, e, f, d, dt, dev)
        planes = rows[f:].view(nl, e, 3, f, d)
        for li in range(nl):
            # gate/up [D, F] draw transposed as [F, D] rows with their
            # fan-in d; down [F, D] with fan-in f
            for plane, fan_in in ((0, d), (1, d), (2, f)):
                planes[li, :, plane] = dense((e, f, d), fan_in ** -0.5)
        layers.update(_expert_views(rows, nl, e, f))
    else:
        layers["wi"] = dense((nl, d, cfg.d_ff))
        if cfg.act in ("swiglu", "geglu"):
            layers["wg"] = dense((nl, d, cfg.d_ff))
        layers["wo_mlp"] = dense((nl, cfg.d_ff, d))
    params = {"embed": dense((cfg.vocab, d), 0.02), "layers": layers,
              "ln_f": zeros((d,), torch.float32)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab))
    return params
