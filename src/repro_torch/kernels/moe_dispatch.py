"""Paged expert-tile GEMVs of the MoE decode step: the CUDA kernels and
their dispatch.

Replaces the TPU kernels ``src/repro/kernels/moe_dispatch.py``
``moe_paged_gateup`` (``_gateup_kernel``) and ``moe_paged_down``
(``_down_kernel``).  The kernel source is ``csrc/moe_dispatch.cu``,
whose header says what bounds them on the H100 and what their design
does about that.  The plain versions beside them copy the reference's
oracles ``kernels/ref.py::moe_paged_*_ref``: gather the routed tiles,
contract in float32, cast back.

Each wrapper runs its plain version for tensors on the CPU and launches
its CUDA kernel for tensors on a card; there is no fallback between the
two.  ``moe_paged_gateup.launches`` and ``moe_paged_down.launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import Q_CODES

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"moe_paged_gateup": [_P] * 4 + [_I] * 7 + [_P],
               "moe_paged_down": [_P] * 4 + [_I] * 7 + [_P]}


def _gather(pids: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """The routed tiles as float32 [R, K, NT*TF, D]."""
    r, k, _ = pids.shape
    w = pool[pids.long()]                       # [R,K,NT,TF,D]
    return w.reshape(r, k, -1, w.shape[-1]).float()


def moe_paged_gateup_plain(pids: torch.Tensor, x: torch.Tensor,
                           pool: torch.Tensor) -> torch.Tensor:
    """pids int32 [R, K, NT]; x [R, D]; pool [P, TF, D] ->
    [R, K, NT*TF] in x's dtype: ``x @ W_plane^T`` per routed expert."""
    return torch.einsum("rd,rkfd->rkf", x.float(),
                        _gather(pids, pool)).to(x.dtype)


def moe_paged_down_plain(pids: torch.Tensor, h: torch.Tensor,
                         pool: torch.Tensor) -> torch.Tensor:
    """pids int32 [R, K, NT]; h [R, K, NT*TF]; pool [P, TF, D] ->
    [R, K, D] in h's dtype, contracting over the paged dimension."""
    return torch.einsum("rkf,rkfd->rkd", h.float(),
                        _gather(pids, pool)).to(h.dtype)


def _launch(name: str, pids: torch.Tensor, a: torch.Tensor,
            pool: torch.Tensor, out_shape: tuple) -> torch.Tensor:
    """Check the inputs of either kernel and launch it; ``a`` is x or h."""
    if a.dtype not in Q_CODES or pool.dtype != a.dtype:
        raise TypeError(f"{name} takes {'/'.join(map(str, Q_CODES))} "
                        f"activations and pool of one dtype, got {a.dtype} "
                        f"and {pool.dtype}")
    if pids.dtype != torch.int32:
        raise TypeError(f"{name}: pids must be int32, got {pids.dtype}")
    tensors = (pids, a, pool)
    if any(t.device != a.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    r, k, nt = pids.shape
    _, tf, d = pool.shape
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    per_vec = 16 // a.element_size()
    vec = int(d % per_vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (a, pool)))
    lib = _build.load("moe_dispatch", _SIGNATURES)
    code = getattr(lib, name)(
        *(_build.ptr(t) for t in tensors), _build.ptr(out), r, k, nt, tf, d,
        Q_CODES[a.dtype], vec, _build.stream_ptr(a.device))
    _build.check(code, name)
    return out


def moe_paged_gateup(pids: torch.Tensor, x: torch.Tensor,
                     pool: torch.Tensor) -> torch.Tensor:
    """Paged expert projection into the FFN hidden dim (gate or up).

    pids int32 [R, K, NT]: the physical pages of one plane of each
    routed expert, in tile order; x [R, D]; pool [P, TF, D] (float32 or
    bfloat16, x's dtype).  Returns [R, K, NT*TF] in x's dtype."""
    if not x.is_cuda:
        return moe_paged_gateup_plain(pids, x, pool)
    r, k, nt = pids.shape
    if x.dim() != 2 or x.shape[0] != r or pool.dim() != 3 \
            or pool.shape[2] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and pool {tuple(pool.shape)} "
                         f"do not fit pids {tuple(pids.shape)}")
    out = _launch("moe_paged_gateup", pids, x, pool,
                  (r, k, nt * pool.shape[1]))
    moe_paged_gateup.launches += 1
    return out


def moe_paged_down(pids: torch.Tensor, h: torch.Tensor,
                   pool: torch.Tensor) -> torch.Tensor:
    """Paged expert projection back to the model dim (down).

    pids int32 [R, K, NT] of the down plane; h [R, K, NT*TF] the gated
    hidden activations; pool [P, TF, D] in h's dtype.  Returns
    [R, K, D] in h's dtype."""
    if not h.is_cuda:
        return moe_paged_down_plain(pids, h, pool)
    r, k, nt = pids.shape
    if pool.dim() != 3 or h.shape != (r, k, nt * pool.shape[1]):
        raise ValueError(f"h {tuple(h.shape)} and pool {tuple(pool.shape)} "
                         f"do not fit pids {tuple(pids.shape)}")
    out = _launch("moe_paged_down", pids, h, pool, (r, k, pool.shape[2]))
    moe_paged_down.launches += 1
    return out


moe_paged_gateup.launches = 0
moe_paged_down.launches = 0
