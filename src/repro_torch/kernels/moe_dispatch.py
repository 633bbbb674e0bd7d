"""The MoE expert GEMMs: the CUDA kernels and their dispatch.

* :func:`moe_dispatch_matmul`, the capacity dispatch's grouped GEMM
  (``models.moe.moe_ffn``'s three expert products), replaces the TPU
  kernel ``src/repro/kernels/moe_dispatch.py`` ``moe_dispatch_matmul``
  (``_moe_kernel``).  Its plain version copies the reference's oracle
  ``kernels/ref.py::moe_dispatch_matmul_ref`` (float32 contraction, cast
  to x's dtype), one expert at a time.  Its bfloat16 route cuts the runs
  of equal group id into tiles of one expert each on the card;
  :func:`dispatch_tiles_plain` is that list's contract.
* :func:`moe_paged_gateup` and :func:`moe_paged_down`, the paged
  expert-tile GEMVs of the MoE decode step, replace ``moe_paged_gateup``
  (``_gateup_kernel``) and ``moe_paged_down`` (``_down_kernel``).  Their
  plain versions copy ``kernels/ref.py::moe_paged_*_ref``: gather the
  routed tiles, contract in float32, cast back.

The kernel source is ``csrc/moe_dispatch.cu``, whose header says what
bounds each kernel on the H100 and what its design does about that.
Each wrapper runs its plain version for tensors on the CPU and launches
its CUDA kernel for tensors on a card; there is no fallback between the
two.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import Q_CODES

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"moe_paged_gateup": [_P] * 4 + [_I] * 7 + [_P],
               "moe_paged_down": [_P] * 4 + [_I] * 7 + [_P],
               "moe_dispatch_matmul": [_P] * 6 + [_I] * 5 + [_L] * 3
               + [_I] * 2 + [_P],
               "moe_dispatch_tiles": [_P, _I, _I, _I, _P, _P, _P],
               "moe_dispatch_smem": []}

# rows of a bfloat16 tile of the grouped GEMM (two consumer warpgroups of
# 64; kBM in csrc/moe_dispatch.cu); a tile is 256 columns wide
TILE_ROWS = 128


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


def moe_dispatch_matmul_plain(group_ids: torch.Tensor, x: torch.Tensor,
                              w: torch.Tensor, *,
                              block_t: int) -> torch.Tensor:
    """group_ids int [T / block_t]; x [T, D]; w [E, D, F] -> [T, F] in
    x's dtype: each block of rows times its expert's weights, contracted
    in float32.  One expert at a time, so ``w[group_ids]`` is never
    made; ids outside [0, E) give rows of zeros, as on the card."""
    t, d = x.shape
    e, _, f = w.shape
    xb = x.reshape(-1, block_t, d)
    out = torch.zeros((xb.shape[0], block_t, f), dtype=torch.float32,
                      device=x.device)
    gid = group_ids.long()
    for ei in torch.unique(gid).tolist():
        if 0 <= ei < e:
            sel = torch.nonzero(gid == ei).squeeze(1)
            out[sel] = torch.matmul(xb[sel].float(), w[ei].float())
    return out.reshape(t, f).to(x.dtype)


def dispatch_tiles_plain(group_ids: torch.Tensor, block_t: int,
                         bm: int) -> torch.Tensor:
    """The tile list of the bfloat16 grouped GEMM: the runs of equal
    group id (``block_t`` rows each id), in row order, each cut into
    tiles of at most ``bm`` rows (the GEMM's are ``TILE_ROWS``) from its
    first row.  Returns int32
    [n, 3] rows ``(row0, row_end, expert)``; an unknown expert's tile is
    listed too (the kernel stores its rows as zeros)."""
    g = group_ids.long()
    nb, dev = g.numel(), g.device
    if nb == 0:
        return torch.zeros((0, 3), dtype=torch.int32, device=dev)
    new_run = torch.ones(nb, dtype=torch.bool, device=dev)
    new_run[1:] = g[1:] != g[:-1]
    first = torch.nonzero(new_run).squeeze(1)
    last = torch.cat([first[1:], first.new_tensor([nb])]) - 1
    row0, row1 = first * block_t, (last + 1) * block_t
    n = (row1 - row0 + bm - 1) // bm
    run = torch.repeat_interleave(torch.arange(first.numel(), device=dev), n)
    k = torch.arange(run.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    start = row0[run] + k * bm
    end = torch.minimum(start + bm, row1[run])
    return torch.stack([start, end, g[first][run]], 1).to(torch.int32)


def max_tiles(nb: int, block_t: int, bm: int) -> int:
    """The most tiles ``nb`` group ids can make (a block of ``block_t``
    rows starts at most ``block_t // bm + 1`` tiles)."""
    return nb * (block_t // bm + 1)


def _tile_list(group_ids: torch.Tensor, block_t: int,
               bm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scratch for the kernel's tile list: int32 [max_tiles, 4] and the
    count [1], one allocation (the count first, so the tiles are 16-byte
    aligned)."""
    n = max_tiles(group_ids.numel(), block_t, bm)
    buf = torch.empty(((n + 1) * 4,), dtype=torch.int32,
                      device=group_ids.device)
    return buf[4:].view(n, 4), buf[:1]


def dispatch_tiles(group_ids: torch.Tensor, block_t: int,
                   bm: int) -> torch.Tensor:
    """:func:`dispatch_tiles_plain` for ids on the CPU; on a card, the
    list the kernel's prologue builds, as [n, 3] on the card.  Reading
    its length waits for the card: the GEMM's wrapper never calls this,
    and builds the list on the card without a wait."""
    if not group_ids.is_cuda:
        return dispatch_tiles_plain(group_ids, block_t, bm)
    if group_ids.dtype != torch.int32 or not group_ids.is_contiguous():
        raise TypeError("dispatch_tiles: group_ids must be contiguous int32")
    tiles, count = _tile_list(group_ids, block_t, bm)
    lib = _build.load("moe_dispatch", _SIGNATURES)
    code = lib.moe_dispatch_tiles(
        _build.ptr(group_ids), group_ids.numel(), block_t, bm,
        _build.ptr(tiles), _build.ptr(count),
        _build.stream_ptr(group_ids.device))
    _build.check(code, "moe_dispatch_tiles")
    return tiles[:int(count.item()), :3]


def gemm_smem_bytes() -> int:
    """Dynamic shared memory of one bfloat16 block (builds the kernel;
    needs the CUDA toolkit)."""
    return _build.load("moe_dispatch", _SIGNATURES).moe_dispatch_smem()


def _gemm_layout(w: torch.Tensor) -> int | None:
    """0 when w's K stride is 1, 1 when its N stride is 1, and None when
    TMA cannot read w in place: it needs a 16-byte aligned base and the
    other strides multiples of 16 bytes (8 bfloat16 values)."""
    se, sk, sn = w.stride()
    aligned = w.data_ptr() % 16 == 0 and se % 8 == 0
    if sk == 1 and aligned and sn % 8 == 0:
        return 0
    if sn == 1 and aligned and sk % 8 == 0 and w.shape[2] % 8 == 0:
        return 1
    return None


def moe_dispatch_matmul(group_ids: torch.Tensor, x: torch.Tensor,
                        w: torch.Tensor, *, block_t: int) -> torch.Tensor:
    """Grouped GEMM: ``out[tb] = x[tb] @ w[group_ids[tb]]`` for each
    block ``tb`` of ``block_t`` rows.

    group_ids int32 [T / block_t] (any order; ids outside [0, E) give
    zero rows); x [T, D] contiguous (float32 or bfloat16); w [E, D, F]
    in x's dtype, read through its strides (a transposed view of
    ``[E, F, D]`` weights included).  Returns [T, F] in x's dtype with
    float32 accumulation.  The group ids never leave the card: the
    bfloat16 route builds its tile list there (:func:`dispatch_tiles`)."""
    if not x.is_cuda:
        return moe_dispatch_matmul_plain(group_ids, x, w, block_t=block_t)
    if x.dtype not in Q_CODES or w.dtype != x.dtype:
        raise TypeError(f"moe_dispatch_matmul takes "
                        f"{'/'.join(map(str, Q_CODES))} x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if group_ids.dtype != torch.int32:
        raise TypeError(f"moe_dispatch_matmul: group_ids must be int32, got "
                        f"{group_ids.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are "
                         f"not [T, D] and [E, D, F]")
    t, d = x.shape
    e, _, f = w.shape
    if block_t <= 0 or t % block_t or group_ids.shape != (t // block_t,):
        raise ValueError(f"group_ids {tuple(group_ids.shape)} do not give "
                         f"one id per {block_t} of x's {t} rows")
    if any(a.device != x.device for a in (group_ids, w)):
        raise ValueError("moe_dispatch_matmul: all inputs must be on one "
                         "device")
    if not (x.is_contiguous() and group_ids.is_contiguous()):
        raise ValueError("moe_dispatch_matmul needs contiguous x and "
                         "group_ids")
    layout = 0
    tiles = count = None
    if x.dtype == torch.bfloat16:
        layout = _gemm_layout(w)
        if layout is None or d % 8 or x.data_ptr() % 16:
            raise ValueError(
                f"moe_dispatch_matmul (bfloat16) reads x and w by TMA, "
                f"which needs 16-byte aligned bases and strides that are "
                f"multiples of 16 bytes: w {tuple(w.shape)} with strides "
                f"{w.stride()} (one of them must be 1) and D = {d} do "
                f"not allow it")
        tiles, count = _tile_list(group_ids, block_t, TILE_ROWS)
    out = torch.empty((t, f), dtype=x.dtype, device=x.device)
    lib = _build.load("moe_dispatch", _SIGNATURES)
    code = lib.moe_dispatch_matmul(
        _build.ptr(group_ids), _build.ptr(x), _build.ptr(w), _build.ptr(out),
        None if tiles is None else _build.ptr(tiles),
        None if count is None else _build.ptr(count),
        t, d, f, e, block_t, *w.stride(), Q_CODES[x.dtype], layout,
        _build.stream_ptr(x.device))
    _build.check(code, "moe_dispatch_matmul")
    moe_dispatch_matmul.launches += 1
    return out


moe_dispatch_matmul.launches = 0
moe_paged_gateup.launches = 0
moe_paged_down.launches = 0
