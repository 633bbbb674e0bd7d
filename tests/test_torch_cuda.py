"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (inside its fixture) where no card is
present.  On a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 outputs 1e-5 (both sides accumulate in float32, in
another order); bfloat16 outputs 1e-2 absolute plus relative (one
bfloat16 rounding of a float32 result that differs in its last bits can
move by one bfloat16 step, 2**-8 relative).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_plain
from repro_torch.kernels.gather_spmm import gather_spmm, gather_spmm_plain
from repro_torch.kernels.moe_dispatch import (dispatch_tiles,
                                              dispatch_tiles_plain,
                                              moe_dispatch_matmul,
                                              moe_dispatch_matmul_plain,
                                              moe_paged_down,
                                              moe_paged_down_plain,
                                              moe_paged_gateup,
                                              moe_paged_gateup_plain)
from repro_torch.kernels.paged_decode_attn import paged_decode_attn
from repro_torch.kernels.sparse_decode_attn import (sparse_decode_attn,
                                                    sparse_decode_attn_plain)
from repro_torch.models.layers import chunked_attention
from repro_torch.models.sparse_attention import (attend_pages,
                                                 attend_pages_paged,
                                                 kv_quant, select_pages,
                                                 select_pages_blocktable)
from repro_torch.params import init_params
from repro_torch.serve.engine import Engine, PagedEngine

pytestmark = pytest.mark.cuda

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int8": torch.int8}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-2


def _decode_inputs(dev, r, kv, g, d, k_sel, page, pool_dtype, seed=0,
                   n_logical=8, n_pages=40):
    n_logical = max(n_logical, k_sel)
    n_pages = max(n_pages, n_logical + 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q_dtype = torch.float32 if pool_dtype == "float32" else torch.bfloat16
    shape = (n_pages, page, kv, d)
    kp = kv_quant(torch.randn(shape, generator=gen, device=dev),
                  _DT[pool_dtype])
    vp = kv_quant(torch.randn(shape, generator=gen, device=dev),
                  _DT[pool_dtype])
    spool = torch.randn((n_pages, kv, d), generator=gen, device=dev)
    bt = torch.stack([torch.randperm(n_pages - 1, generator=gen,
                                     device=dev)[:n_logical] + 1
                      for _ in range(r)])
    pos = torch.randint(page, n_logical * page, (r,), generator=gen,
                        device=dev)
    pos[0] = page // 2                           # NULL-padded selection
    bt[-1], pos[-1] = 0, 0                       # padded batch row
    pos = pos.to(torch.int32)
    q = torch.randn((r, kv, g, d), generator=gen, device=dev).to(q_dtype)
    idx, phys = select_pages_blocktable(q, spool, bt, pos // page + 1,
                                        k_sel)
    return phys, idx, pos, q, kp, vp


# the first port's four shapes; then qwen3-moe's heads (KV=4, G=16),
# head_dim 256, and K = 1 (one split), 5 (one ragged split) and 64 (eight
# splits merged by the second pass)
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("page,r,kv,g,d,k_sel", [
    (8, 4, 2, 2, 32, 4), (16, 3, 2, 6, 128, 5), (16, 3, 1, 1, 64, 2),
    (4, 4, 2, 2, 32, 4), (16, 3, 4, 16, 128, 5), (16, 3, 4, 16, 128, 64),
    (16, 3, 2, 2, 256, 5), (8, 3, 2, 1, 256, 64), (8, 4, 2, 2, 32, 1),
    (16, 3, 2, 6, 128, 64), (1, 3, 2, 4, 64, 64)])
def test_paged_decode_kernel_matches_plain(dev, pool_dtype, page, r, kv, g,
                                           d, k_sel):
    phys, idx, pos, q, kp, vp = _decode_inputs(dev, r, kv, g, d, k_sel,
                                               page, pool_dtype)
    n = paged_decode_attn.launches
    got = paged_decode_attn(phys, idx, pos, q, kp, vp, page_size=page)
    torch.cuda.synchronize()
    assert paged_decode_attn.launches == n + 1
    want = attend_pages_paged(q, kp, vp, idx, phys, pos, page)
    tol = _tol(q.dtype)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def test_paged_decode_kernel_rejects_what_it_does_not_take(dev):
    phys, idx, pos, q, kp, vp = _decode_inputs(dev, 2, 2, 2, 32, 3, 8,
                                               "float32")
    with pytest.raises(TypeError):
        paged_decode_attn(phys.long(), idx, pos, q, kp, vp, page_size=8)
    with pytest.raises(ValueError):
        paged_decode_attn(phys, idx, pos, q, kp, vp, page_size=4)
    with pytest.raises(ValueError):
        paged_decode_attn(phys, idx, pos, q.transpose(2, 3), kp, vp,
                          page_size=8)
    # head_dim 48: the kernel is built for 32, 64, 128 and 256 only
    phys, idx, pos, q, kp, vp = _decode_inputs(dev, 2, 2, 2, 48, 3, 8,
                                               "float32")
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attn(phys, idx, pos, q, kp, vp, page_size=8)


def _sparse_inputs(dev, kv_dtype, b, kv, g, d, s, p, page, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q_dtype = torch.float32 if kv_dtype == "float32" else torch.bfloat16
    q = torch.randn((b, kv, g, d), generator=gen, device=dev).to(q_dtype)
    k, v = (kv_quant(torch.randn((b, s, kv, d), generator=gen, device=dev),
                     _DT[kv_dtype]) for _ in range(2))
    pos = s // 2 + page // 2
    sel = select_pages(q, torch.randn((b, s // page, kv, d), generator=gen,
                                      device=dev), pos // page + 1, p)
    return q, k, v, sel, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k_sel", [5, 64])
def test_decode_kernels_are_bitwise_repeatable(dev, dtype, k_sel):
    """No atomics and a fixed merge order: a second call is bitwise the
    first, one split (K=5) or eight (K=64)."""
    args = _decode_inputs(dev, 4, 2, 6, 128, k_sel, 16, dtype)
    a = paged_decode_attn(*args, page_size=16)
    b = paged_decode_attn(*args, page_size=16)
    q, k, v, sel, pos = _sparse_inputs(dev, dtype, 3, 2, 6, 128, 1024,
                                       k_sel, 16)
    c = sparse_decode_attn(sel, q, k, v, page_size=16, pos=pos)
    d = sparse_decode_attn(sel, q, k, v, page_size=16, pos=pos)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kv,g,k_sel", [(2, 6, 64), (4, 16, 64), (2, 6, 5)])
def test_decode_kernels_are_batch_invariant(dev, dtype, kv, g, k_sel):
    """Row r launched alone is bitwise row r of the batch: the split
    count depends on K alone, never on how many rows share the launch
    (row 0 is short, the last row padded)."""
    phys, idx, pos, q, kp, vp = _decode_inputs(dev, 8, kv, g, 128, k_sel,
                                               16, dtype)
    batch = paged_decode_attn(phys, idx, pos, q, kp, vp, page_size=16)
    for r in range(8):
        one = paged_decode_attn(*(t[r:r + 1].contiguous()
                                  for t in (phys, idx, pos, q)), kp, vp,
                                page_size=16)
        torch.cuda.synchronize()
        assert torch.equal(one, batch[r:r + 1]), r
    q, k, v, sel, s_pos = _sparse_inputs(dev, dtype, 8, kv, g, 128, 1024,
                                         k_sel, 16)
    batch = sparse_decode_attn(sel, q, k, v, page_size=16, pos=s_pos)
    for b in range(8):
        one = sparse_decode_attn(sel[b:b + 1].contiguous(),
                                 q[b:b + 1].contiguous(), k[b:b + 1],
                                 v[b:b + 1], page_size=16, pos=s_pos)
        torch.cuda.synchronize()
        assert torch.equal(one, batch[b:b + 1]), b


def _flash_inputs(dev, dtype, sq, sk, h, kv, d, b=2):
    gen = torch.Generator(device=dev).manual_seed(sq + sk)
    q_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(q_dtype)
    k, v = (kv_quant(torch.randn((b, sk, kv, d), generator=gen,
                                 device=dev), _DT[dtype]) for _ in range(2))
    return q, k, v


# B=2 throughout.  The first five shapes are the first port's; then
# head_dim 256, G=16, Sq=1 (the dense decode step), Sq=200 (two ragged
# 128-row tiles), and shapes whose blocks (2 * H * ceil(Sq / 128)) are
# far fewer than the card's SMs, so the bf16 kernel splits their keys
# and merges the splits (``plan(...).splits > 1``, checked on the CPU)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("sq,sk,h,kv,d,q_offset", [
    (16, 16, 4, 2, 32, 0), (37, 53, 6, 2, 64, 16), (5, 100, 12, 2, 128, 95),
    (20, 20, 4, 1, 32, 0), (33, 64, 4, 4, 128, 0),
    (40, 90, 4, 2, 256, 50), (37, 80, 32, 2, 64, 43),
    (1, 150, 12, 2, 128, 149), (200, 200, 4, 2, 128, 0),
    (200, 700, 4, 2, 128, 500), (1, 1000, 16, 1, 256, 700),
    (37, 400, 6, 6, 32, 363)])
def test_flash_prefill_kernel_matches_plain(dev, dtype, sq, sk, h, kv, d,
                                            q_offset):
    q, k, v = _flash_inputs(dev, dtype, sq, sk, h, kv, d)
    n = flash_prefill.launches
    got = flash_prefill(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_prefill.launches == n + 1
    want = chunked_attention(q, k, v, q_offset=q_offset, chunk=32)
    tol = _tol(q.dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def test_flash_prefill_kernel_refuses_softcap(dev):
    q = torch.randn((1, 4, 2, 32), device=dev)
    with pytest.raises(NotImplementedError):
        flash_prefill(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous(),
                      logit_softcap=30.0)


def test_flash_prefill_bf16_refuses_other_head_dims(dev):
    q, k, v = _flash_inputs(dev, "bfloat16", 8, 8, 4, 2, 48)
    n = flash_prefill.launches
    with pytest.raises(ValueError):
        flash_prefill(q, k, v)
    with pytest.raises(TypeError):           # bf16 q against float32 K/V
        flash_prefill(q, k.float(), v.float())
    assert flash_prefill.launches == n


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_flash_prefill_split_is_bitwise_repeatable(dev, dtype):
    """The key splits merge in a fixed order: the same inputs give the
    same bits, and one call counts one launch, merge pass included."""
    q, k, v = _flash_inputs(dev, dtype, 200, 700, 4, 2, 128)
    n = flash_prefill.launches
    a = flash_prefill(q, k, v, q_offset=500)
    b = flash_prefill(q, k, v, q_offset=500)
    torch.cuda.synchronize()
    assert flash_prefill.launches == n + 2
    assert torch.equal(a, b)


def test_reduced_engine_card_matches_cpu(dev):
    cfg = get_config("qwen2-1.5b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    work = [(0.5 * i, rng.integers(1, cfg.vocab, size=int(n)), 6)
            for i, n in enumerate(rng.integers(5, 30, size=6))]
    engines = []
    for device in ("cuda", "cpu"):
        eng = PagedEngine(cfg, params, max_len=48, max_batch=4, chunk=8,
                          device=device)
        eng.run([(t, p.copy(), g) for t, p, g in work])
        engines.append(eng)
    for rid, a in engines[0].requests.items():
        b = engines[1].requests[rid]
        assert a.out_tokens == b.out_tokens
        np.testing.assert_allclose(a.last_logits, b.last_logits, rtol=1e-4,
                                   atol=1e-4)


def _moe_inputs(dev, r, k, nt, tf, d, dtype, seed=0, n_pages=50):
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = _DT[dtype]
    pool = torch.randn((n_pages, tf, d), generator=gen, device=dev).to(dt)
    pool[0] = 0                                  # the zero scratch page
    pids = torch.randint(0, n_pages, (r, k, nt), generator=gen,
                         device=dev).to(torch.int32)
    x = torch.randn((r, d), generator=gen, device=dev).to(dt)
    h = torch.randn((r, k, nt * tf), generator=gen, device=dev).to(dt)
    return pids, x, h, pool


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,k,nt,tf,d", [
    (8, 8, 4, 32, 512), (3, 2, 5, 16, 128), (1, 1, 1, 8, 40),
    (2, 3, 6, 7, 100), (5, 4, 3, 64, 256)])
def test_moe_kernels_match_plain(dev, dtype, r, k, nt, tf, d):
    """Vector loads where D fills 16-byte vectors, element loads where it
    does not (d=40 in bfloat16, d=100), and tiles of any row count."""
    pids, x, h, pool = _moe_inputs(dev, r, k, nt, tf, d, dtype)
    n = (moe_paged_gateup.launches, moe_paged_down.launches)
    g = moe_paged_gateup(pids, x, pool)
    y = moe_paged_down(pids, h, pool)
    torch.cuda.synchronize()
    assert (moe_paged_gateup.launches, moe_paged_down.launches) == (
        n[0] + 1, n[1] + 1)
    tol = _tol(x.dtype)
    assert g.dtype == y.dtype == x.dtype
    torch.testing.assert_close(g.float(),
                               moe_paged_gateup_plain(pids, x, pool).float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(y.float(),
                               moe_paged_down_plain(pids, h, pool).float(),
                               rtol=tol, atol=tol)


def test_moe_kernels_reject_what_they_do_not_take(dev):
    pids, x, h, pool = _moe_inputs(dev, 2, 2, 3, 8, 64, "float32")
    with pytest.raises(TypeError):
        moe_paged_gateup(pids.long(), x, pool)
    with pytest.raises(TypeError):
        moe_paged_gateup(pids, x.bfloat16(), pool)
    with pytest.raises(TypeError):
        moe_paged_down(pids, h.half(), pool.half())
    with pytest.raises(ValueError):
        moe_paged_down(pids.cpu(), h, pool)
    with pytest.raises(ValueError):
        moe_paged_gateup(pids.transpose(0, 1), x, pool)
    with pytest.raises(ValueError):
        moe_paged_down(pids, h[:, :, :-1], pool)


def test_reduced_moe_engine_card_matches_cpu(dev):
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    work = [(0.5 * i, rng.integers(1, cfg.vocab, size=int(n)), 6)
            for i, n in enumerate(rng.integers(5, 30, size=6))]
    engines = []
    for device in ("cuda", "cpu"):
        eng = PagedEngine(cfg, params, max_len=48, max_batch=4, chunk=8,
                          device=device, expert_pool="paged")
        eng.run([(t, p.copy(), g) for t, p, g in work])
        engines.append(eng)
    assert engines[0].stats.expert_pages_touched == \
        engines[1].stats.expert_pages_touched > 0
    for rid, a in engines[0].requests.items():
        b = engines[1].requests[rid]
        assert a.out_tokens == b.out_tokens
        np.testing.assert_allclose(a.last_logits, b.last_logits, rtol=1e-4,
                                   atol=1e-4)


# the first port's five shapes; then qwen3-moe's heads (KV=4, G=16),
# head_dim 256, and K = 1, 5 and 64 (one split, one ragged split, eight)
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,kv,g,d,s,p,page", [
    (2, 2, 4, 64, 128, 6, 8), (1, 4, 2, 128, 256, 8, 16),
    (3, 1, 8, 64, 64, 4, 1), (2, 2, 6, 128, 160, 5, 16),
    (1, 2, 12, 32, 32, 3, 4), (2, 4, 16, 128, 1024, 64, 16),
    (2, 4, 16, 128, 256, 5, 16), (2, 2, 2, 256, 1024, 64, 16),
    (2, 2, 2, 256, 128, 5, 16), (2, 2, 4, 64, 128, 1, 8),
    (2, 2, 6, 128, 1024, 64, 16), (2, 2, 3, 32, 128, 64, 1)])
def test_sparse_decode_kernel_matches_plain(dev, kv_dtype, b, kv, g, d, s,
                                            p, page):
    """Both contracts: every gathered token (pos=None, repeated ids
    allowed) and a frontier that cuts a selected page; G over 8 runs in
    two head chunks."""
    gen = torch.Generator(device=dev).manual_seed(s + p)
    q_dtype = torch.float32 if kv_dtype == "float32" else torch.bfloat16
    q = torch.randn((b, kv, g, d), generator=gen, device=dev).to(q_dtype)
    k, v = (kv_quant(torch.randn((b, s, kv, d), generator=gen, device=dev),
                     _DT[kv_dtype]) for _ in range(2))
    idx = torch.randint(0, s // page, (b, kv, p), generator=gen,
                        device=dev).to(torch.int32)
    pos = s // 2 + page // 2
    n = sparse_decode_attn.launches
    got = sparse_decode_attn(idx, q, k, v, page_size=page)
    sel = select_pages(q, torch.randn((b, s // page, kv, d), generator=gen,
                                      device=dev), pos // page + 1, p)
    got_pos = sparse_decode_attn(sel, q, k, v, page_size=page, pos=pos)
    torch.cuda.synchronize()
    assert sparse_decode_attn.launches == n + 2
    tol = _tol(q_dtype)
    for a, want in (
            (got, sparse_decode_attn_plain(idx, q, k, v, page_size=page)),
            (got_pos, attend_pages(q, k, v, sel, pos, page))):
        assert a.dtype == q.dtype and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_sparse_decode_kernel_rejects_what_it_does_not_take(dev):
    q = torch.randn((1, 2, 2, 32), device=dev)
    k = torch.randn((1, 16, 2, 32), device=dev)
    idx = torch.zeros((1, 2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        sparse_decode_attn(idx.long(), q, k, k, page_size=4)
    k16 = k[..., :16].contiguous()
    with pytest.raises(ValueError):
        sparse_decode_attn(idx, q[..., :16].contiguous(), k16, k16,
                           page_size=4)
    with pytest.raises(ValueError):
        sparse_decode_attn(idx, q, k, k, page_size=5)
    with pytest.raises(ValueError):
        sparse_decode_attn(idx, q, k.transpose(1, 2), k.transpose(1, 2),
                           page_size=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,d,k", [(32, 128, 8), (64, 256, 24), (16, 7, 5),
                                   (151, 1536, 300)])
def test_gather_rows_kernel_bitwise(dev, dtype, n, d, k):
    """16-byte words where rows allow, narrower words for odd rows (d=7);
    int32 and int64 ids, repeats included: bitwise the plain version."""
    gen = torch.Generator(device=dev).manual_seed(n + d)
    table = kv_quant(torch.randn((n, d), generator=gen, device=dev),
                     _DT[dtype])
    idx = torch.randint(0, n, (k,), generator=gen, device=dev)
    m = gather_rows.launches
    for ids in (idx, idx.to(torch.int32)):
        got = gather_rows(ids, table)
        assert got.dtype == table.dtype
        assert torch.equal(got, gather_rows_plain(ids, table))
    assert gather_rows.launches == m + 2


def test_reduced_single_batch_engine_card_matches_cpu(dev):
    cfg = get_config("qwen2-1.5b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 32))
    for sparse in (True, False):
        engines = [Engine(cfg, params, max_len=48, sparse=sparse,
                          nsb_pages=16, device=device)
                   for device in ("cuda", "cpu")]
        n = sparse_decode_attn.launches
        outs = [eng.generate({"tokens": toks}, 12) for eng in engines]
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_allclose(engines[0].logits.cpu().numpy(),
                                   engines[1].logits.numpy(), rtol=1e-4,
                                   atol=1e-4)
        assert vars(engines[0].stats) == vars(engines[1].stats)
        assert sparse_decode_attn.launches - n == (
            11 * cfg.n_layers if sparse else 0)


# -- the capacity dispatch's grouped GEMM ---------------------------------------

def _expert_weights(dev, dtype, layout, e, k, n, gen):
    """[E, K, N] weights of std K**-0.5 (the models' init scale, so
    outputs are O(1)) as the port lays them out: ``"gate"`` a transposed
    view of packed ``[E, 3, N, K]`` rows (K contiguous, as
    we_gate/we_up), ``"down"`` a plane of packed ``[E, 3, K, N]`` rows (N
    contiguous, as we_down), ``"dense"`` a contiguous ``[E, K, N]``."""
    def draw(shape):
        return (torch.randn(shape, generator=gen, device=dev)
                * k ** -0.5).to(dtype)
    if layout == "gate":
        return draw((e, 3, n, k))[:, 1].transpose(-1, -2)
    if layout == "down":
        return draw((e, 3, k, n))[:, 2]
    return draw((e, k, n))


def _group_ids(dev, order, t, e, bt, gen):
    """One id per ``bt`` rows: ``"random"``, ``"sorted"`` (random ids in
    order) or ``"runs"`` (each expert one run of equal length, as the
    capacity dispatch lays them out)."""
    nb = t // bt
    if order == "runs":
        return (torch.arange(nb, device=dev) * e // nb).to(torch.int32)
    gids = torch.randint(0, e, (nb,), generator=gen, device=dev)
    if order == "sorted":
        gids = torch.sort(gids).values
    return gids.to(torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["gate", "down", "dense"])
@pytest.mark.parametrize("order", ["random", "sorted", "runs"])
@pytest.mark.parametrize("t,d,e,f,bt", [
    (256, 128, 4, 256, 64), (128, 256, 8, 128, 32), (512, 64, 2, 512, 128),
    (96, 40, 5, 24, 16), (4096, 512, 128, 192, 16),
    (512, 200, 16, 136, 16), (768, 200, 8, 136, 16),
    (3072, 200, 4, 136, 16)])
def test_moe_dispatch_matmul_kernel_matches_plain(dev, dtype, layout, order,
                                                  t, d, e, f, bt):
    """Random and sorted group ids, block_t 16-128, ragged K and N tails
    (D=40 and 200, not multiples of the 64 of K a stage, read through
    TMA's zero fill; F=24 and 136), the three weight layouts read in
    place, and ``"runs"``: 32, 96 and 768 rows an expert (the paths'
    shapes at a reduced K and N), so a 128-row tile's rows past its run
    are never stored over the next expert's (at 32 rows its second
    warpgroup has none of the run's rows)."""
    gen = torch.Generator(device=dev).manual_seed(t + d + f)
    x = torch.randn((t, d), generator=gen, device=dev).to(_DT[dtype])
    w = _expert_weights(dev, _DT[dtype], layout, e, d, f, gen)
    gids = _group_ids(dev, order, t, e, bt, gen)
    n = moe_dispatch_matmul.launches
    got = moe_dispatch_matmul(gids, x, w, block_t=bt)
    torch.cuda.synchronize()
    assert moe_dispatch_matmul.launches == n + 1
    want = moe_dispatch_matmul_plain(gids, x, w, block_t=bt)
    assert got.dtype == x.dtype and got.shape == (t, f)
    tol = _tol(x.dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["gate", "down", "dense"])
@pytest.mark.parametrize("t,e", [(512, 16), (3072, 4)])
def test_moe_dispatch_matmul_is_bitwise_repeatable(dev, layout, t, e):
    """Each output element is written once, by one block, in a fixed K
    order: two launches agree bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((t, 200), generator=gen, device=dev).bfloat16()
    w = _expert_weights(dev, torch.bfloat16, layout, e, 200, 136, gen)
    gids = _group_ids(dev, "random", t, e, 16, gen)
    a = moe_dispatch_matmul(gids, x, w, block_t=16)
    b = moe_dispatch_matmul(gids, x, w, block_t=16)
    assert torch.equal(a, b)


def test_moe_dispatch_matmul_ragged_columns_not_a_multiple_of_8(dev):
    """K-major weights take any F: the last columns are stored one by
    one."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((256, 64), generator=gen, device=dev).bfloat16()
    w = _expert_weights(dev, torch.bfloat16, "gate", 4, 64, 20, gen)
    gids = _group_ids(dev, "runs", 256, 4, 16, gen)
    got = moe_dispatch_matmul(gids, x, w, block_t=16)
    want = moe_dispatch_matmul_plain(gids, x, w, block_t=16)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("order", ["sorted", "random", "unknown"])
@pytest.mark.parametrize("nb,bt,bm", [(256, 16, 64), (1024, 16, 128),
                                      (6144, 16, 128), (20000, 16, 128),
                                      (300, 32, 64), (77, 128, 64),
                                      (90, 64, 128)])
def test_dispatch_tiles_on_the_card_match_the_contract(dev, order, nb, bt,
                                                       bm):
    """The prologue's tile list, built on the card, equals
    ``dispatch_tiles_plain``: sorted, random and unknown ids, one round
    of the scan and several (20000 ids), runs shorter and longer than a
    tile, tiles that start inside a block (block_t 128, 64-row tiles)."""
    gen = torch.Generator(device=dev).manual_seed(nb + bt)
    e = 12
    gids = torch.randint(0, e, (nb,), generator=gen, device=dev)
    if order != "random":
        gids = torch.sort(gids).values
    if order == "unknown":
        gids[torch.randint(0, nb, (nb // 5,), generator=gen,
                           device=dev)] = -3
        gids[-1] = e
    gids = gids.to(torch.int32)
    got = dispatch_tiles(gids, bt, bm)
    want = dispatch_tiles_plain(gids.cpu(), bt, bm)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("t,e", [(64, 3), (1024, 4)])
def test_moe_dispatch_matmul_unknown_group_ids_give_zero_rows(dev, t, e):
    """Ids outside [0, E) give rows of exact zeros, even where x holds
    NaN (their tiles load and multiply nothing)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((t, 32), generator=gen, device=dev).bfloat16()
    w = torch.randn((e, 32, 16), generator=gen, device=dev).bfloat16()
    nb = t // 16
    gids = torch.arange(nb, device=dev, dtype=torch.int32) % (e + 2) - 1
    unknown = (gids < 0) | (gids >= e)
    x.view(nb, 16, 32)[unknown] = float("nan")
    got = moe_dispatch_matmul(gids, x, w, block_t=16)
    want = moe_dispatch_matmul_plain(gids, x, w, block_t=16)
    rows = unknown.repeat_interleave(16)
    assert rows.any() and (got[rows] == 0).all() and not want[rows].any()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_matmul_adds_no_host_sync(dev, dtype):
    """The wrapper never reads the group ids on the host: it runs under
    ``set_sync_debug_mode("error")``, which raises on a synchronising
    call."""
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((512, 256), generator=gen, device=dev).to(_DT[dtype])
    w = _expert_weights(dev, _DT[dtype], "gate", 8, 256, 128, gen)
    gids = _group_ids(dev, "random", 512, 8, 16, gen)
    moe_dispatch_matmul(gids, x, w, block_t=16)   # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe_dispatch_matmul(gids, x, w, block_t=16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = moe_dispatch_matmul_plain(gids, x, w, block_t=16)
    tol = _tol(x.dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_moe_dispatch_matmul_rejects_what_it_does_not_take(dev):
    x = torch.randn((32, 64), device=dev).bfloat16()
    w = torch.randn((2, 64, 48), device=dev).bfloat16()
    gids = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        moe_dispatch_matmul(gids.long(), x, w, block_t=16)
    with pytest.raises(TypeError):
        moe_dispatch_matmul(gids, x, w.float(), block_t=16)
    with pytest.raises(ValueError):
        moe_dispatch_matmul(gids, x, w, block_t=8)
    with pytest.raises(ValueError):
        moe_dispatch_matmul(gids, x[:, :32], w, block_t=16)
    with pytest.raises(ValueError):
        moe_dispatch_matmul(gids, x.t().contiguous().t(), w, block_t=16)
    with pytest.raises(ValueError):      # bf16 rows not 16-byte aligned
        moe_dispatch_matmul(gids, x, w[..., 1:45], block_t=16)


def test_moe_ffn_kernel_route_matches_torch_route(dev):
    """The capacity dispatch with its three products through the kernel
    against ``torch.matmul``, on packed experts, with pairs dropped."""
    from dataclasses import replace as dc_replace

    from repro_torch.models import moe
    cfg = dc_replace(get_config("qwen3-moe-235b-a22b").reduced(),
                     d_model=256, d_ff_expert=128, n_experts=16, top_k=4,
                     param_dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.randn((2, 64, cfg.d_model), device=dev).bfloat16()
    for factor in (1.25, 0.25):
        n = moe_dispatch_matmul.launches
        got = moe.moe_ffn(x, lp, cfg, factor, kernel="cuda")
        assert moe_dispatch_matmul.launches == n + 3
        want = moe.moe_ffn(x, lp, cfg, factor, kernel="torch")
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


# -- the ELL SpMM ---------------------------------------------------------------

@pytest.mark.parametrize("vals_dtype,dense_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16")])
@pytest.mark.parametrize("m,j,nin,n", [(8, 4, 16, 128), (16, 8, 32, 256),
                                       (4, 16, 64, 512), (33, 40, 70, 100),
                                       (256, 16, 1024, 1024)])
def test_gather_spmm_kernel_matches_plain(dev, vals_dtype, dense_dtype, m, j,
                                          nin, n):
    """Vector and element-wise column paths (N=100), rows of more than 32
    entries, padding entries (val 0) and column ids outside [0, N_in)."""
    gen = torch.Generator(device=dev).manual_seed(m + j)
    cols = torch.randint(0, nin, (m, j), generator=gen, device=dev)
    cols[0, 0], cols[-1, -1] = -1, nin
    cols = cols.to(torch.int32)
    vals = torch.randn((m, j), generator=gen, device=dev)
    vals[:, -1] = 0
    vals = vals.to(_DT[vals_dtype])
    dense = torch.randn((nin, n), generator=gen, device=dev).to(
        _DT[dense_dtype])
    c = gather_spmm.launches
    got = gather_spmm(cols, vals, dense)
    torch.cuda.synchronize()
    assert gather_spmm.launches == c + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, gather_spmm_plain(cols, vals, dense),
                               rtol=1e-5, atol=1e-5)


def test_gather_spmm_rejects_what_it_does_not_take(dev):
    cols = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    vals = torch.ones((4, 2), device=dev)
    dense = torch.ones((8, 16), device=dev)
    with pytest.raises(TypeError):
        gather_spmm(cols.long(), vals, dense)
    with pytest.raises(TypeError):
        gather_spmm(cols, vals.half(), dense)
    with pytest.raises(ValueError):
        gather_spmm(cols, vals[:, :1], dense)
    with pytest.raises(ValueError):
        gather_spmm(cols, vals, dense.t())


# -- repairs: sparse_decode_attn at head_dim 256, gather_rows out of range ----

@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("g", [8, 6, 16])
def test_sparse_decode_kernel_head_dim_256(dev, kv_dtype, g):
    """gemma-7b's head_dim: 4 query heads a block (G=6 leaves a chunk of
    2), with and without the frontier."""
    b, kv, d, s, p, page = 2, 1, 256, 128, 5, 16
    gen = torch.Generator(device=dev).manual_seed(g)
    q_dtype = torch.float32 if kv_dtype == "float32" else torch.bfloat16
    q = torch.randn((b, kv, g, d), generator=gen, device=dev).to(q_dtype)
    k, v = (kv_quant(torch.randn((b, s, kv, d), generator=gen, device=dev),
                     _DT[kv_dtype]) for _ in range(2))
    idx = torch.randint(0, s // page, (b, kv, p), generator=gen,
                        device=dev).to(torch.int32)
    pos = 70
    got = sparse_decode_attn(idx, q, k, v, page_size=page)
    got_pos = sparse_decode_attn(idx, q, k, v, page_size=page, pos=pos)
    torch.cuda.synchronize()
    tol = _tol(q_dtype)
    for a, want in (
            (got, sparse_decode_attn_plain(idx, q, k, v, page_size=page)),
            (got_pos, attend_pages(q, k, v, idx, pos, page))):
        torch.testing.assert_close(a.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_single_batch_engine_head_dim_256_on_the_card(dev):
    """The single-batch sparse decode of a head_dim-256 config (gemma-7b's
    width of head) runs its kernel and agrees with the CPU."""
    from dataclasses import replace as dc_replace
    cfg = dc_replace(get_config("gemma-7b").reduced(), head_dim=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 16))
    engines = [Engine(cfg, params, max_len=32, sparse=True, device=device)
               for device in ("cuda", "cpu")]
    n = sparse_decode_attn.launches
    outs = [eng.generate({"tokens": toks}, 6) for eng in engines]
    assert sparse_decode_attn.launches - n == 5 * cfg.n_layers
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(engines[0].logits.cpu().numpy(),
                               engines[1].logits.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_gather_rows_out_of_range_ids_are_zero_rows_as_on_the_cpu(dev,
                                                                  dtype):
    n, d = 16, 24
    table = kv_quant(torch.randn((n, d), device=dev), _DT[dtype])
    for idx_dtype in (torch.int32, torch.int64):
        ids = torch.tensor([3, -1, n, n + 7, 0], dtype=idx_dtype,
                           device=dev)
        got = gather_rows(ids, table)
        want = gather_rows_plain(ids.cpu(), table.cpu())
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got, gather_rows_plain(ids, table))
        assert not got[1:4].any()
        assert torch.equal(got[0], table[3])
