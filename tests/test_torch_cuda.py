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
from repro_torch.kernels.moe_dispatch import (moe_paged_down,
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


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("page,r,kv,g,d,k_sel", [
    (8, 4, 2, 2, 32, 4), (16, 3, 2, 6, 128, 5), (16, 3, 1, 1, 64, 2),
    (4, 4, 2, 2, 32, 4)])
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("sq,sk,h,kv,d,q_offset", [
    (16, 16, 4, 2, 32, 0), (37, 53, 6, 2, 64, 16), (5, 100, 12, 2, 128, 95),
    (20, 20, 4, 1, 32, 0), (33, 64, 4, 4, 128, 0)])
def test_flash_prefill_kernel_matches_plain(dev, dtype, sq, sk, h, kv, d,
                                            q_offset):
    gen = torch.Generator(device=dev).manual_seed(sq + sk)
    q_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.randn((2, sq, h, d), generator=gen, device=dev).to(q_dtype)
    k, v = (kv_quant(torch.randn((2, sk, kv, d), generator=gen,
                                 device=dev), _DT[dtype]) for _ in range(2))
    n = flash_prefill.launches
    got = flash_prefill(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_prefill.launches == n + 1
    want = chunked_attention(q, k, v, q_offset=q_offset, chunk=32)
    tol = _tol(q_dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def test_flash_prefill_kernel_refuses_softcap(dev):
    q = torch.randn((1, 4, 2, 32), device=dev)
    with pytest.raises(NotImplementedError):
        flash_prefill(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous(),
                      logit_softcap=30.0)


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


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,kv,g,d,s,p,page", [
    (2, 2, 4, 64, 128, 6, 8), (1, 4, 2, 128, 256, 8, 16),
    (3, 1, 8, 64, 64, 4, 1), (2, 2, 6, 128, 160, 5, 16),
    (1, 2, 12, 32, 32, 3, 4)])
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
