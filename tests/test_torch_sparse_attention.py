"""The port's paged sparse attention against the JAX reference.

``select_pages_blocktable`` must give exactly the reference's logical and
physical ids, ties included; the plain ``attend_pages_paged`` (the
decode kernel's plain version, which the kernel wrapper runs for CPU
tensors) is held to the reference's ``attend_pages_paged`` and to the
Pallas ``paged_decode_attn`` in interpret mode at 1e-5, over the case
grid of ``tests/test_paged_kernel.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_decode_attn as pallas_paged_decode_attn
from repro.models import sparse_attention as js
from repro_torch.kernels.paged_decode_attn import paged_decode_attn
from repro_torch.models import sparse_attention as ts

TOL = dict(rtol=1e-5, atol=1e-5)
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


def _case(seed, r, kv, g, d, n_pages, n_logical, k_sel, page,
          pool_dtype="float32", short_row=True, shared_rows=False,
          null_row=False):
    """Pool, block tables and frontiers in the allocator's conventions
    (page 0 = NULL), as numpy: one case for both frameworks."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(r, kv, g, d)).astype(np.float32)
    kf = rng.normal(size=(n_pages, page, kv, d)).astype(np.float32)
    vf = rng.normal(size=(n_pages, page, kv, d)).astype(np.float32)
    spool = rng.normal(size=(n_pages, kv, d)).astype(np.float32)
    bt = np.stack([rng.choice(np.arange(1, n_pages), size=n_logical,
                              replace=False) for _ in range(r)]
                  ).astype(np.int32)
    if shared_rows:
        # COW-style sharing: rows 0/1 share their prompt pages
        bt[1, :n_logical - 1] = bt[0, :n_logical - 1]
    pos = rng.integers(page, n_logical * page, size=r).astype(np.int32)
    if short_row:
        pos[0] = page // 2          # fewer valid pages than K: NULL ties
    if null_row:
        bt[-1] = 0                  # a padded batch row
        pos[-1] = 0
    return dict(q=q, kf=kf, vf=vf, spool=spool, bt=bt, pos=pos,
                k_sel=k_sel, page=page, pool_dtype=pool_dtype)


def _both(c):
    """Select with both frameworks; return (jax args, torch args)."""
    jdt = _JNP[c["pool_dtype"]]
    jk = js.kv_quant(jnp.asarray(c["kf"]), jdt)
    jv = js.kv_quant(jnp.asarray(c["vf"]), jdt)
    jq = jnp.asarray(c["q"])
    jidx, jphys = js.select_pages_blocktable(
        jq, jnp.asarray(c["spool"]), jnp.asarray(c["bt"]),
        jnp.asarray(c["pos"]) // c["page"] + 1, c["k_sel"])
    tdt = _TORCH[c["pool_dtype"]]
    tk = ts.kv_quant(torch.from_numpy(c["kf"]), tdt)
    tv = ts.kv_quant(torch.from_numpy(c["vf"]), tdt)
    tq = torch.from_numpy(c["q"])
    tidx, tphys = ts.select_pages_blocktable(
        tq, torch.from_numpy(c["spool"]), torch.from_numpy(c["bt"]).long(),
        torch.from_numpy(c["pos"]).long() // c["page"] + 1, c["k_sel"])
    jpos, tpos = jnp.asarray(c["pos"]), torch.from_numpy(c["pos"])
    return (jq, jk, jv, jidx, jphys, jpos), (tq, tk, tv, tidx, tphys, tpos)


GRID = [(page, *shape) for page in (8, 16) for shape in (
    (4, 2, 2, 32, 4),
    (2, 2, 6, 64, 3),     # wide GQA group
    (3, 1, 1, 32, 2),     # MQA, single-head group
)]


@pytest.mark.parametrize("page,r,kv,g,d,k_sel", GRID)
def test_select_pages_blocktable_exact(page, r, kv, g, d, k_sel):
    c = _case(10 + page + r, r, kv, g, d, n_pages=24, n_logical=8,
              k_sel=k_sel, page=page)
    (_, _, _, jidx, jphys, _), (_, _, _, tidx, tphys, _) = _both(c)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tphys.numpy(), np.asarray(jphys))


def test_select_pages_ties_when_fewer_valid_pages_than_k():
    """Every padded page scores -inf: the lowest-index tie rule decides
    which NULL ids fill the selection, as ``jax.lax.top_k`` does."""
    c = _case(7, 3, 2, 2, 16, n_pages=20, n_logical=8, k_sel=6, page=4,
              null_row=True)
    c["pos"][1] = 5                     # 2 valid pages of 8, K = 6
    (_, _, _, jidx, jphys, _), (_, _, _, tidx, tphys, _) = _both(c)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tphys.numpy(), np.asarray(jphys))
    assert (tphys.numpy()[-1] == 0).all()


def test_topk_lowest_index_breaks_exact_ties_low():
    s = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, float("-inf")]])
    assert ts.topk_lowest_index(s, 5).tolist() == [[1, 2, 4, 0, 3]]


def _check_attend(c):
    (jq, jk, jv, jidx, jphys, jpos), (tq, tk, tv, tidx, tphys, tpos) = \
        _both(c)
    page = c["page"]
    want = np.asarray(js.attend_pages_paged(jq, jk, jv, jidx, jphys, jpos,
                                            page), np.float32)
    pallas = np.asarray(pallas_paged_decode_attn(
        jphys, jidx, jpos, jq, jk, jv, page_size=page, interpret=True),
        np.float32)
    plain = ts.attend_pages_paged(tq, tk, tv, tidx, tphys, tpos, page)
    # the kernel wrapper, given CPU tensors, runs the plain version
    launches = paged_decode_attn.launches
    wrapped = paged_decode_attn(tphys, tidx, tpos, tq, tk, tv,
                                page_size=page)
    assert paged_decode_attn.launches == launches
    assert torch.isfinite(plain).all()
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    np.testing.assert_allclose(plain.numpy(), pallas, **TOL)
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


@pytest.mark.parametrize("page,r,kv,g,d,k_sel", GRID)
def test_attend_pages_paged_matches_reference_and_pallas(page, r, kv, g, d,
                                                         k_sel):
    _check_attend(_case(20 + page + r, r, kv, g, d, n_pages=24,
                        n_logical=8, k_sel=k_sel, page=page))


@pytest.mark.parametrize("pool_dtype", ["bfloat16", "int8", "float32"])
def test_attend_pages_paged_pool_dtypes(pool_dtype):
    _check_attend(_case(30, 3, 2, 2, 32, n_pages=16, n_logical=6, k_sel=3,
                        page=8, pool_dtype=pool_dtype))


def test_attend_pages_paged_null_padded_batch_row():
    _check_attend(_case(31, 3, 2, 2, 32, n_pages=16, n_logical=6, k_sel=3,
                        page=8, short_row=False, null_row=True))


def test_attend_pages_paged_cow_shared_block_tables():
    c = _case(32, 2, 2, 2, 32, n_pages=16, n_logical=4, k_sel=3, page=8,
              short_row=False, shared_rows=True)
    _check_attend(c)


@pytest.mark.parametrize("pool_dtype", ["bfloat16", "int8", "float32"])
def test_kv_quant_roundtrip(pool_dtype):
    x = np.random.default_rng(40).normal(size=(5, 7)).astype(np.float32) * 4
    jq = js.kv_quant(jnp.asarray(x), _JNP[pool_dtype])
    tq = ts.kv_quant(torch.from_numpy(x), _TORCH[pool_dtype])
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq, np.float32))
    np.testing.assert_array_equal(
        ts.kv_dequant_f32(tq).numpy(), np.asarray(js.kv_dequant_f32(jq)))


def test_page_scores_and_summary_from_pool():
    rng = np.random.default_rng(41)
    q = rng.normal(size=(2, 2, 3, 16)).astype(np.float32)
    kp = rng.normal(size=(2, 5, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(
        ts.page_scores(torch.from_numpy(q), torch.from_numpy(kp)).numpy(),
        np.asarray(js.page_scores(jnp.asarray(q), jnp.asarray(kp))), **TOL)
    pool = rng.normal(size=(9, 4, 2, 16)).astype(np.float32)
    phys = np.array([3, 1, 7, 0], np.int32)
    n_tok = np.array([1, 4, 2, 3], np.int32)
    np.testing.assert_allclose(
        ts.page_summary_from_pool(*map(torch.from_numpy,
                                       (pool, phys, n_tok))).numpy(),
        np.asarray(js.page_summary_from_pool(*map(jnp.asarray,
                                                  (pool, phys, n_tok)))),
        **TOL)
