"""The split-and-merge of the two TopK decode-attention kernels, on the CPU.

``paged_decode_attn`` and ``sparse_decode_attn`` run one CUDA body that
cuts each (row, KV head)'s K selected pages into runs of
``PAGES_PER_SPLIT`` and merges the runs' partial softmax states in run
order.  ``split_merge_plain`` is that computation in PyTorch; here it is
held against the kernels' plain versions (``attend_pages_paged``,
``attend_pages``, ``sparse_decode_attn_plain``) and against the JAX
package's Pallas kernels in interpret mode.  Inputs are made with numpy
from a seed; float32 throughout, tolerance 1e-5 (the sums run in another
order).  The kernels themselves run on the card only
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_decode_attn as pallas_paged_decode_attn
from repro.kernels import sparse_decode_attn as pallas_sparse_decode_attn
from repro_torch.kernels.decode_split import (PAGES_PER_SPLIT,
                                              contiguous_pages, n_split,
                                              paged_pages, split_merge_plain,
                                              workspace)
from repro_torch.kernels.sparse_decode_attn import sparse_decode_attn_plain
from repro_torch.models import sparse_attention as ts

TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_case(seed, *, r=3, kv=2, g=4, d=32, page=4, k_sel=11,
                n_logical=16, pool_dtype=torch.float32, short_pos=None,
                null_row=False):
    """A pool in the allocator's conventions (page 0 = NULL), block
    tables, frontiers and the real TopK selection, for both frameworks."""
    rng = np.random.default_rng(seed)
    n_pages = r * n_logical + 1
    q = rng.normal(size=(r, kv, g, d)).astype(np.float32)
    kf, vf = (rng.normal(size=(n_pages, page, kv, d)).astype(np.float32)
              for _ in range(2))
    spool = rng.normal(size=(n_pages, kv, d)).astype(np.float32)
    bt = np.stack([rng.choice(np.arange(1, n_pages), size=n_logical,
                              replace=False) for _ in range(r)]
                  ).astype(np.int32)
    pos = rng.integers(page * n_logical // 2, page * n_logical,
                       size=r).astype(np.int32)
    if short_pos is not None:
        pos[0] = short_pos
    if null_row:
        bt[-1], pos[-1] = 0, 0
    tk, tv = (ts.kv_quant(torch.from_numpy(x), pool_dtype) for x in (kf, vf))
    tq, tpos = torch.from_numpy(q), torch.from_numpy(pos)
    tidx, tphys = ts.select_pages_blocktable(
        tq, torch.from_numpy(spool), torch.from_numpy(bt).long(),
        tpos.long() // page + 1, k_sel)
    return dict(q=tq, k=tk, v=tv, idx=tidx, phys=tphys, pos=tpos, page=page)


def _pallas_paged(c):
    as_j = {torch.float32: jnp.float32, torch.int8: jnp.int8}
    jk, jv = (jnp.asarray(c[n].numpy(), as_j[c[n].dtype]) for n in "kv")
    return np.asarray(pallas_paged_decode_attn(
        *(jnp.asarray(c[n].numpy()) for n in ("phys", "idx", "pos", "q")),
        jk, jv, page_size=c["page"], interpret=True), np.float32)


def _check_paged(c):
    got = split_merge_plain(c["q"], *paged_pages(
        c["k"], c["v"], c["idx"], c["phys"], c["pos"], c["page"]))
    want = ts.attend_pages_paged(c["q"], c["k"], c["v"], c["idx"],
                                 c["phys"], c["pos"], c["page"])
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), _pallas_paged(c), **TOL)
    return got


@pytest.mark.parametrize("k_sel", [1, 5, 8, 11, 19])
def test_paged_split_merge_matches_plain_and_pallas(k_sel):
    """One run (K 1, 5, 8), a ragged last run (K 11 = 8 + 3) and three
    runs (K 19)."""
    assert n_split(k_sel) == -(-k_sel // PAGES_PER_SPLIT)
    _check_paged(_paged_case(40 + k_sel, k_sel=k_sel, n_logical=24))


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.int8])
def test_paged_split_merge_short_row_padded_row(pool_dtype):
    """Row 0 has 2 valid pages of 16 (its frontier inside page 1), so of
    K = 16 the second run holds only NULL slots past the frontier: a run
    with no live token (m = -inf, l = 0).  The last row is a padded batch
    row (block table all NULL, frontier 0).  Pools in float32 and int8."""
    c = _paged_case(7, k_sel=16, short_pos=6, null_row=True,
                    pool_dtype=pool_dtype)
    _, _, live = paged_pages(c["k"], c["v"], c["idx"], c["phys"], c["pos"],
                             c["page"])
    second = live[0, :, PAGES_PER_SPLIT:2 * PAGES_PER_SPLIT]
    assert n_split(16) == 2 and not second.any() and live[0].any()
    got = _check_paged(c)
    assert got[-1].abs().sum() > 0      # token 0 of the NULL page is live


def test_paged_split_merge_row_with_no_live_token_is_zeros():
    """Every selected page past the frontier (logical ids moved beyond
    it): zeros, as ``attend_pages_paged`` and the Pallas kernel give."""
    c = _paged_case(9, k_sel=10)
    c["idx"][1] += 100
    got = _check_paged(c)
    assert not got[1].any() and got[0].any()


def _contiguous_case(seed, *, b=2, kv=2, g=4, d=32, s=64):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kv, g, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, rng


@pytest.mark.parametrize("k_sel,page", [(5, 4), (11, 4), (19, 1),
                                        (13, 8), (16, 16)])
def test_contiguous_split_merge_with_frontier_matches_attend_pages(k_sel,
                                                                   page):
    q, k, v, rng = _contiguous_case(k_sel + page, s=256)
    pos = 150 + page // 2                # a selected page may straddle it
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kpage = torch.from_numpy(rng.normal(size=(2, 256 // page, 2, 32)
                                        ).astype(np.float32))
    idx = ts.select_pages(tq, kpage, pos // page + 1, k_sel)
    got = split_merge_plain(tq, *contiguous_pages(tk, tv, idx, page, pos))
    want = ts.attend_pages(tq, tk, tv, idx, pos, page)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("k_sel", [5, 11, 24])
def test_contiguous_split_merge_repeated_ids_match_plain_and_pallas(
        k_sel, kv_dtype):
    """The TPU kernel's contract: no frontier, every gathered token
    counts, a repeated page id twice.  int8 K/V go to the Pallas kernel
    dequantised, since it has no int8 scale."""
    q, k, v, rng = _contiguous_case(k_sel, s=32)
    idx = rng.integers(0, 32 // 4, (2, 2, k_sel)).astype(np.int32)
    idx[0, 0, :3] = idx[0, 0, 0]         # one page three times
    tq = torch.from_numpy(q)
    tk, tv = (ts.kv_quant(torch.from_numpy(x), kv_dtype) for x in (k, v))
    tidx = torch.from_numpy(idx)
    got = split_merge_plain(tq, *contiguous_pages(tk, tv, tidx, 4))
    want = sparse_decode_attn_plain(tidx, tq, tk, tv, page_size=4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    pallas = pallas_sparse_decode_attn(
        jnp.asarray(idx), jnp.asarray(q),
        *(jnp.asarray(ts.kv_dequant_f32(t).numpy()) for t in (tk, tv)),
        page_size=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_contiguous_split_merge_ids_outside_the_cache_add_nothing():
    """Ids outside [0, S / page) read nothing: 5 valid ids with 6 stray
    ones mixed in (so two runs, one holding mostly strays) equal the 5
    alone."""
    q, k, v, rng = _contiguous_case(3, s=32)
    ok = rng.integers(0, 8, (2, 2, 5)).astype(np.int32)
    stray = np.array([-1, 8, 9, -7, 100, 8], np.int32)
    mixed = np.concatenate([ok[..., :2], np.broadcast_to(stray, (2, 2, 6)),
                            ok[..., 2:]], axis=-1)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = split_merge_plain(tq, *contiguous_pages(
        tk, tv, torch.from_numpy(mixed.copy()), 4))
    want = sparse_decode_attn_plain(torch.from_numpy(ok), tq, tk, tv,
                                    page_size=4)
    assert n_split(mixed.shape[-1]) == 2
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_contiguous_split_merge_padded_row_is_zeros():
    """A row whose pages all lie past the frontier gives zeros (the
    frontier is one host int, so the row's pages are moved past it)."""
    q, k, v, rng = _contiguous_case(5, s=64)
    idx = torch.from_numpy(rng.integers(0, 4, (2, 2, 9)).astype(np.int32))
    idx[1] += 8
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = split_merge_plain(tq, *contiguous_pages(tk, tv, idx, 4, 20))
    want = ts.attend_pages(tq[:1], tk[:1], tv[:1], idx[:1], 20, 4)
    assert not got[1].any()
    np.testing.assert_allclose(got[:1].numpy(), want.numpy(), **TOL)


def test_n_split_depends_on_k_alone():
    """Runs of PAGES_PER_SPLIT pages, the last one ragged: the count is a
    function of K only, not of the batch, the frontier or the ids."""
    assert PAGES_PER_SPLIT == 8
    got = [n_split(k) for k in range(1, 70)]
    assert got == [-(-k // 8) for k in range(1, 70)]
    assert n_split(64) == 8 and n_split(5) == 1 and n_split(9) == 2
    with pytest.raises(ValueError):
        n_split(0)


@pytest.mark.parametrize("k_sel,splits", [(1, 1), (8, 1), (9, 2), (64, 8)])
def test_workspace_has_a_slot_for_every_split(k_sel, splits):
    """[rows, n_split, G, D + 2] float32 (accumulator, m, l) where the
    splits are merged; empty where one block writes the output."""
    ws = workspace(16, k_sel, 6, 128, "cpu")
    assert ws.dtype == torch.float32
    if splits == 1:
        assert ws.numel() == 0
    else:
        assert ws.shape == (16, splits, 6, 130)


def test_split_merge_row_does_not_depend_on_its_batch():
    """A row computed alone equals the row computed in a batch of 3 with
    other rows, other frontiers and other pages."""
    c = _paged_case(11, k_sel=13, short_pos=6, null_row=True)
    batch = split_merge_plain(c["q"], *paged_pages(
        c["k"], c["v"], c["idx"], c["phys"], c["pos"], c["page"]))
    for r in range(3):
        one = split_merge_plain(c["q"][r:r + 1], *paged_pages(
            c["k"], c["v"], c["idx"][r:r + 1], c["phys"][r:r + 1],
            c["pos"][r:r + 1], c["page"]))
        np.testing.assert_allclose(one.numpy(), batch[r:r + 1].numpy(),
                                   rtol=1e-6, atol=1e-6)
