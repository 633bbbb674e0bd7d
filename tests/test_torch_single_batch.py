"""The single-batch slice: the port's contiguous-cache sparse attention,
``transformer`` prefill / cache / decode, the ``sparse_decode_attn`` and
``gather_rows`` kernels' plain versions and the whole single-batch
``Engine`` against the JAX reference on reduced qwen2-1.5b (and one
reduced qwen3-moe case), with the same weights (``from_jax``) and the
same numpy-made inputs, on the CPU.

Held exactly: TopK page ids (ties included), tokens, the layer-0 proxy
selection of every step and the NSB counters; ``gather_rows`` bitwise.
Held to 1e-5: page summaries, caches and attention outputs (float32;
sums in another order); 1e-4: logits (as the paged slice's engine
test).  The Pallas kernels run in interpret mode, with the tolerances of
``tests/test_kernels.py``.  The reference's own promises are proved
again within the port: full-coverage sparse decode equals dense
(``test_models.py``) and the NSB hit rate exceeds 0.5
(``test_system.py``)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import gather_rows as pallas_gather_rows
from repro.kernels import sparse_decode_attn as pallas_sparse_decode_attn
from repro.models import sparse_attention as js
from repro.models import transformer as jt
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_plain
from repro_torch.kernels.sparse_decode_attn import (sparse_decode_attn,
                                                    sparse_decode_attn_plain)
from repro_torch.launch import serve as tserve
from repro_torch.models import api
from repro_torch.models import sparse_attention as ts
from repro_torch.models import transformer as tt
from repro_torch.params import from_jax, init_params
from repro_torch.serve.engine import Engine

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("qwen2-1.5b").reduced()
    jp = jt.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s))


# -- sparse attention on contiguous caches ------------------------------------

@pytest.mark.parametrize("n_valid", [1, 2, 5, 12])
def test_select_pages_matches_reference_ties_included(n_valid):
    """Pages past ``n_valid`` tie at -inf and zero summaries tie at 0:
    only ``lax.top_k``'s order (lowest index first) picks the same ids."""
    rng = np.random.default_rng(n_valid)
    q = rng.normal(size=(3, 2, 4, 16)).astype(np.float32)
    kpage = rng.normal(size=(3, 12, 2, 16)).astype(np.float32)
    kpage[:, 1::3] = 0.0                          # tied finite scores
    want = js.select_pages(jnp.asarray(q), jnp.asarray(kpage),
                           jnp.asarray(n_valid), 8)
    got = ts.select_pages(torch.from_numpy(q), torch.from_numpy(kpage),
                          n_valid, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pos", [0, 5, 7, 8, 30])
def test_update_page_summary_matches_reference(pos):
    rng = np.random.default_rng(pos)
    kpage = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    k_new = rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
    want = js.update_page_summary(jnp.asarray(kpage), jnp.asarray(k_new),
                                  jnp.asarray(pos, jnp.int32), 4)
    got = torch.from_numpy(kpage.copy())
    out = ts.update_page_summary(got, torch.from_numpy(k_new), pos, 4)
    assert out is got                             # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _contiguous_case(seed, b=2, s=32, kv=2, g=3, d=16, page=4, n_layers=2):
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.normal(size=(b, kv, g, d)).astype(np.float32),
        k=rng.normal(size=(n_layers, b, s, kv, d)).astype(np.float32),
        v=rng.normal(size=(n_layers, b, s, kv, d)).astype(np.float32),
        kpage=rng.normal(size=(b, s // page, kv, d)).astype(np.float32),
        page=page)


@pytest.mark.parametrize("pos", [2, 13, 31])
def test_attend_pages_and_sparse_decode_match_reference(pos):
    c = _contiguous_case(pos)
    jq, jk, jv = (jnp.asarray(c[n]) for n in ("q", "k", "v"))
    tq, tk, tv = (torch.from_numpy(c[n]) for n in ("q", "k", "v"))
    idx = js.select_pages(jq, jnp.asarray(c["kpage"]),
                          jnp.asarray(pos // 4 + 1), 3)
    tidx = torch.from_numpy(np.array(idx))
    np.testing.assert_array_equal(
        ts.page_token_positions(tidx, 4).numpy(),
        np.asarray(js.page_token_positions(idx, 4)))
    np.testing.assert_allclose(
        ts.attend_pages(tq, tk[1], tv[1], tidx, pos, 4).numpy(),
        np.asarray(js.attend_pages(jq, jk[1], jv[1], idx,
                                   jnp.asarray(pos), 4)), **TOL)
    np.testing.assert_allclose(
        ts.sparse_decode(tq, tk[0], tv[0], torch.from_numpy(c["kpage"]),
                         pos, page=4, k_pages=3).numpy(),
        np.asarray(js.sparse_decode(jq, jk[0], jv[0],
                                    jnp.asarray(c["kpage"]),
                                    jnp.asarray(pos), page=4, k_pages=3)),
        **TOL)
    np.testing.assert_array_equal(
        ts.gather_pages_full(tk, 1, tidx, 4).numpy(),
        np.asarray(js.gather_pages_full(jk, 1, idx, 4)))


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_sparse_decode_full_matches_reference(kv_dtype):
    c = _contiguous_case(7)
    pos = 22
    jk = js.kv_quant(jnp.asarray(c["k"]), _JNP[kv_dtype])
    jv = js.kv_quant(jnp.asarray(c["v"]), _JNP[kv_dtype])
    want = js.sparse_decode_full(jnp.asarray(c["q"]), jk, jv,
                                 jnp.asarray(c["kpage"]), 1,
                                 jnp.asarray(pos), page=4, k_pages=4)
    tk = ts.kv_quant(torch.from_numpy(c["k"]), _TORCH[kv_dtype])
    tv = ts.kv_quant(torch.from_numpy(c["v"]), _TORCH[kv_dtype])
    np.testing.assert_array_equal(tk.float().numpy(), _np(jk))
    got = ts.sparse_decode_full(torch.from_numpy(c["q"]), tk, tv,
                                torch.from_numpy(c["kpage"]), 1, pos,
                                page=4, k_pages=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the kernels' plain versions against the Pallas kernels ------------------

KERNEL_SHAPES = [(2, 2, 4, 64, 128, 6, 8), (1, 4, 2, 128, 256, 8, 16),
                 (3, 1, 8, 64, 64, 4, 1)]     # tests/test_kernels.py


@pytest.mark.parametrize("dtype,rtol", [("float32", 3e-5),
                                        ("bfloat16", 3e-2)])
@pytest.mark.parametrize("b,hkv,g,d,s,p,page", KERNEL_SHAPES)
def test_sparse_decode_attn_plain_matches_pallas(b, hkv, g, d, s, p, page,
                                                 dtype, rtol):
    rng = np.random.default_rng(s + p)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in
               ((b, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d)))
    idx = rng.integers(0, s // page, (b, hkv, p)).astype(np.int32)
    want = pallas_sparse_decode_attn(
        jnp.asarray(idx), *(jnp.asarray(x, _JNP[dtype]) for x in (q, k, v)),
        page_size=page)
    tq, tk, tv = (torch.from_numpy(x).to(_TORCH[dtype]) for x in (q, k, v))
    got = sparse_decode_attn_plain(torch.from_numpy(idx), tq, tk, tv,
                                   page_size=page)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=rtol)
    # the wrapper on CPU tensors is the plain version, uncounted
    n = sparse_decode_attn.launches
    same = sparse_decode_attn(torch.from_numpy(idx), tq, tk, tv,
                              page_size=page)
    assert torch.equal(same, got) and sparse_decode_attn.launches == n


def test_sparse_decode_attn_plain_int8_matches_pallas_on_dequantised_kv():
    """The Pallas kernel has no int8 scale; fed the dequantised K/V it
    computes what the plain version computes from int8."""
    b, hkv, g, d, s, p, page = KERNEL_SHAPES[1]
    rng = np.random.default_rng(5)
    q = rng.normal(size=(b, hkv, g, d)).astype(np.float32)
    k8, v8 = (ts.kv_quant(torch.from_numpy(
        rng.normal(size=(b, s, hkv, d)).astype(np.float32)), torch.int8)
        for _ in range(2))
    idx = rng.integers(0, s // page, (b, hkv, p)).astype(np.int32)
    want = pallas_sparse_decode_attn(
        jnp.asarray(idx), jnp.asarray(q),
        jnp.asarray(ts.kv_dequant_f32(k8).numpy()),
        jnp.asarray(ts.kv_dequant_f32(v8).numpy()), page_size=page)
    got = sparse_decode_attn_plain(torch.from_numpy(idx),
                                   torch.from_numpy(q), k8, v8,
                                   page_size=page)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


def test_sparse_decode_attn_with_pos_is_attend_pages_on_cpu():
    c = _contiguous_case(3, page=8)
    idx = torch.tensor(np.random.default_rng(3).integers(0, 4, (2, 2, 3)),
                       dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(c[n]) for n in ("q", "k", "v"))
    got = sparse_decode_attn(idx, tq, tk[0], tv[0], page_size=8, pos=19)
    assert torch.equal(got, ts.attend_pages(tq, tk[0], tv[0], idx, 19, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k", [(32, 128, 8), (64, 256, 24),
                                   (16, 512, 5)])
def test_gather_rows_plain_matches_pallas_bitwise(n, d, k, dtype):
    rng = np.random.default_rng(n + k)
    idx = rng.integers(0, n, k).astype(np.int32)
    tbl = rng.normal(size=(n, d)).astype(np.float32)
    want = pallas_gather_rows(jnp.asarray(idx),
                              jnp.asarray(tbl, _JNP[dtype]))
    t = torch.from_numpy(tbl).to(_TORCH[dtype])
    got = gather_rows_plain(torch.from_numpy(idx), t)
    np.testing.assert_array_equal(_np(got), _np(want))
    n0 = gather_rows.launches
    assert torch.equal(gather_rows(torch.from_numpy(idx).long(), t), got)
    assert gather_rows.launches == n0


def test_embed_is_the_table_lookup_bitwise(weights):
    cfg, _, tp = weights
    toks = torch.from_numpy(_tokens(cfg, 1, 3, 5))
    np.testing.assert_array_equal(
        tt.embed(tp, cfg, toks).numpy(), tp["embed"][toks].numpy())


# -- prefill, cache and decode -------------------------------------------------

def _jax_pad(cfg, cache, max_len):
    """The reference engine's ``_pad_cache``."""
    l, b, s, kv, hd = cache["k"].shape
    pad = max_len - s
    z = jnp.zeros((l, b, pad, kv, hd), cache["k"].dtype)
    out = dict(cache, k=jnp.concatenate([cache["k"], z], 2),
               v=jnp.concatenate([cache["v"], z], 2))
    if "kpage" in cache:
        npad = max_len // cfg.kv_page - cache["kpage"].shape[2]
        out["kpage"] = jnp.concatenate(
            [cache["kpage"], jnp.zeros((l, b, npad, kv, hd))], 2)
    return out


def _assert_cache_close(tc, jc):
    for key in ("k", "v", "kpage"):
        if tc[key].dtype == torch.int8:
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))
        else:
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL)
    assert tc["pos"] == int(jc["pos"])


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_make_cache_matches_reference(weights, kv_dtype):
    cfg = replace(weights[0], kv_dtype=kv_dtype)
    rng = np.random.default_rng(2)
    k, v = (rng.normal(size=(2, 2, 16, 2, 32)).astype(np.float32)
            for _ in range(2))
    jc = _jax_pad(cfg, jt.make_cache(cfg, jnp.asarray(k), jnp.asarray(v),
                                     16), 24)
    tc = tt.make_cache(cfg, torch.from_numpy(k), torch.from_numpy(v), 16,
                       max_len=24)
    _assert_cache_close(tc, jc)
    with pytest.raises(ValueError, match="kv_page"):
        tt.make_cache(cfg, torch.from_numpy(k[:, :, :14]),
                      torch.from_numpy(v[:, :, :14]), 14)


def test_prefill_matches_reference(weights):
    cfg, jp, tp = weights
    toks = _tokens(cfg, 3, 2, 16)
    jl, jc = jt.prefill(jp, cfg, jnp.asarray(toks))
    tl, tc = api.prefill_fn(cfg, tp, {"tokens": torch.from_numpy(toks)},
                            max_len=28)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache_close(tc, _jax_pad(cfg, jc, 28))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_decode_step_matches_reference(weights, sparse, kv_dtype):
    cfg, jp, tp = weights
    cfg = replace(cfg, kv_dtype=kv_dtype)
    toks = _tokens(cfg, 4, 2, 20)
    jl, jc = jt.prefill(jp, cfg, jnp.asarray(toks))
    jc = _jax_pad(cfg, jc, 32)
    tl, tc = tt.prefill(tp, cfg, torch.from_numpy(toks), max_len=32)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, -1))
        assert np.array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jc = jt.decode_step(jp, cfg, jc, jnp.asarray(nxt), sparse=sparse)
        tl, tc = tt.decode_step(tp, cfg, tc, torch.from_numpy(nxt),
                                sparse=sparse)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache_close(tc, jc)


# -- the single-batch Engine ---------------------------------------------------

def _proxy_selection(cfg, kpage0, pos, select, ones):
    """The engine's ``_track_pages`` selection: the layer-0 label cache
    scored against an all-ones query, before the step."""
    b = kpage0.shape[0]
    q = ones((b, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd))
    return np.asarray(select(q, kpage0, pos // cfg.kv_page + 1,
                             min(cfg.kv_topk_pages, kpage0.shape[1])))


def _run_jax(cfg, jp, toks, gen, **kw):
    eng = JaxEngine(cfg, jp, **kw)
    logits, sels = [], []
    decode, track = eng._decode, eng._track_pages

    def dec(p, c, t):
        lg, c2 = decode(p, c, t)
        logits.append(np.asarray(lg))
        return lg, c2

    def trk():
        sels.append(_proxy_selection(
            cfg, eng.cache["kpage"][0], eng.cache["pos"], js.select_pages,
            lambda s: jnp.ones(s, jnp.float32)))
        track()
    eng._decode, eng._track_pages = dec, trk
    out = eng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, gen)
    return eng, out, logits, sels


def _run_port(cfg, tp, toks, gen, **kw):
    eng = Engine(cfg, tp, device="cpu", **kw)
    logits, sels = [], []
    step, track = eng.step, eng._track_pages

    def stp():
        out = step()
        logits.append(eng.logits.numpy())
        return out

    def trk():
        sels.append(_proxy_selection(
            cfg, eng.cache["kpage"][0], eng.cache["pos"], ts.select_pages,
            lambda s: torch.ones(s)))
        track()
    eng.step, eng._track_pages = stp, trk
    out = eng.generate({"tokens": toks}, gen)
    return eng, out, logits, sels


ENGINE_CASES = {
    "sparse": dict(sparse=True, max_len=64, nsb_pages=32),
    "dense": dict(sparse=False, max_len=64),
    "sparse_int8_kv": dict(sparse=True, max_len=48, nsb_pages=8,
                           kv="int8"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_generate_matches_reference(weights, case):
    cfg, jp, tp = weights
    kw = dict(ENGINE_CASES[case])
    if kw.pop("kv", None):
        cfg = replace(cfg, kv_dtype="int8")
    toks = _tokens(cfg, 5, 2, 32)
    je, jout, jlog, jsel = _run_jax(cfg, jp, toks, 12, **kw)
    te, tout, tlog, tsel = _run_port(cfg, tp, toks, 12, **kw)
    np.testing.assert_array_equal(tout, jout)
    assert len(tlog) == len(jlog) == 11
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a, b, **LOGIT_TOL)
    assert len(tsel) == len(jsel) == (11 if te.sparse else 0)
    for a, b in zip(tsel, jsel):
        np.testing.assert_array_equal(a, b)
    assert vars(te.stats) == vars(je.stats) and te.sparse == je.sparse
    assert te.stats.hot_hit_rate == je.stats.hot_hit_rate


def test_engine_cuda_route_equals_torch_route_on_cpu(weights):
    cfg, _, tp = weights
    toks = _tokens(cfg, 6, 2, 24)
    a = Engine(cfg, tp, max_len=32, kernel="cuda", device="cpu")
    b = Engine(cfg, tp, max_len=32, kernel="torch", device="cpu")
    np.testing.assert_array_equal(a.generate({"tokens": toks}, 6),
                                  b.generate({"tokens": toks}, 6))
    assert torch.equal(a.logits, b.logits) and a.stats == b.stats


def test_full_coverage_sparse_equals_dense(weights):
    """The reference's promise (``test_models.py``): with TopK covering
    every page, sparse decode is dense decode, within 3e-3; the tokens
    then agree (``test_system.py`` asks > 0.9)."""
    cfg, _, tp = weights
    cfg = replace(cfg, kv_topk_pages=16)             # 64 / 4 pages: all
    toks = _tokens(cfg, 7, 2, 32)
    dense = Engine(cfg, tp, max_len=64, sparse=False, device="cpu")
    sparse = Engine(cfg, tp, max_len=64, sparse=True, device="cpu")
    for eng in (dense, sparse):
        eng.prefill({"tokens": toks})
        eng.step()
    np.testing.assert_allclose(sparse.logits.numpy(), dense.logits.numpy(),
                               rtol=3e-3, atol=3e-3)
    out_d = Engine(cfg, tp, max_len=48, sparse=False,
                   device="cpu").generate({"tokens": toks}, 12)
    out_s = Engine(cfg, tp, max_len=48, sparse=True,
                   device="cpu").generate({"tokens": toks}, 12)
    assert (out_d == out_s).mean() > 0.9


def test_nsb_hit_rate_above_half(weights):
    """The reference's promise (``test_system.py``): decode TopK
    selections reuse pages step to step."""
    cfg, _, tp = weights
    eng = Engine(cfg, tp, max_len=64, sparse=True, nsb_pages=32,
                 device="cpu")
    eng.generate({"tokens": _tokens(cfg, 8, 2, 32)}, 16)
    assert eng.stats.pages_touched > 0
    assert eng.stats.hot_hit_rate > 0.5


def test_moe_engine_matches_reference():
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    jp = jt.init_params(cfg, jax.random.PRNGKey(0))
    tp = from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens(cfg, 9, 2, 16)
    kw = dict(sparse=True, max_len=32, nsb_pages=16)
    je, jout, jlog, _ = _run_jax(cfg, jp, toks, 6, **kw)
    te, tout, tlog, _ = _run_port(cfg, tp, toks, 6, **kw)
    np.testing.assert_array_equal(tout, jout)
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a, b, **LOGIT_TOL)
    assert vars(te.stats) == vars(je.stats)


def test_engine_validation(weights):
    cfg, _, tp = weights
    with pytest.raises(NotImplementedError, match="3. Online runahead"):
        Engine(cfg, tp, max_len=32, capture_trace=True, device="cpu")
    for arch in ("mamba2-130m", "qwen2-vl-72b"):
        other = t_get_config(arch).reduced()
        with pytest.raises(NotImplementedError, match="7. The single-batch"):
            Engine(other, {}, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="kv_page"):
        Engine(cfg, tp, max_len=30, device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        Engine(cfg, tp, max_len=32, kernel="xla", device="cpu")
    eng = Engine(cfg, tp, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.prefill({"tokens": _tokens(cfg, 1, 1, 20)})
    eng.generate({"tokens": _tokens(cfg, 1, 1, 12)}, 5)
    with pytest.raises(ValueError, match="cache is full"):
        eng.step()


def test_single_batch_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_get_config("qwen2-1.5b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, max_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(cfg, 1, 32)
    with pytest.raises(RuntimeError):
        tserve.main(["--arch", "qwen2-1.5b", "--reduced", "--batch", "2"])


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_launcher_single_batch_on_cpu(capsys, dense):
    eng = tserve.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "32", "--gen",
                       "8"] + (["--dense"] if dense else []))
    out = capsys.readouterr().out
    assert f"generated (2, 8) tokens; sparse={not dense}" in out
    assert ("NSB hot-set hit rate" in out) is not dense
    assert isinstance(eng, Engine) and eng.stats.steps == 7
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                     "--expert-pool", "paged"])
