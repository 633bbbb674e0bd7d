"""The MoE slice: the port's expert weights, capacity dispatch, paged
expert pool, MoE kernels' plain versions and MoE serve path against the
JAX reference on reduced qwen3-moe-235b-a22b in float32, with the same
weights (``from_jax``) and inputs made with numpy, on the CPU.

Held exactly: the pool layout, routed expert ids, capacity drops,
tokens and expert-page accounting.  Held to 1e-6 (gates), 1e-5
(FFN outputs; the reference's own Pallas kernel differs from its
oracle by up to 7.6e-6, so the kernels' plain versions are held to a
tolerance too) and 1e-4 (serve logits, as the dense slice).  Within the
port, dense and paged experts are bitwise equal."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serve import expert_pool as jpool
from repro.serve.engine import PagedEngine as JaxEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import moe_dispatch
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.params import (expert_rows, from_jax, init_params,
                                pack_experts)
from repro_torch.serve import expert_pool as tpool
from repro_torch.serve.engine import PagedEngine

ARCH = "qwen3-moe-235b-a22b"
FFN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    cfg = get_config(ARCH).reduced()
    jp = jt.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _layer(tree, li):
    return {k: v[li] for k, v in tree["layers"].items()}


def _x(cfg, seed, *shape):
    return np.random.default_rng(seed).normal(
        size=(*shape, cfg.d_model)).astype(np.float32)


# -- weights -------------------------------------------------------------------

def test_from_jax_keeps_router_float32_and_packs_experts():
    cfg = replace(get_config(ARCH).reduced(), param_dtype="bfloat16")
    npp = jax.tree.map(np.asarray, jt.init_params(cfg, jax.random.PRNGKey(1)))
    tp = from_jax(npp, device="cpu", dtype=torch.bfloat16)
    lp = tp["layers"]
    assert lp["router"].dtype == torch.float32
    np.testing.assert_array_equal(lp["router"].numpy(),
                                  npp["layers"]["router"])
    assert lp["we_gate"].dtype == lp["wq"].dtype == torch.bfloat16
    assert expert_rows(lp) is not None
    for k in ("we_gate", "we_up", "we_down"):
        np.testing.assert_array_equal(
            lp[k].float().numpy(), npp["layers"][k].astype(np.float32))


def test_init_params_moe_matches_reference_shapes():
    cfg = t_get_config(ARCH).reduced()
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax.tree.map(np.asarray, jt.init_params(get_config(ARCH).reduced(),
                                                 jax.random.PRNGKey(0)))
    assert tp["layers"].keys() == jp["layers"].keys()
    for k, v in jp["layers"].items():
        assert tuple(tp["layers"][k].shape) == v.shape, k
        assert str(tp["layers"][k].dtype).endswith(str(v.dtype)), k
    rows = expert_rows(tp["layers"])
    f = cfg.d_ff_expert
    assert rows is not None and not rows[:f].any()
    assert tp["layers"]["we_down"].std().item() == pytest.approx(
        f ** -0.5, rel=0.1)
    # bf16 weights keep a float32 router
    t16 = init_params(replace(cfg, param_dtype="bfloat16"),
                      torch.Generator().manual_seed(0), "cpu")
    assert t16["layers"]["router"].dtype == torch.float32
    assert t16["layers"]["we_up"].dtype == torch.bfloat16


def test_pack_experts_copies_unpacked_weights_once(weights):
    _, _, tp = weights
    loose = {k: (v.clone() if k.startswith("we_") else v)
             for k, v in tp["layers"].items()}
    assert expert_rows(loose) is None
    packed = pack_experts(loose)
    assert expert_rows(packed) is not None
    for k in ("we_gate", "we_up", "we_down"):
        assert torch.equal(packed[k], tp["layers"][k])
    assert pack_experts(packed) is packed


# -- the pool ------------------------------------------------------------------

@pytest.mark.parametrize("tile_rows", [16, 32, 128])
def test_pool_layout_matches_reference(weights, tile_rows):
    cfg, jp, tp = weights
    ref = jpool.ExpertPool(cfg, jp, tile_rows=tile_rows)
    ep = tpool.ExpertPool(cfg, tp, tile_rows=tile_rows)
    assert (ep.n_pages, ep.nt, ep.pages_per_expert, ep.page_bytes,
            ep.pool_bytes) == (ref.n_pages, ref.nt, ref.pages_per_expert,
                               ref.page_bytes, ref.pool_bytes)
    assert ep.block_table.dtype == np.int32
    np.testing.assert_array_equal(ep.block_table, ref.block_table)
    for li in range(cfg.n_layers):
        np.testing.assert_array_equal(ep.pages_for_experts(li, [3, 0, 2]),
                                      ref.pages_for_experts(li, [3, 0, 2]))
    np.testing.assert_array_equal(ep.pool.numpy(), np.asarray(ref.pool))
    np.testing.assert_array_equal(ep.dense_rows().numpy(),
                                  np.asarray(ref.dense_rows()))


def test_pool_wraps_the_params_without_a_copy(weights):
    cfg, _, tp = weights
    ep = tpool.ExpertPool(cfg, tp)
    ptr = tp["layers"]["we_down"].untyped_storage().data_ptr()
    assert ep.pool.untyped_storage().data_ptr() == ptr
    assert ep.dense_rows().untyped_storage().data_ptr() == ptr
    assert not ep.pool[0].any()


def test_pool_refusals(weights):
    cfg, _, tp = weights
    with pytest.raises(ValueError, match="must divide"):
        tpool.ExpertPool(cfg, tp, tile_rows=24)
    with pytest.raises(NotImplementedError, match="ROADMAP slice"):
        tpool.ExpertPool(cfg, tp, nsb_slots=8)
    loose = {"layers": {k: v.clone() for k, v in tp["layers"].items()}}
    with pytest.raises(ValueError, match="packed"):
        tpool.ExpertPool(cfg, loose)


# -- routing and the expert FFNs -----------------------------------------------

def test_route_matches_reference(weights):
    cfg, jp, tp = weights
    x = _x(cfg, 4, 9)
    for li in range(cfg.n_layers):
        jg, je = jpool.route(jnp.asarray(x), jp["layers"]["router"][li],
                             cfg.top_k)
        tg, te = tpool.route(torch.from_numpy(x), tp["layers"]["router"][li],
                             cfg.top_k)
        assert te.dtype == torch.int32
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("b,s,factor", [(3, 16, 1.25), (2, 64, 1.25),
                                        (2, 64, 0.25), (4, 1, 1.25)])
def test_moe_ffn_matches_reference(weights, b, s, factor):
    """The capacity dispatch: the same plan (drops included) and the
    same outputs; factor 0.25 on 64 tokens drops pairs."""
    cfg, jp, tp = weights
    x = _x(cfg, 5 + s, b, s)
    e, k = cfg.n_experts, cfg.top_k
    cap = tmoe._capacity(s, k, e, factor)
    assert cap == jmoe._capacity(s, k, e, factor)
    for li in range(cfg.n_layers):
        router = jp["layers"]["router"][li]
        want_plan = [np.asarray(a) for a in jax.vmap(
            lambda xr: jmoe._route_row(xr, router, e, k, cap))(
                jnp.asarray(x))]
        slot, keep, pair_token, order, gates, _ = tmoe._route_row(
            torch.from_numpy(x), tp["layers"]["router"][li], k, cap)
        for got, want in zip((slot, keep, pair_token, order),
                             (want_plan[0], want_plan[1], want_plan[2],
                              want_plan[4])):
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_allclose(gates.numpy(), want_plan[3], rtol=1e-6,
                                   atol=1e-6)
        if factor < 1:
            assert not keep.all()
        want = np.asarray(jmoe.moe_ffn(jnp.asarray(x), _layer(jp, li), cfg,
                                       factor))
        got = tmoe.moe_ffn(torch.from_numpy(x), _layer(tp, li), cfg, factor)
        np.testing.assert_allclose(got.numpy(), want, **FFN_TOL)


@pytest.mark.parametrize("route", ["dense", "paged-torch", "paged-cuda"])
def test_expert_ffn_matches_reference(weights, route):
    """``paged-cuda`` is the kernel route, whose wrappers run their plain
    versions on CPU tensors."""
    cfg, jp, tp = weights
    ref = jpool.ExpertPool(cfg, jp)
    ep = tpool.ExpertPool(cfg, tp)
    x = _x(cfg, 6, 5, 1)
    for li in range(cfg.n_layers):
        want, je = jpool.paged_moe_ffn(
            jnp.asarray(x), jax.tree.map(lambda a: a[li], jp["layers"]),
            ref.table_device()[li], ref.pool, cfg)
        if route == "dense":
            got, te = tpool.dense_moe_ffn(torch.from_numpy(x), _layer(tp, li),
                                          ep.dense_rows()[li], cfg)
        else:
            got, te = tpool.paged_moe_ffn(
                torch.from_numpy(x), _layer(tp, li), ep.table_device()[li],
                ep.pool, cfg, kernel=route.split("-")[1])
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)


def test_dense_and_paged_ffn_bitwise(weights):
    cfg, _, tp = weights
    ep = tpool.ExpertPool(cfg, tp, tile_rows=16)
    x = torch.from_numpy(_x(cfg, 7, 6, 1))
    for li in range(cfg.n_layers):
        yd, ed = tpool.dense_moe_ffn(x, _layer(tp, li), ep.dense_rows()[li],
                                     cfg)
        yp, epids = tpool.paged_moe_ffn(x, _layer(tp, li),
                                        ep.table_device()[li], ep.pool, cfg,
                                        kernel="torch")
        assert torch.equal(yd, yp) and torch.equal(ed, epids)


def test_kernel_route_probe_sees_the_kernels_operands(weights):
    cfg, _, tp = weights
    ep = tpool.ExpertPool(cfg, tp)
    seen = []
    x = torch.from_numpy(_x(cfg, 8, 3, 1))
    tpool.paged_moe_ffn(x, _layer(tp, 1), ep.table_device()[1], ep.pool,
                        cfg, probe=seen.append)
    (p,) = seen
    assert p["pids"].shape == (3, cfg.top_k, 3, ep.nt)
    assert p["h"].shape == (3, cfg.top_k, cfg.d_ff_expert)
    torch.testing.assert_close(p["h"], torch.nn.functional.silu(p["g"])
                               * p["u"])


# -- the kernels' plain versions -----------------------------------------------

@pytest.mark.parametrize("tile_rows", [16, 32])
@pytest.mark.parametrize("r,k", [(1, 1), (4, 2), (7, 3)])
def test_kernel_plain_versions_match_reference_oracles(weights, tile_rows, r,
                                                       k):
    cfg, jp, tp = weights
    ep = tpool.ExpertPool(cfg, tp, tile_rows=tile_rows)
    rng = np.random.default_rng(r * 10 + k)
    pids = rng.integers(0, ep.n_pages, size=(r, k, ep.nt)).astype(np.int32)
    x = rng.normal(size=(r, cfg.d_model)).astype(np.float32)
    h = rng.normal(size=(r, k, ep.nt * tile_rows)).astype(np.float32)
    pool = ep.pool.numpy()
    want_g = jref.moe_paged_gateup_ref(jnp.asarray(pids), jnp.asarray(x),
                                       jnp.asarray(pool))
    want_d = jref.moe_paged_down_ref(jnp.asarray(pids), jnp.asarray(h),
                                     jnp.asarray(pool))
    tids = torch.from_numpy(pids)
    got_g = moe_dispatch.moe_paged_gateup_plain(tids, torch.from_numpy(x),
                                                ep.pool)
    got_d = moe_dispatch.moe_paged_down_plain(tids, torch.from_numpy(h),
                                              ep.pool)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **FFN_TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **FFN_TOL)


def test_wrappers_run_plain_versions_on_cpu_without_counting(weights):
    cfg, _, tp = weights
    ep = tpool.ExpertPool(cfg, tp)
    pids = torch.ones((2, 2, ep.nt), dtype=torch.int32)
    x = torch.randn(2, cfg.d_model)
    before = (moe_dispatch.moe_paged_gateup.launches,
              moe_dispatch.moe_paged_down.launches)
    g = moe_dispatch.moe_paged_gateup(pids, x, ep.pool)
    y = moe_dispatch.moe_paged_down(pids, g, ep.pool)
    assert torch.equal(g, moe_dispatch.moe_paged_gateup_plain(pids, x,
                                                              ep.pool))
    assert torch.equal(y, moe_dispatch.moe_paged_down_plain(pids, g, ep.pool))
    assert (moe_dispatch.moe_paged_gateup.launches,
            moe_dispatch.moe_paged_down.launches) == before


# -- the serve path ------------------------------------------------------------

@pytest.fixture(scope="module")
def workload(weights):
    cfg = weights[0]
    rng = np.random.default_rng(5)
    return [(0.0, rng.integers(1, cfg.vocab, size=int(n)), int(g))
            for n, g in zip(rng.integers(6, 20, size=6),
                            rng.integers(4, 9, size=6))]


def _engine_kw(**kw):
    return {"max_len": 48, "n_pages": 24, "max_batch": 4, "chunk": 16,
            "expert_nsb_slots": 80, **kw}


def _run(engine_cls, cfg, params, work, **kw):
    eng = engine_cls(cfg, params, **kw)
    eng.run([(t, p.copy(), g) for t, p, g in work])
    return eng


@pytest.mark.parametrize("mode", ["off", "dense", "paged"])
def test_engine_matches_reference(weights, workload, mode):
    cfg, jp, tp = weights
    je = _run(JaxEngine, cfg, jp, workload,
              **_engine_kw(expert_pool=mode, kernel="xla"))
    te = _run(PagedEngine, cfg, tp, workload,
              **_engine_kw(expert_pool=mode, device="cpu"))
    assert te.requests.keys() == je.requests.keys()
    for rid, a in je.requests.items():
        b = te.requests[rid]
        assert b.out_tokens == a.out_tokens, rid
        np.testing.assert_allclose(b.last_logits, a.last_logits, **LOGIT_TOL)
    for f in ("expert_pages_touched", "expert_nsb_hits", "expert_nsb_misses",
              "nsb_hits", "nsb_misses", "steps", "iter_log"):
        assert getattr(te.stats, f) == getattr(je.stats, f), f
    jm, tm = je.metrics(), te.metrics()
    keys = ["expert_pool", "n_finished", "tokens_out"]
    if mode != "off":
        keys += ["expert_pages_touched", "expert_nsb_hit_rate",
                 "expert_demand_lru_hit_rate", "expert_pool_pages",
                 "expert_pool_mib", "expert_tile_rows",
                 "expert_runahead_mode"]
        assert 0 < tm["expert_nsb_hit_rate"] < 1
    for k in keys:
        assert tm[k] == jm[k], k


@pytest.mark.parametrize("n_pages", [24, 1 + 8])
def test_engine_dense_equals_paged_bitwise(weights, workload, n_pages):
    """Dense and paged experts read the same bytes into the same math,
    with and without preemption."""
    cfg, _, tp = weights
    kw = _engine_kw(n_pages=n_pages, device="cpu", kernel="torch")
    dense = _run(PagedEngine, cfg, tp, workload, expert_pool="dense", **kw)
    paged = _run(PagedEngine, cfg, tp, workload, expert_pool="paged", **kw)
    if n_pages < 24:
        assert paged.scheduler.n_preemptions > 0
    for rid, a in dense.requests.items():
        b = paged.requests[rid]
        assert a.out_tokens == b.out_tokens, rid
        assert np.array_equal(a.last_logits, b.last_logits), rid
    assert (dense.stats.expert_pages_touched
            == paged.stats.expert_pages_touched > 0)


def test_engine_returns_routed_ids_per_layer(weights, workload):
    cfg, _, tp = weights
    eng = PagedEngine(cfg, tp, **_engine_kw(expert_pool="paged",
                                            device="cpu"))
    seen = []
    orig = eng._commit_decode

    def wrapped(pairs, logits, sel, rb, esel=None):
        seen.append((len(pairs), rb, esel))
        return orig(pairs, logits, sel, rb, esel)
    eng._commit_decode = wrapped
    eng.run([(t, p.copy(), g) for t, p, g in workload])
    assert seen
    for _, rb, esel in seen:
        assert esel.shape == (cfg.n_layers, rb, cfg.top_k)
        assert esel.dtype == torch.int32
        assert ((esel >= 0) & (esel < cfg.n_experts)).all()


def test_engine_expert_validation(weights):
    cfg, _, tp = weights
    with pytest.raises(ValueError, match="expert_pool must be"):
        PagedEngine(cfg, tp, **_engine_kw(expert_pool="bogus", device="cpu"))
    with pytest.raises(ValueError, match="expert_runahead must be"):
        PagedEngine(cfg, tp, **_engine_kw(expert_runahead="bogus",
                                          device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP slice"):
        PagedEngine(cfg, tp, **_engine_kw(expert_pool="paged",
                                          expert_runahead="router",
                                          device="cpu"))
    dense_cfg = t_get_config("qwen2-1.5b").reduced()
    dp = init_params(dense_cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="MoE-family"):
        PagedEngine(dense_cfg, dp, max_len=48, expert_pool="paged",
                    device="cpu")


def test_launcher_moe_on_cpu(capsys):
    eng = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--continuous", "--requests", "5", "--prompt-len",
                       "16", "--gen", "4", "--expert-pool", "paged",
                       "--layers", "1"])
    out = capsys.readouterr().out
    assert "5/5 requests" in out and "expert pool=paged" in out
    m = eng.metrics()
    assert eng.cfg.n_layers == 1 and eng.ep.n_layers == 1
    assert m["expert_pool"] == "paged" and m["expert_pages_touched"] > 0
