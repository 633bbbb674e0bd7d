"""The slice as a whole: the port's ``PagedEngine`` against the JAX
reference's ``PagedEngine(kernel="xla")`` on reduced qwen2-1.5b with the
same weights (``from_jax``) and the same Poisson workloads, on the CPU.

Held exactly: tokens per request, the layer-0 TopK physical selection of
every decode step, NSB hits and misses, and the allocator's and
scheduler's decisions.  Held to 1e-4: the last logits (float32).  The
reference's own bitwise claims under preemption fail on this tree, so
the preemption and prefix-cache guarantees are proven within the port,
torch against torch, bitwise (preemption at a fixed decode batch shape:
a row bucket of another size changes the GEMM's M, which may round a
row differently)."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import transformer as jt
from repro.serve.engine import PagedEngine as JaxEngine
from repro.serve.scheduler import PoissonArrivals
from repro_torch.launch import serve as tserve
from repro_torch.params import from_jax
from repro_torch.serve.engine import PagedEngine

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("qwen2-1.5b").reduced()
    jp = jt.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _poisson(cfg, seed, n, shared_prefix=0, prompt_len=20, gen=6):
    """The reference launcher's --continuous workloads."""
    rng = np.random.default_rng(seed)
    if shared_prefix:
        sys_len = max(cfg.kv_page, prompt_len // 2 // cfg.kv_page
                      * cfg.kv_page)
        sys_prompts = [rng.integers(1, cfg.vocab, size=sys_len)
                       for _ in range(shared_prefix)]
        arr = PoissonArrivals(n, rate=0.5, prompt_len=(1, prompt_len
                                                       - sys_len),
                              gen_len=(gen // 2, gen), seed=seed)
        return [(t, np.concatenate([sys_prompts[i % shared_prefix],
                                    rng.integers(1, cfg.vocab, size=p)]), g)
                for i, (t, p, g) in enumerate(arr)]
    arr = PoissonArrivals(n, rate=0.5, prompt_len=(prompt_len // 2,
                                                   prompt_len),
                          gen_len=(gen // 2, gen), seed=seed)
    return [(t, rng.integers(1, cfg.vocab, size=p), g) for t, p, g in arr]


def _record_selections(eng, to_np):
    """Wrap ``_commit_decode`` to keep each decode row's layer-0 TopK
    physical ids, keyed by (iteration, rid)."""
    rec = {}
    orig = eng._commit_decode

    def wrapped(pairs, logits, sel, rb, *rest):
        s0 = to_np(sel)
        for slot, req in pairs:
            rec[(eng.now, req.rid)] = s0[slot].copy()
        return orig(pairs, logits, sel, rb, *rest)
    eng._commit_decode = wrapped
    return rec


def _run_port(cfg, params, work, **kw):
    kw = {"max_len": 48, "max_batch": 4, "chunk": 8, "nsb_pages": 32,
          "device": "cpu", **kw}
    eng = PagedEngine(cfg, params, **kw)
    rec = _record_selections(eng, lambda s: s.numpy())
    eng.run([(t, p.copy(), g) for t, p, g in work])
    return eng, rec


def _run_jax(cfg, params, work):
    eng = JaxEngine(cfg, params, max_len=48, max_batch=4, chunk=8,
                    nsb_pages=32, kernel="xla")
    rec = _record_selections(eng, lambda s: np.asarray(s[0]))
    eng.run([(t, p.copy(), g) for t, p, g in work])
    return eng, rec


CASES = {
    "shared_prefix": dict(seed=3, n=8, shared_prefix=2),
    "independent": dict(seed=4, n=8),
    "int8_kv": dict(seed=5, n=6, shared_prefix=2, kv="int8"),
    "long_prompts": dict(seed=6, n=5, prompt_len=36, gen=8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_engine_matches_reference(weights, case):
    cfg, jp, tp = weights
    spec = dict(CASES[case])
    if spec.pop("kv", None):
        cfg = replace(cfg, kv_dtype="int8")
    work = _poisson(cfg, **spec)
    je, jrec = _run_jax(cfg, jp, work)
    te, trec = _run_port(cfg, tp, work)
    assert te.requests.keys() == je.requests.keys()
    for rid, a in je.requests.items():
        b = te.requests[rid]
        assert b.out_tokens == a.out_tokens, rid
        np.testing.assert_allclose(b.last_logits, a.last_logits,
                                   **LOGIT_TOL)
        assert (b.admitted_at, b.first_token_at, b.finished_at,
                b.n_preemptions) == (a.admitted_at, a.first_token_at,
                                     a.finished_at, a.n_preemptions)
    # the per-step layer-0 TopK, exactly
    assert trec.keys() == jrec.keys() and trec
    for key, sel in jrec.items():
        np.testing.assert_array_equal(trec[key], sel, err_msg=str(key))
    # NSB accounting and the allocator's / scheduler's decisions
    for f in ("nsb_hits", "nsb_misses", "pages_touched", "pages_unique",
              "iterations", "steps", "prefill_tokens", "prefill_calls",
              "decode_rows_padded", "cow_page_copies", "iter_log"):
        assert getattr(te.stats, f) == getattr(je.stats, f), f
    assert te.allocator.stats.__dict__ == je.allocator.stats.__dict__
    assert te.scheduler.n_preemptions == je.scheduler.n_preemptions
    assert (te.scheduler.prefill_tokens_skipped
            == je.scheduler.prefill_tokens_skipped)
    jm, tm = je.metrics(), te.metrics()
    for k in ("n_finished", "tokens_out", "p50_latency", "p99_ttft",
              "p50_tpot", "nsb_hot_hit_rate", "offchip_fetch_reduction",
              "pages_peak_in_use", "kv_pool_mib", "prefix_hit_pages"):
        assert tm[k] == jm[k], k


def _assert_bitwise(a_eng, b_eng):
    for rid, a in a_eng.requests.items():
        b = b_eng.requests[rid]
        assert a.out_tokens == b.out_tokens, rid
        assert np.array_equal(a.last_logits, b.last_logits), rid


@pytest.fixture(scope="module")
def prefix_work(weights):
    cfg = weights[0]
    rng = np.random.default_rng(11)
    sys_prompts = [rng.integers(1, cfg.vocab, size=12) for _ in range(2)]
    return [(0.5 * i, np.concatenate(
        [sys_prompts[i % 2],
         rng.integers(1, cfg.vocab, size=int(rng.integers(2, 6)))]), 5)
        for i in range(6)]


def test_prefix_cache_on_equals_off_bitwise(weights, prefix_work):
    cfg, _, tp = weights
    off, _ = _run_port(cfg, tp, prefix_work, prefix_cache=False)
    on, _ = _run_port(cfg, tp, prefix_work, prefix_cache=True)
    assert on.allocator.stats.prefix_hits > 0
    assert on.scheduler.prefill_tokens_skipped > 0
    assert (on.stats.prefill_tokens == off.stats.prefill_tokens
            - on.scheduler.prefill_tokens_skipped)
    _assert_bitwise(off, on)


def test_full_prompt_hit_copies_on_write_bitwise(weights):
    cfg, _, tp = weights
    prompt = np.random.default_rng(13).integers(1, cfg.vocab, size=16)
    work = [(0.0, prompt, 4), (4.0, prompt.copy(), 4)]
    off, _ = _run_port(cfg, tp, work, prefix_cache=False)
    on, _ = _run_port(cfg, tp, work, prefix_cache=True)
    assert on.stats.cow_page_copies >= 1
    _assert_bitwise(off, on)


def _preemption_work(cfg):
    rng = np.random.default_rng(7)
    return [(0.0, rng.integers(1, cfg.vocab, size=int(p)), 6)
            for p in rng.integers(10, 22, size=3)]


def test_forced_preemption_recompute_bitwise(weights):
    """Recompute replays every token through the same functions; with a
    fixed decode batch shape each row's arithmetic is the same, so the
    resumed run is bitwise the calm one."""
    cfg, _, tp = weights
    work = _preemption_work(cfg)
    calm, _ = _run_port(cfg, tp, work, row_bucketing=False)
    tight, _ = _run_port(cfg, tp, work, n_pages=1 + 11, row_bucketing=False)
    assert calm.scheduler.n_preemptions == 0
    assert tight.scheduler.n_preemptions > 0
    _assert_bitwise(calm, tight)
    assert tight.allocator.pages_in_use == 0


def test_forced_preemption_with_row_buckets_within_rounding(weights):
    """With row buckets a replayed token may run in a batch of another
    bucket size, and the CPU GEMM rounds a row differently for another
    M: tokens stay equal, logits agree to float32 rounding (1e-5)."""
    cfg, _, tp = weights
    work = _preemption_work(cfg)
    calm, _ = _run_port(cfg, tp, work)
    tight, _ = _run_port(cfg, tp, work, n_pages=1 + 11)
    assert tight.scheduler.n_preemptions > 0
    for rid, a in calm.requests.items():
        b = tight.requests[rid]
        assert a.out_tokens == b.out_tokens
        np.testing.assert_allclose(a.last_logits, b.last_logits,
                                   rtol=1e-5, atol=1e-5)


def test_preempting_shared_pages_bitwise(weights, prefix_work):
    cfg, _, tp = weights
    base, _ = _run_port(cfg, tp, prefix_work, prefix_cache=False,
                        row_bucketing=False)
    tight, _ = _run_port(cfg, tp, prefix_work, n_pages=1 + 9,
                         row_bucketing=False)
    assert tight.scheduler.n_preemptions > 0
    assert tight.allocator.stats.prefix_hits > 0
    _assert_bitwise(base, tight)


def test_plain_kernel_route_equals_wrapper_route_on_cpu(weights,
                                                        prefix_work):
    cfg, _, tp = weights
    a, _ = _run_port(cfg, tp, prefix_work, kernel="cuda")
    b, _ = _run_port(cfg, tp, prefix_work, kernel="torch")
    _assert_bitwise(a, b)


def test_bf16_serve_runs_and_drains(weights, prefix_work):
    cfg, _, tp = weights
    cfg16 = replace(cfg, param_dtype="bfloat16")
    tp16 = {k: (v.to(torch.bfloat16) if not isinstance(v, dict) else
                {kk: vv.to(torch.bfloat16) if not kk.startswith("ln")
                 else vv for kk, vv in v.items()})
            for k, v in tp.items()}
    eng, _ = _run_port(cfg16, tp16, prefix_work)
    assert eng.k_pool.dtype == torch.bfloat16
    assert all(r.done and np.isfinite(r.last_logits).all()
               for r in eng.requests.values())
    assert eng.allocator.pages_in_use == 0


def test_metrics_and_validation(weights):
    cfg, _, tp = weights
    eng = PagedEngine(cfg, tp, max_len=48, n_pages=1 + 4, max_batch=2,
                      chunk=8, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.arange(1, 30), max_new_tokens=10)
    m = eng.metrics()
    assert m["n_finished"] == 0 and m["nsb_hot_hit_rate"] is None
    with pytest.raises(ValueError):
        PagedEngine(cfg, tp, max_len=50, device="cpu")
    with pytest.raises(ValueError):
        PagedEngine(cfg, tp, max_len=48, kernel="xla", device="cpu")


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()}, {"runahead": "nvr"}, {"spill_pages": 8},
    {"executor": "async"}, {"expert_runahead": "router"},
    {"capture_trace": True}, {"session_hold": True}],
    ids=lambda k: next(iter(k)))
def test_later_slice_arguments_raise(weights, kwargs):
    cfg, _, tp = weights
    with pytest.raises(NotImplementedError, match="ROADMAP slice"):
        PagedEngine(cfg, tp, max_len=48, device="cpu", **kwargs)


def test_launcher_on_cpu(capsys):
    eng = tserve.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                       "cpu", "--continuous", "--requests", "6",
                       "--prompt-len", "16", "--gen", "4", "--shared-prefix",
                       "2"])
    out = capsys.readouterr().out
    assert "6/6 requests" in out and "NSB hot-set hit rate" in out
    assert eng.metrics()["n_finished"] == 6


@pytest.mark.parametrize("flag", ["--tp=2", "--runahead=nvr", "--spill=8",
                                  "--executor=async", "--capture",
                                  "--expert-runahead=router",
                                  "--policy=slo_fair"])
def test_launcher_rejects_later_slice_flags(flag):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                     flag])
