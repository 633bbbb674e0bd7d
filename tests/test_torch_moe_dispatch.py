"""The capacity dispatch's grouped GEMM: the port's
``moe_dispatch_matmul`` plain version and ``moe_ffn`` with its expert
products through the kernel route,
against the JAX reference on the CPU (its Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it), with inputs made with
numpy.

Tolerances: float32 1e-4 relative and 1e-3 absolute, bfloat16 3e-2
relative and 0.3 absolute (the reference's own kernel test's, since
the two sides accumulate in another order); the ``moe_ffn`` outputs
1e-5 (float32, the expert-pool tests' FFN tolerance); serve logits 1e-4
with tokens, routed ids and drops held exactly."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import moe_dispatch_matmul as j_dispatch
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serve.engine import Engine as JaxSingleEngine
from repro.serve.engine import PagedEngine as JaxEngine
from repro_torch.kernels import moe_dispatch
from repro_torch.models import moe as tmoe
from repro_torch.params import from_jax
from repro_torch.serve.engine import Engine, PagedEngine

ARCH = "qwen3-moe-235b-a22b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
       "bfloat16": dict(rtol=3e-2, atol=3e-1)}
FFN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(_TORCH[dtype])


# -- the grouped GEMM -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["dense", "transposed", "packed"])
@pytest.mark.parametrize("t,d,e,f,bt", [(256, 128, 4, 256, 64),
                                        (128, 256, 8, 128, 32),
                                        (512, 64, 2, 512, 128)])
def test_plain_matches_pallas_kernel(dtype, layout, t, d, e, f, bt):
    """The reference kernel test's shapes; the port also reads w as a
    transposed view of [E, F, D] rows and as a plane of packed experts,
    as its params lay out we_gate/we_up."""
    rng = np.random.default_rng(t + d)
    x = rng.normal(size=(t, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    gids = rng.integers(0, e, t // bt).astype(np.int32)
    want = j_dispatch(jnp.asarray(gids), jnp.asarray(x, _JAX[dtype]),
                      jnp.asarray(w, _JAX[dtype]), block_t=bt,
                      block_f=min(f, 128), block_d=min(d, 128))
    if layout == "dense":
        tw = _torch(w, dtype)
    elif layout == "transposed":
        tw = _torch(w.transpose(0, 2, 1), dtype).transpose(-1, -2)
    else:
        packed = np.zeros((e, 3, f, d), np.float32)
        packed[:, 1] = w.transpose(0, 2, 1)
        tw = _torch(packed, dtype)[:, 1].transpose(-1, -2)
    assert tw.shape == (e, d, f)
    got = moe_dispatch.moe_dispatch_matmul(
        torch.from_numpy(gids), _torch(x, dtype), tw, block_t=bt)
    assert got.dtype == _TORCH[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_plain_gives_each_block_its_expert_and_zeros_for_unknown_ids():
    """Each block of rows times its own expert's [D, F] plane; ids
    outside [0, E) give zero rows, as on the card."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 16, 8)).astype(np.float32))
    gids = torch.tensor([2, -1, 3, 0], dtype=torch.int32)
    seen = []
    out = moe_dispatch.moe_dispatch_matmul_plain(gids, x, w, block_t=16)
    for b, g in enumerate(gids.tolist()):
        rows = out[16 * b:16 * (b + 1)]
        if 0 <= g < 3:
            torch.testing.assert_close(rows, x[16 * b:16 * (b + 1)] @ w[g])
            seen.append(g)
        else:
            assert not rows.any()
    assert seen == [2, 0]


# -- the bfloat16 kernel's tile list -------------------------------------------

def _tiles_by_loop(gids, bt, bm):
    """Each run of equal ids, start to end, cut into bm-row pieces."""
    out, i = [], 0
    while i < len(gids):
        j = i
        while j + 1 < len(gids) and gids[j + 1] == gids[i]:
            j += 1
        r1 = (j + 1) * bt
        out += [(a, min(a + bm, r1), gids[i]) for a in range(i * bt, r1, bm)]
        i = j + 1
    return out


def _ids(order, nb, rng):
    if order == "random":
        return rng.integers(0, 6, nb)
    if order == "unknown":          # sorted, with ids outside [0, E)
        return np.sort(rng.integers(-2, 9, nb))
    # sorted runs of 1 to 20 blocks: shorter than, equal to and longer
    # than a tile for every (block_t, bm)
    return np.repeat(np.arange(nb), rng.integers(1, 21, nb))[:nb]


@pytest.mark.parametrize("order", ["sorted", "random", "unknown"])
@pytest.mark.parametrize("bt,bm", [(16, 64), (16, 128), (32, 64), (64, 64),
                                   (128, 64), (128, 128)])
@pytest.mark.parametrize("nb", [1, 7, 61])
def test_dispatch_tiles_plain_matches_a_loop(order, bt, bm, nb):
    """The contract of the card's tile list against a straightforward
    loop; every row is in exactly one tile of one expert, no tile is
    longer than bm, and the list fits the kernel's scratch.  T = nb *
    block_t is mostly not a multiple of bm."""
    rng = np.random.default_rng(nb * 1000 + bt + bm)
    g = _ids(order, nb, rng).astype(np.int32)
    got = moe_dispatch.dispatch_tiles_plain(torch.from_numpy(g), bt, bm)
    assert got.dtype == torch.int32 and got.shape[1] == 3
    want = _tiles_by_loop(g.tolist(), bt, bm)
    assert [tuple(r) for r in got.tolist()] == want
    rows = np.zeros(nb * bt, np.int64)
    for r0, r1, e in got.tolist():
        assert 0 < r1 - r0 <= bm
        assert (g[r0 // bt:(r1 - 1) // bt + 1] == e).all()
        rows[r0:r1] += 1
    assert (rows == 1).all()
    assert len(want) <= moe_dispatch.max_tiles(nb, bt, bm)
    # the wrapper takes the plain list for ids on the CPU
    assert torch.equal(moe_dispatch.dispatch_tiles(torch.from_numpy(g), bt,
                                                   bm), got)


@pytest.mark.parametrize("rpe", [32, 128, 768, 96])
def test_dispatch_tiles_of_the_capacity_dispatch(rpe):
    """The paths' layout (each expert one run of ``rpe`` rows) gives
    ceil(rpe / bm) tiles of the GEMM's ``TILE_ROWS`` an expert: one at
    the chunk's 32 rows and the decode's 128, so no expert's weights are
    streamed twice there."""
    e, bm = 128, moe_dispatch.TILE_ROWS
    g = torch.arange(e, dtype=torch.int32).repeat_interleave(rpe // 16)
    tiles = moe_dispatch.dispatch_tiles_plain(g, 16, bm)
    per = -(-rpe // bm)
    assert tiles.shape[0] == e * per
    torch.testing.assert_close(tiles[::per, 2], torch.arange(
        e, dtype=torch.int32))
    assert (tiles[:, 1] - tiles[:, 0]).max() <= bm


def test_dispatch_tiles_plain_of_no_ids():
    got = moe_dispatch.dispatch_tiles_plain(
        torch.zeros(0, dtype=torch.int32), 16, 64)
    assert got.shape == (0, 3)


# -- moe_ffn through the kernel route ------------------------------------------

@pytest.fixture(scope="module")
def weights():
    cfg = get_config(ARCH).reduced()
    jp = jt.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("factor", [1.25, 0.5, 0.25])
def test_moe_ffn_kernel_route_matches_reference(weights, factor):
    """The same pairs dropped (low factors drop some), the same outputs,
    and the kernel route equal to the ``torch.matmul`` route."""
    cfg, jp, tp = weights
    jl = {k: v[0] for k, v in jp["layers"].items()}
    tl = {k: v[0] for k, v in tp["layers"].items()}
    b, s = 2, 64
    x = np.random.default_rng(7).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    cap = jmoe._capacity(s, cfg.top_k, cfg.n_experts, factor)
    assert cap == tmoe._capacity(s, cfg.top_k, cfg.n_experts, factor)
    router = jl["router"].astype(jnp.float32)
    _, tkeep, *_ = tmoe._route_row(torch.from_numpy(x), tl["router"].float(),
                                   cfg.top_k, cap)
    for r in range(b):
        _, jkeep, *_ = jmoe._route_row(jnp.asarray(x[r]), router,
                                       cfg.n_experts, cfg.top_k, cap)
        np.testing.assert_array_equal(tkeep[r].numpy(), np.asarray(jkeep))
    if factor < 1.0:
        assert not bool(tkeep.all()), "a low factor must drop pairs"
    want = jmoe.moe_ffn(jnp.asarray(x), jl, cfg, capacity_factor=factor)
    n = moe_dispatch.moe_dispatch_matmul.launches
    got = tmoe.moe_ffn(torch.from_numpy(x), tl, cfg, factor, kernel="cuda")
    assert moe_dispatch.moe_dispatch_matmul.launches == n  # plain on CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    plain = tmoe.moe_ffn(torch.from_numpy(x), tl, cfg, factor,
                         kernel="torch")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **FFN_TOL)


def test_moe_ffn_kernel_route_calls_the_grouped_gemm(weights, monkeypatch):
    """Three grouped GEMMs over [E * B * cap, D] rows, one group id per
    16 rows, the experts in order, and the packed weight views as they
    are (no copy)."""
    cfg, _, tp = weights
    tl = {k: v[0] for k, v in tp["layers"].items()}
    calls = []
    real = tmoe.moe_dispatch_matmul

    def spy(gids, x, w, *, block_t):
        calls.append((gids.clone(), tuple(x.shape), w.data_ptr(), block_t))
        return real(gids, x, w, block_t=block_t)
    monkeypatch.setattr(tmoe, "moe_dispatch_matmul", spy)
    b, s = 2, 16
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    tmoe.moe_ffn(x, tl, cfg, kernel="cuda")
    cap = tmoe._capacity(s, cfg.top_k, cfg.n_experts, 1.25)
    rows = cfg.n_experts * b * cap
    assert [c[1] for c in calls] == [(rows, cfg.d_model)] * 2 + [
        (rows, cfg.d_ff_expert)]
    assert [c[2] for c in calls] == [tl[k].data_ptr() for k in
                                     ("we_gate", "we_up", "we_down")]
    want_ids = torch.arange(cfg.n_experts, dtype=torch.int32)
    for gids, _, _, bt in calls:
        assert bt == 16
        torch.testing.assert_close(gids, want_ids.repeat_interleave(
            b * cap // 16))


# -- the serve paths through the kernel route ---------------------------------

def _work(cfg):
    rng = np.random.default_rng(5)
    return [(0.0, rng.integers(1, cfg.vocab, size=int(n)), int(g))
            for n, g in zip(rng.integers(6, 20, size=6),
                            rng.integers(4, 9, size=6))]


@pytest.mark.parametrize("expert_pool", ["off", "paged"])
def test_paged_engine_kernel_route_matches_reference(weights, expert_pool):
    """Every prefill chunk (and with the pool off every decode step)
    runs the capacity dispatch through ``moe_dispatch_matmul``."""
    cfg, jp, tp = weights
    kw = dict(max_len=48, n_pages=24, max_batch=4, chunk=16,
              expert_pool=expert_pool)
    je = JaxEngine(cfg, jp, kernel="xla", **kw)
    je.run([(t, p.copy(), g) for t, p, g in _work(cfg)])
    te = PagedEngine(cfg, tp, kernel="cuda", device="cpu", **kw)
    te.run([(t, p.copy(), g) for t, p, g in _work(cfg)])
    assert te.requests.keys() == je.requests.keys()
    for rid, a in je.requests.items():
        b = te.requests[rid]
        assert b.out_tokens == a.out_tokens, rid
        np.testing.assert_allclose(b.last_logits, a.last_logits,
                                   **LOGIT_TOL)


def test_single_batch_engine_kernel_route_matches_reference(weights):
    cfg, jp, tp = weights
    toks = np.random.default_rng(9).integers(0, cfg.vocab, size=(2, 16))
    kw = dict(sparse=True, max_len=32, nsb_pages=16)
    je = JaxSingleEngine(cfg, jp, **kw)
    jout = je.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 6)
    te = Engine(cfg, tp, kernel="cuda", device="cpu", **kw)
    tout = te.generate({"tokens": toks}, 6)
    np.testing.assert_array_equal(tout, np.asarray(jout))
    assert vars(te.stats) == vars(je.stats)


def test_bf16_kernel_route_close_to_torch_route(weights):
    """In bfloat16 the grouped GEMM rounds each product once from float32,
    as ``torch.matmul`` does: the routes agree to bfloat16 steps."""
    cfg, _, tp = weights
    tl = {k: v[0].to(torch.bfloat16) if v.is_floating_point()
          and k != "router" else v[0] for k, v in tp["layers"].items()}
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).bfloat16()
    a = tmoe.moe_ffn(x, tl, replace(cfg, param_dtype="bfloat16"),
                     kernel="cuda")
    b = tmoe.moe_ffn(x, tl, replace(cfg, param_dtype="bfloat16"),
                     kernel="torch")
    torch.testing.assert_close(a.float(), b.float(), rtol=3e-2, atol=3e-2)


def test_launcher_single_batch_moe_honours_layers_on_cpu(capsys):
    """``--layers`` cuts a MoE config's depth in the default mode, as
    ``--arch qwen3-moe-235b-a22b --layers 8`` does on one card."""
    from repro_torch.launch import serve as tserve
    eng = tserve.main(["--arch", ARCH, "--reduced", "--layers", "1",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "16", "--gen", "4"])
    assert isinstance(eng, Engine) and eng.cfg.n_layers == 1
    assert eng.cfg.n_experts > 0
    assert "[serve] generated (2, 4) tokens" in capsys.readouterr().out
