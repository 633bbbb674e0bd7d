"""Port layers against their JAX twins at float32 (tolerance 1e-5).

The same numpy inputs, made from a seed, go through
``repro.models.{layers,transformer}`` and ``repro_torch.models.*`` on
the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.params import from_jax

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def cfg_params():
    cfg = get_config("qwen2-1.5b").reduced()
    npp = jax.tree.map(np.asarray,
                       jt.init_params(cfg, jax.random.PRNGKey(0)))
    # non-zero norms and biases, so their paths are exercised
    rng = np.random.default_rng(0)
    for key in ("ln1", "ln2", "bq", "bk", "bv"):
        a = npp["layers"][key]
        npp["layers"][key] = (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
    npp["ln_f"] = (0.1 * rng.normal(size=npp["ln_f"].shape)).astype(
        np.float32)
    return cfg, jax.tree.map(jnp.asarray, npp), from_jax(npp, device="cpu")


def _lp(p, li=0):
    return {k: v[li] for k, v in p["layers"].items()}


def test_configs_are_copies():
    for name in ("qwen2-1.5b", "llama3.2-1b", "gemma-7b"):
        assert t_get_config(name).__dict__ == get_config(name).__dict__
        assert (t_get_config(name).reduced().__dict__
                == get_config(name).reduced().__dict__)


def test_rms_norm():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 2000, size=(3, 7))
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           rtol=1e-5, atol=2e-5)


def test_gqa_project_and_attn_out(cfg_params):
    cfg, jp, tp = cfg_params
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    jq = jl.gqa_project(jnp.asarray(x), _lp(jp), cfg)
    tq = tl.gqa_project(torch.from_numpy(x), _lp(tp), cfg)
    for a, b in zip(tq, jq):
        _close(a, b)
    o = rng.normal(size=(2, 6, cfg.n_heads, cfg.hd)).astype(np.float32)
    _close(tl.attn_out(torch.from_numpy(o), _lp(tp)),
           jl.attn_out(jnp.asarray(o), _lp(jp), cfg.d_model))


@pytest.mark.parametrize("q_offset,sq,sk,chunk", [
    (0, 8, 8, 1024),       # plain causal prefill
    (12, 5, 20, 1024),     # chunk of a longer context
    (12, 5, 21, 8),        # Sk not a multiple of chunk
    (-3, 6, 10, 4),        # the first rows see no key: zeros, not NaN
])
def test_chunked_attention(q_offset, sq, sk, chunk):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, sq, 6, 16)).astype(np.float32)
    k = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    got = tl.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                               q_offset=q_offset, chunk=chunk)
    want = jl.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                q_offset=q_offset, chunk=chunk)
    assert torch.isfinite(got).all()
    _close(got, want)


def test_chunked_attention_int8_kv():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 4, 4, 16)).astype(np.float32)
    k = rng.integers(-127, 128, size=(1, 12, 2, 16)).astype(np.int8)
    v = rng.integers(-127, 128, size=(1, 12, 2, 16)).astype(np.int8)
    got = tl.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                               q_offset=8)
    want = jl.chunked_attention(*map(jnp.asarray, (q, k, v)), q_offset=8)
    _close(got, want)


def test_ffn_embed_and_logits(cfg_params):
    cfg, jp, tp = cfg_params
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    _close(tt.ffn(torch.from_numpy(x), _lp(tp), cfg),
           jt._ffn(jnp.asarray(x), _lp(jp), cfg))
    tok = rng.integers(0, cfg.vocab, size=(2, 3))
    _close(tt.embed(tp, cfg, torch.from_numpy(tok)),
           jnp.take(jp["embed"], jnp.asarray(tok), axis=0))
    _close(tt.logits_last(tp, cfg, torch.from_numpy(x)),
           jt.logits_last(jp, cfg, jnp.asarray(x)), rtol=1e-5, atol=1e-4)
