"""The prefill kernel's dispatch and plain version against the JAX
reference: the TPU kernel ``flash_prefill`` in interpret mode at
``q_offset=0``, and ``chunked_attention(q_offset=start)`` over a
block-table-gathered paged context, which is what the serve engine's
chunked prefill runs.  Tolerance 1e-5 at float32 (bfloat16 inputs are
upcast identically by both)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_prefill as pallas_flash_prefill
from repro.models import layers as jl
from repro.models import sparse_attention as js
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models import sparse_attention as ts

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,h,kv", [(32, 4, 2), (16, 6, 1), (64, 4, 4)])
def test_matches_pallas_flash_prefill_at_offset_zero(s, h, kv):
    rng = np.random.default_rng(s + h)
    q = rng.normal(size=(2, s, h, 32)).astype(np.float32)
    k = rng.normal(size=(2, s, kv, 32)).astype(np.float32)
    v = rng.normal(size=(2, s, kv, 32)).astype(np.float32)
    want = pallas_flash_prefill(*map(jnp.asarray, (q, k, v)), block_q=16,
                                block_k=16, interpret=True)
    launches = flash_prefill.launches
    got = flash_prefill(*map(torch.from_numpy, (q, k, v)), q_offset=0)
    assert flash_prefill.launches == launches      # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("start,t_valid", [(0, 8), (12, 8), (20, 3)])
def test_paged_context_matches_chunked_attention(pool_dtype, start,
                                                 t_valid):
    """Chunked prefill: a chunk of queries at ``start`` against the
    request's context gathered through its block table (NULL-padded
    tail), as ``_paged_prefill_fn`` builds it."""
    rng = np.random.default_rng(start + t_valid)
    page, nl, kv, g, d = 4, 8, 2, 2, 16
    n_pages = 20
    kf = rng.normal(size=(n_pages, page, kv, d)).astype(np.float32)
    vf = rng.normal(size=(n_pages, page, kv, d)).astype(np.float32)
    bt = np.zeros((nl,), np.int32)
    n_used = -(-(start + t_valid) // page)
    bt[:n_used] = rng.choice(np.arange(1, n_pages), size=n_used,
                             replace=False)
    q = rng.normal(size=(1, 8, kv * g, d)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "int8": jnp.int8}[pool_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}[pool_dtype]
    jk, jv = (js.kv_quant(jnp.asarray(a), jdt) for a in (kf, vf))
    tk, tv = (ts.kv_quant(torch.from_numpy(a), tdt) for a in (kf, vf))
    jctx = [a[jnp.asarray(bt)].reshape(1, nl * page, kv, d)
            for a in (jk, jv)]
    tctx = [a[torch.from_numpy(bt).long()].reshape(1, nl * page, kv, d)
            for a in (tk, tv)]
    want = jl.chunked_attention(jnp.asarray(q), *jctx, causal=True,
                                q_offset=start, chunk=min(1024, nl * page))
    got = flash_prefill(torch.from_numpy(q), *tctx, q_offset=start,
                        chunk=min(1024, nl * page))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_version_keeps_softcap_on_cpu():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, 6, 2, 8)).astype(np.float32)
               for _ in range(3))
    want = jl.chunked_attention(*map(jnp.asarray, (q, k, v)), q_offset=3,
                                logit_softcap=5.0)
    got = flash_prefill(*map(torch.from_numpy, (q, k, v)), q_offset=3,
                        logit_softcap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
