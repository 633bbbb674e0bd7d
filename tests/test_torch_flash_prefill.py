"""The prefill kernel's dispatch and plain version against the JAX
reference: the TPU kernel ``flash_prefill`` in interpret mode at
``q_offset=0``, and ``chunked_attention(q_offset=start)`` over a
block-table-gathered paged context, which is what the serve engine's
chunked prefill runs.  Tolerance 1e-5 at float32 (bfloat16 inputs are
upcast identically by both).  Then the wrapper's routing (``plan``): which
kernel, tile and key split a call gets on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_prefill as pallas_flash_prefill
from repro.models import layers as jl
from repro.models import sparse_attention as js
from repro_torch.kernels.flash_prefill import flash_prefill, plan
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


# -- the wrapper's routing: kernel, tile and key split of a call ----------

@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
@pytest.mark.parametrize("d", [16, 32, 48, 128, 256])
def test_plan_sends_float32_queries_to_the_cuda_core_kernel(kv_dtype, d):
    p = plan(torch.float32, kv_dtype, d, 8, 1536, 1536, 12)
    assert (p.kernel, p.splits) == ("simt", 1)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_plan_sends_bf16_queries_to_the_tensor_core_kernel(kv_dtype, d):
    p = plan(torch.bfloat16, kv_dtype, d, 8, 1024, 1024, 64)
    assert p.kernel == "wgmma" and p.splits == 1
    assert p.rows == p.keys == (64 if d == 256 else 128)


@pytest.mark.parametrize("d", [16, 48, 96, 512])
def test_plan_refuses_other_bf16_head_dims(d):
    with pytest.raises(ValueError):
        plan(torch.bfloat16, torch.bfloat16, d, 1, 16, 16, 4)


def test_plan_refuses_bf16_queries_against_float32_kv():
    with pytest.raises(TypeError):
        plan(torch.bfloat16, torch.float32, 128, 1, 16, 16, 4)


@pytest.mark.parametrize("shape,splits", [
    # (B, Sq, Sk, H, q_offset): the serve paths' calls at D=128
    ((8, 1536, 1536, 12, 0), 1),     # qwen2-1.5b single-batch prefill
    ((8, 1024, 1024, 64, 0), 1),     # qwen3-moe single-batch prefill
    ((1, 256, 1536, 64, 1280), 1),   # qwen3-moe paged chunk: 128 blocks
    ((8, 1, 1568, 12, 1536), 1),     # dense decode: 96 blocks
    ((1, 256, 1536, 12, 1280), 5),   # qwen2-1.5b paged chunk: 24 blocks
    ((1, 1, 1568, 12, 1536), 11),    # one request's dense decode
    ((1, 1, 100, 12, 99), 1),        # one key tile: nothing to split
])
def test_plan_splits_keys_only_when_blocks_leave_sms_idle(shape, splits):
    b, sq, sk, h, off = shape
    p = plan(torch.bfloat16, torch.bfloat16, 128, b, sq, sk, h, q_offset=off)
    assert p.splits == splits
    blocks = b * h * -(-sq // p.rows)
    # as many splits as fill the SMs in one wave, and no more
    assert p.splits == 1 or (blocks * p.splits <= 132
                             < blocks * (p.splits + 1))


def test_plan_caps_splits_at_the_key_tiles():
    # 2 blocks, 132 // 2 = 66 splits wanted, 4 tiles of 64 keys there
    p = plan(torch.bfloat16, torch.int8, 256, 1, 1, 4096, 2, q_offset=200)
    assert (p.keys, p.splits) == (64, 4)
    assert plan(torch.bfloat16, torch.int8, 256, 1, 1, 4096, 2,
                causal=False).splits == 16
