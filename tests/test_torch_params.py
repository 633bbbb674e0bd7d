"""Weights: ``from_jax`` keeps the reference's keys, layer axis and
values; ``init_params`` makes the same shapes and zero-init as the
reference's ``init_params``."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import transformer as jt
from repro_torch.configs import get_config as t_get_config
from repro_torch.params import from_jax, init_params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3.2-1b"])
def test_from_jax_keeps_keys_axis_and_values(arch):
    cfg = get_config(arch).reduced()
    jp = _flat(jax.tree.map(np.asarray,
                            jt.init_params(cfg, jax.random.PRNGKey(1))))
    tp = _flat(from_jax(jax.tree.map(np.asarray, jt.init_params(
        cfg, jax.random.PRNGKey(1))), device="cpu"))
    assert tp.keys() == jp.keys()
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape
        np.testing.assert_array_equal(tp[k].numpy(), v)


def test_from_jax_bfloat16_and_dtype_cast():
    cfg = replace(get_config("qwen2-1.5b").reduced(), param_dtype="bfloat16")
    npp = jax.tree.map(np.asarray, jt.init_params(cfg, jax.random.PRNGKey(2)))
    tp = from_jax(npp, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  npp["embed"].astype(np.float32))
    t32 = from_jax(npp, device="cpu", dtype=torch.float32)
    assert t32["layers"]["wq"].dtype == torch.float32
    assert t32["layers"]["ln1"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "tinyllama-1.1b"])
def test_init_params_matches_reference_shapes(arch):
    cfg = t_get_config(arch).reduced()
    tp = _flat(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    jp = _flat(jax.tree.map(np.asarray, jt.init_params(
        get_config(arch).reduced(), jax.random.PRNGKey(0))))
    assert tp.keys() == jp.keys()
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype).endswith(str(v.dtype)), k
        if k.split(".")[-1] in ("ln1", "ln2", "ln_f", "bq", "bk", "bv"):
            assert not tp[k].any(), k
    std = tp["layers.wq"].std().item()
    assert std == pytest.approx(cfg.d_model ** -0.5, rel=0.1)
    assert tp["embed"].std().item() == pytest.approx(0.02, rel=0.1)


def test_init_params_is_seeded():
    cfg = t_get_config("qwen2-1.5b").reduced()
    a = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(a["layers"]["wi"], b["layers"]["wi"])
