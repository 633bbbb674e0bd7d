"""Rules of the port that no parity test sees: it imports neither JAX
nor the reference package, its entry points refuse to run without a card
unless the CPU was asked for, and the kernel wrappers never launch (or
count) for CPU tensors."""

import ast
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.params import init_params
from repro_torch.serve.engine import PagedEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    cfg = get_config("qwen2-1.5b").reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_engine_defaults_to_the_card_and_raises_without_one(no_card):
    cfg, params = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedEngine(cfg, params, max_len=48)
    PagedEngine(cfg, params, max_len=48, device="cpu")


def test_init_params_and_launcher_raise_without_card(no_card):
    from repro_torch.launch import serve
    cfg, _ = _tiny()
    with pytest.raises(RuntimeError):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "qwen2-1.5b", "--reduced"])


def test_nvcc_command_targets_hopper(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command("paged_decode_attn", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/paged_decode_attn.cu")
    assert {"-shared", "-O3"} <= set(cmd)
    assert _build.sources() == ["flash_prefill", "gather_rows",
                                "gather_spmm", "moe_dispatch",
                                "paged_decode_attn", "sparse_decode_attn"]


def test_missing_nvcc_is_a_clear_error(monkeypatch):
    monkeypatch.setenv("NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(shutil, "which", lambda _: None)
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_dir_is_ignored_by_git():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert _build.build_dir() == ROOT / "build" / "kernels"


def _load_smoke(path):
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fails_without_card(no_card, capsys):
    assert _load_smoke(ROOT / "chip_smoke.py").main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_fails_alone_in_a_directory(monkeypatch, tmp_path,
                                               capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    assert _load_smoke(tmp_path / "chip_smoke.py").main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_wrappers_run_plain_versions_on_cpu_without_counting():
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_decode_attn import paged_decode_attn
    before = (paged_decode_attn.launches, flash_prefill.launches)
    q = torch.randn(1, 4, 2, 8)
    assert torch.isfinite(flash_prefill(q, q[:, :, :1], q[:, :, :1])).all()
    pool = torch.randn(3, 2, 1, 8)
    ids = torch.ones((1, 1, 1), dtype=torch.int32)
    out = paged_decode_attn(ids, ids * 0, torch.tensor([1], dtype=torch.int32),
                            torch.randn(1, 1, 2, 8), pool, pool, page_size=2)
    assert out.shape == (1, 1, 2, 8) and np.isfinite(out.numpy()).all()
    assert (paged_decode_attn.launches, flash_prefill.launches) == before
