"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which is
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds.
Libraries go to ``build/kernels/`` at the repository root (listed in
``.gitignore``), or to ``$REPRO_TORCH_BUILD_DIR`` when set.

Every C entry point takes tensor pointers and the stream as ``void*``
and returns ``cudaGetLastError()`` after its launch; :func:`check`
raises on a non-zero code, since a refused launch never runs and
``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C entry points: q and the output take float32 (0) or
# bfloat16 (1); K/V pools also take int8 (2), scaled by 1 / KV_QSCALE
Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
KV_CODES = {**Q_CODES, torch.int8: 2}

_lock = threading.Lock()
_built: dict[str, Path] = {}
_libs: dict[str, ctypes.CDLL] = {}
# ptxas resource report (registers, shared memory, spills) per kernel
ptxas_reports: dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from "
        f"{CSRC} at first use and need the CUDA toolkit")


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def compile_source(name: str) -> Path:
    """Run ``nvcc`` on ``csrc/<name>.cu``; return the library path."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{name}.so"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(nvcc_command(name, tmp), capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, out)
    ptxas_reports[name] = res.stderr
    _built[name] = out
    return out


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` at once, one ``nvcc`` per source, all
    started together.  Returns the ptxas report of each."""
    from concurrent.futures import ThreadPoolExecutor
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for _ in pool.map(compile_source, names):
            pass
    return {n: ptxas_reports[n] for n in names}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (once per process) and load ``csrc/<name>.cu``.

    ``signatures`` maps each C function to its ``argtypes``; every one
    returns an ``int`` CUDA error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _built.get(name) or compile_source(name)
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
