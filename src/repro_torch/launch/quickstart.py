"""Quickstart of the port: the NVR simulator and two runahead kernels.

What ``examples/quickstart.py`` shows for the JAX package, on the port:

1. the NVR simulator (the port's copy, ``repro_torch.core.nvr``) on the
   Double Sparsity trace, the paper's cache-miss and speedup story;
2. the ``gather_spmm`` and ``sparse_decode_attn`` kernels against their
   plain PyTorch versions.

On the CUDA card by default (the kernels build at first use); with
``--device cpu`` the wrappers run their plain versions:

  PYTHONPATH=src python -m repro_torch.launch.quickstart
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device


def simulator_demo() -> None:
    from ..core.nvr import make_trace, run_modes
    print("=== NVR simulator: Double Sparsity (LLM sparse KV) ===")
    tr = make_trace("DS", dtype_bytes=2, scale=0.5)
    rs = {r.label: r for r in run_modes(tr, 2)}
    ino = rs["inorder"]
    print(f"{'mode':10s} {'cycles':>10s} {'stall':>10s} {'misses':>8s} "
          f"{'speedup':>8s}")
    for mode in ("dense", "inorder", "ooo", "stream", "imp", "dvr", "nvr"):
        r = rs[mode]
        print(f"{mode:10s} {r.total:10.0f} {r.stall:10.0f} "
              f"{r.demand_misses:8d} {ino.total / r.total:8.2f}x")
    nvr = rs["nvr"]
    print(f"\nNVR: accuracy {nvr.accuracy:.1%}, coverage {nvr.coverage:.1%},"
          f" off-chip traffic -{1 - nvr.offchip / ino.offchip:.1%}")


def kernel_demo(device: torch.device) -> None:
    from ..kernels.gather_spmm import gather_spmm, gather_spmm_plain
    from ..kernels.sparse_decode_attn import (sparse_decode_attn,
                                              sparse_decode_attn_plain)
    route = ("CUDA kernel" if device.type == "cuda"
             else "plain version (CPU)")
    print(f"\n=== runahead kernels: {route} vs plain version ===")
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)
    # one-side-sparse SpMM (the paper's Fig. 2 listing); float32 sums in
    # another order: 1e-5 relative and absolute
    cols = t(rng.integers(0, 64, (8, 4)), torch.int32)
    vals = t(rng.normal(size=(8, 4)))
    dense = t(rng.normal(size=(64, 256)))
    out = gather_spmm(cols, vals, dense)
    torch.testing.assert_close(out, gather_spmm_plain(cols, vals, dense),
                               rtol=1e-5, atol=1e-5)
    print("gather_spmm: ELL SpMM over gathered dense rows == plain  OK")
    # TopK sparse decode attention (Double Sparsity / H2O): 3e-5 relative,
    # 3e-6 absolute, as the reference's quickstart holds its kernel
    q = t(rng.normal(size=(2, 2, 4, 64)))
    k = t(rng.normal(size=(2, 128, 2, 64)))
    v = t(rng.normal(size=(2, 128, 2, 64)))
    idx = t(rng.integers(0, 16, (2, 2, 6)), torch.int32)
    out = sparse_decode_attn(idx, q, k, v, page_size=8)
    want = sparse_decode_attn_plain(idx, q, k, v, page_size=8)
    torch.testing.assert_close(out, want, rtol=3e-5, atol=3e-6)
    print("sparse_decode_attn: TopK-page KV gather attention == plain  OK")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    simulator_demo()
    kernel_demo(device)
    print("\nquickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
