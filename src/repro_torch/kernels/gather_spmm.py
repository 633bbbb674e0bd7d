"""ELL SpMM with a gathered dense operand: the CUDA kernel and its
dispatch.

Replaces the TPU kernel ``src/repro/kernels/gather_spmm.py``
(``_spmm_kernel``), the one-side-sparse SpMM of the paper's Fig. 2.  The
kernel source is ``csrc/gather_spmm.cu``, whose header says what bounds
it on the H100 and what its design does about that.  The plain version
copies the reference's oracle ``kernels/ref.py::gather_spmm_ref``:
gather the named rows of ``dense``, contract with ``vals`` in float32.

:func:`gather_spmm` runs the plain version for tensors on the CPU and
launches the CUDA kernel for tensors on a card; there is no fallback
between the two.  ``gather_spmm.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import Q_CODES

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gather_spmm": [_P] * 4 + [_I] * 7 + [_P]}


def gather_spmm_plain(cols: torch.Tensor, vals: torch.Tensor,
                      dense: torch.Tensor) -> torch.Tensor:
    """cols int [M, J]; vals [M, J]; dense [N_in, N] -> float32 [M, N]:
    ``out[m] = sum_j vals[m, j] * dense[cols[m, j]]``.  A column id
    outside [0, N_in) adds nothing, as on the card."""
    n_in = dense.shape[0]
    ok = (cols >= 0) & (cols < n_in)
    rows = dense[cols.long().clamp(0, n_in - 1)].float()      # [M, J, N]
    v = torch.where(ok, vals.float(), 0.0)
    return torch.einsum("mj,mjn->mn", v, rows)


def gather_spmm(cols: torch.Tensor, vals: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
    """ELL SpMM: cols int32 [M, J] (row ids of ``dense``; ids outside
    [0, N_in) add nothing), vals [M, J] (float32 or bfloat16; padding
    entries carry 0), dense [N_in, N] (float32 or bfloat16) -> float32
    [M, N] with float32 accumulation."""
    if not dense.is_cuda:
        return gather_spmm_plain(cols, vals, dense)
    if cols.dtype != torch.int32:
        raise TypeError(f"gather_spmm: cols must be int32, got {cols.dtype}")
    if vals.dtype not in Q_CODES or dense.dtype not in Q_CODES:
        raise TypeError(f"gather_spmm takes {'/'.join(map(str, Q_CODES))} "
                        f"vals and dense, got {vals.dtype} and {dense.dtype}")
    if cols.dim() != 2 or vals.shape != cols.shape or dense.dim() != 2:
        raise ValueError(f"cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)} and dense "
                         f"{tuple(dense.shape)} are not [M, J], [M, J] and "
                         f"[N_in, N]")
    tensors = (cols, vals, dense)
    if any(t.device != dense.device for t in tensors):
        raise ValueError("gather_spmm: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_spmm needs contiguous inputs")
    (m, j), (n_in, n) = cols.shape, dense.shape
    out = torch.empty((m, n), dtype=torch.float32, device=dense.device)
    per_vec = 16 // dense.element_size()
    vec = int(n % per_vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (dense, out)))
    lib = _build.load("gather_spmm", _SIGNATURES)
    code = lib.gather_spmm(
        *(_build.ptr(t) for t in tensors), _build.ptr(out), m, j, n_in, n,
        Q_CODES[vals.dtype], Q_CODES[dense.dtype], vec,
        _build.stream_ptr(dense.device))
    _build.check(code, "gather_spmm")
    gather_spmm.launches += 1
    return out


gather_spmm.launches = 0
