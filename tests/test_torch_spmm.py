"""The ELL SpMM kernel's plain version against the JAX reference on the
CPU: ``gather_spmm_plain`` against the Pallas ``gather_spmm`` in
interpret mode at ``tests/test_kernels.py``'s shapes (float32 1e-5,
bfloat16 2e-2 relative and absolute, the reference test's own
tolerances), and the row gather's contract on ids outside the table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import csr_to_ell
from repro.kernels import gather_spmm as j_spmm
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_plain
from repro_torch.kernels.gather_spmm import gather_spmm, gather_spmm_plain

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("m,j,nin,n,bn", [(8, 4, 16, 128, 128),
                                          (16, 8, 32, 256, 128),
                                          (4, 16, 64, 512, 256)])
def test_gather_spmm_plain_matches_pallas(m, j, nin, n, bn, dtype, rtol):
    rng = np.random.default_rng(m * j)
    cols = rng.integers(0, nin, (m, j)).astype(np.int32)
    vals = rng.normal(size=(m, j)).astype(np.float32)
    dense = rng.normal(size=(nin, n)).astype(np.float32)
    want = j_spmm(jnp.asarray(cols), jnp.asarray(vals, _JAX[dtype]),
                  jnp.asarray(dense, _JAX[dtype]), block_n=bn)
    tv = torch.from_numpy(vals).to(_TORCH[dtype])
    td = torch.from_numpy(dense).to(_TORCH[dtype])
    got = gather_spmm(torch.from_numpy(cols), tv, td)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=rtol)


def test_gather_spmm_padding_is_inert_and_wrapper_does_not_launch():
    """ELL padding (val 0, laid out by the reference's ``csr_to_ell``)
    adds nothing; a column id outside [0, N_in) adds nothing either (the
    card's contract); CPU tensors never reach the kernel."""
    rng = np.random.default_rng(1)
    rowptr = np.array([0, 3, 3, 5])
    col = np.array([1, 4, 2, 0, 4])
    val = rng.normal(size=5).astype(np.float32)
    cols, vals = csr_to_ell(rowptr, col, val, nnz_pad=4)
    dense = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    n = gather_spmm.launches
    out = gather_spmm(torch.from_numpy(cols), torch.from_numpy(vals), dense)
    assert gather_spmm.launches == n
    want = np.zeros((3, 8), np.float32)
    for r in range(3):
        for k in range(rowptr[r], rowptr[r + 1]):
            want[r] += val[k] * dense[col[k]].numpy()
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    bad = torch.from_numpy(cols).clone()
    bad[0, 3], bad[1, 0] = -1, 5                  # padding slots, out of range
    vals_t = torch.from_numpy(vals).clone()
    vals_t[0, 3] = vals_t[1, 0] = 7.0
    np.testing.assert_allclose(gather_spmm_plain(bad, vals_t, dense).numpy(),
                               want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_gather_rows_ids_outside_the_table_are_zero_rows(dtype):
    """The port's one contract, kept by the card's kernel: ids -1, N and
    N + 7 give rows of zeros, never an error or a wrapped row."""
    n = 6
    table = (torch.arange(n * 4).reshape(n, 4) + 1).to(dtype)
    for idx_dtype in (torch.int32, torch.int64):
        ids = torch.tensor([2, -1, n, n + 7, n - 1], dtype=idx_dtype)
        out = gather_rows(ids, table)
        assert out.dtype == dtype
        assert torch.equal(out, gather_rows_plain(ids, table))
        assert torch.equal(out[0], table[2])
        assert torch.equal(out[4], table[n - 1])
        assert not out[1:4].any()
