"""The port's copy of the NVR simulator against the reference's, on the
CPU: both are numpy, so every trace array and every ``run_modes``
result must be equal exactly.  Also the port's kernel quickstart on the
CPU (its kernels' plain versions)."""

import dataclasses
import math

import numpy as np
import pytest

from repro.core import nvr as jnvr
from repro_torch.core import nvr as tnvr
from repro_torch.launch import quickstart

SCALE = 0.25


def test_the_copy_has_the_same_workloads():
    assert list(tnvr.WORKLOADS) == list(jnvr.WORKLOADS)
    assert len(tnvr.WORKLOADS) == 8


def _same_value(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (a is None) == (b is None) and np.array_equal(a, b)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@pytest.mark.parametrize("name", list(jnvr.WORKLOADS))
def test_traces_and_run_modes_equal_reference(name):
    tt = tnvr.make_trace(name, dtype_bytes=2, scale=SCALE)
    jt = jnvr.make_trace(name, dtype_bytes=2, scale=SCALE)
    assert (tt.name, tt.indirect_regions, tt.dense_compute_scale,
            tt.meta) == (jt.name, jt.indirect_regions,
                         jt.dense_compute_scale, jt.meta)
    assert len(tt.ops) == len(jt.ops)
    for a, b in zip(tt.ops, jt.ops):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            assert _same_value(getattr(a, f.name), getattr(b, f.name)), \
                (name, f.name)
    tr, jr = tnvr.run_modes(tt, 2), jnvr.run_modes(jt, 2)
    assert [r.label for r in tr] == [r.label for r in jr]
    for a, b in zip(tr, jr):
        for f in dataclasses.fields(a):
            assert _same_value(getattr(a, f.name), getattr(b, f.name)), \
                (name, a.label, f.name)


def test_quickstart_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("gather_spmm: ELL SpMM over gathered dense rows == plain  OK",
                 "sparse_decode_attn: TopK-page KV gather attention == "
                 "plain  OK", "quickstart OK"):
        assert line in out
    assert "nvr " in out and "NVR: accuracy" in out


def test_quickstart_refuses_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])
