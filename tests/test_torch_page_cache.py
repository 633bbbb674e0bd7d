"""The port's NSB ``PageCache`` against the reference's
``capture.PageCache`` in its demand-LRU mode: the same touch sequence
gives the same hit/miss answers and the same hit rate."""

import numpy as np
import pytest

from repro.core.nvr import capture
from repro_torch.serve.page_cache import PageCache


@pytest.mark.parametrize("capacity,n_ids,n_touch,seed", [
    (1, 4, 50, 0), (4, 6, 200, 1), (16, 40, 500, 2), (64, 300, 3000, 3)])
def test_same_touches_same_hits(capacity, n_ids, n_touch, seed):
    rng = np.random.default_rng(seed)
    # a working set that drifts: reuse at several distances
    seq = (rng.integers(0, n_ids, size=n_touch)
           + np.arange(n_touch) // 10)
    ref, port = capture.PageCache(capacity), PageCache(capacity)
    assert [port.touch(int(p)) for p in seq] == \
        [ref.touch(int(p)) for p in seq]
    assert port.hit_rate == pytest.approx(ref.hit_rate)


def test_hit_rate_none_before_traffic_and_capacity_checked():
    assert PageCache(4).hit_rate is None
    with pytest.raises(ValueError):
        PageCache(0)
