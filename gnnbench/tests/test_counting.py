"""The frozen counting functions against brute-force counts, and the
percentile over all epochs."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from gnnbench import counting
from gnnbench.metrics.epoch_ms_p90 import nearest_rank


def test_bound_takes_the_slower_of_bytes_and_operations():
    b = counting.bound(3.35e9, 0)
    assert b["bound_ms"] == pytest.approx(1.0)
    assert b["bound_by"] == "bytes"
    o = counting.bound(0, 67e9)
    assert o["bound_ms"] == pytest.approx(1.0)
    assert o["bound_by"] == "operations"


def _linear_flops(rows, k, n):
    """2 flops for each multiply-add of a (rows, k) @ (k, n) product,
    counted one output element at a time."""
    return sum(2 * k for _ in itertools.product(range(rows), range(n)))


@pytest.mark.parametrize("batch,m1,hidden,feat,classes",
                         [(4, 9, 6, 5, 3), (2, 7, 8, 4, 5)])
def test_sage_flops_counts_every_product(batch, m1, hidden, feat, classes):
    # layer 0: fc_self and fc_neigh over the m1 hop-1 rows, forward and
    # the weight gradients (its input needs none)
    l0 = 2 * _linear_flops(m1, feat, hidden)
    # layer 1 transforms first: fc_neigh over m1 rows, fc_self over the
    # batch; forward, weight and input gradients
    l1 = _linear_flops(m1, hidden, classes) + _linear_flops(batch, hidden,
                                                            classes)
    assert counting.sage_flops(batch, m1, hidden, feat, classes) == \
        2 * l0 + 3 * l1


def test_sample_traffic_against_a_loop():
    gen = torch.Generator().manual_seed(3)
    deg = torch.randint(0, 7, (40,), generator=gen)
    indptr = torch.zeros(41, dtype=torch.int64)
    indptr[1:] = torch.cumsum(deg, 0)
    frontier = torch.randint(-1, 40, (25,), generator=gen)
    u = torch.rand((25, 4), generator=gen)
    got = counting.sample_traffic(indptr, frontier, u)
    valid, live = 0, 0
    sectors_ptr, sectors_idx, sectors_u = set(), set(), set()
    for p in range(25):
        v = int(frontier[p])
        if v < 0:
            continue
        live += 1
        sectors_ptr.update({v // 8, (v + 1) // 8})
        d = int(deg[v])
        for f in range(4):
            if f < d:
                valid += 1
                off = min(int(float(u[p, f]) * d), d - 1)
                sectors_idx.add((int(indptr[v]) + off) // 8)
                sectors_u.add((p * 4 + f) // 8)
    whole = 4 * 25 + 4 * 25 * 4
    assert got["valid_slots"] == valid
    assert got["useful_bytes"] == whole + 8 * live + 8 * valid
    assert got["sector_bytes"] == whole + 32 * (
        len(sectors_ptr) + len(sectors_idx) + len(sectors_u))


def _grid_busy(spans, lo, hi):
    cover = np.zeros(hi - lo, bool)
    for a, b in spans:
        cover[a - lo:b - lo] = True
    return cover


@pytest.mark.parametrize("seed", range(5))
def test_busy_and_gaps_against_a_grid(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 200, 30)
    spans = [(int(x), int(x + rng.integers(1, 25))) for x in a]
    cover = _grid_busy(spans, 0, 300)
    assert counting.device_busy_us(spans) == cover.sum()
    gaps = counting.idle_gaps(spans, 0, 300)
    assert sum(b - a for a, b in gaps) == (~cover).sum()
    for g0, g1 in gaps:
        assert not cover[g0:g1].any()


def test_percentile_is_over_every_epoch():
    values = list(range(1, 101))
    assert nearest_rank(values, 0.9) == 90
    assert nearest_rank([5.0], 0.9) == 5.0
    assert nearest_rank([3, 1, 2, 10, 4, 5, 6, 7, 8, 9, 11], 0.9) == 10
