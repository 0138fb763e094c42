"""The dedup's tail (``ops/dedup.py``): its contract cases, its wrapper on
the CPU, and the kernel held bit for bit to the plain version on the card.

``hop_cases`` are one-hop inputs of ``grow_frontier`` that cover its
contract: an empty hop, an all-padding hop, a hop of old ids only, one
repeated id, a frontier cap above the hop's entries, overflow at and
past the cap (and after an overflow at the hop before), ids past 2^24 and
at 2^31 - 2, a hub, and Zipf-like hops at two sizes.
``tests/test_torch_sampler.py`` holds the CPU path to ``legion_tpu``'s
``grow_frontier`` on them. ``tile_cases`` add what only the kernel's
tiling can get wrong: groups that cross tiles or cover whole ones, a hop
of one entry, and a length that is no multiple of the tile, near 3M.
This file imports no JAX, so ``pytest --noconftest -m cuda`` runs it on
a card."""

import numpy as np
import pytest
import torch

from legion_tpu_torch.ops.dedup import (TILE, dedup_tail, dedup_tail_plain,
                                        dedup_traffic)
from legion_tpu_torch.sampling.sampler import SENTINEL, grow_frontier

torch.set_num_threads(2)

BIG = 1 << 24
TOP = 2 ** 31 - 2            # the largest id below the padding sentinel


def _frontier(ids, cap):
    """Distinct ids in front, -1 after: a frontier as the sampler keeps it."""
    f = np.full(cap, -1, np.int32)
    f[:len(ids)] = ids
    return f


def _zipf(rng, ids, shape, pad=0.1):
    """Draws from ``ids`` with Zipf-like repeats (the lowest ranks are
    hubs), a share ``pad`` of them -1."""
    rank = np.minimum(rng.zipf(1.4, size=shape) - 1, len(ids) - 1)
    out = np.asarray(ids, np.int64)[rank].astype(np.int32)
    out[rng.random(shape) < pad] = -1
    return out


def _new_count(prev, nbrs):
    valid = nbrs[nbrs >= 0]
    return len(np.setdiff1d(np.unique(valid), prev[prev >= 0]))


def hop_cases():
    """name -> (frontier_prev, num_prev, neighbors, cap_new), numpy."""
    rng = np.random.default_rng(19)
    cases = {}
    prev = _frontier([9, 4, 30, 2, 17], 8)
    cases["empty_hop"] = (prev, 5, np.full((4, 3), -1, np.int32), 20)
    cases["all_padding"] = (np.full(8, -1, np.int32), 0,
                            np.full((8, 3), -1, np.int32), 32)
    old = rng.permutation(100)[:6]
    nbrs = old[rng.integers(0, 6, (8, 5))].astype(np.int32)
    nbrs[rng.random((8, 5)) < 0.2] = -1
    cases["only_old_ids"] = (_frontier(old, 8), 6, nbrs, 48)
    cases["one_repeated_id"] = (_frontier([3, 1, 8, 5], 8), 4,
                                np.full((8, 4), 77, np.int32), 40)
    prev = _frontier([11, 0, 6, 23, 2], 8)
    nbrs = rng.integers(-1, 40, (8, 3)).astype(np.int32)
    cases["total_below_cap"] = (prev, 5, nbrs, 100)
    prev = _frontier(rng.permutation(500)[:40], 48)
    nbrs = rng.integers(-1, 500, (48, 6)).astype(np.int32)
    n_new = _new_count(prev, nbrs)
    cases["overflow_at_cap"] = (prev, 40, nbrs, 40 + n_new)
    cases["overflow_past_cap"] = (prev, 40, nbrs, 40 + n_new - 7)
    # the hop before overflowed: its count passed its cap (a full
    # frontier), or the valid ids stop short of the count (a padded seed
    # vector counted at the batch size)
    prev = rng.permutation(300)[:16].astype(np.int32)
    nbrs = rng.integers(-1, 300, (16, 4)).astype(np.int32)
    cases["after_overflow"] = (prev, 23, nbrs, 60)
    cases["count_past_the_ids"] = (_frontier(prev[:10], 16), 14, nbrs, 60)
    ids = BIG + rng.permutation(3000).astype(np.int32)
    cases["ids_past_2_24"] = (_frontier(ids[:50], 64), 50,
                              _zipf(rng, ids, (64, 10)), 64 * 11)
    ids = (TOP - rng.permutation(40)).astype(np.int32)
    nbrs = _zipf(rng, ids, (16, 8))
    nbrs[0, :3] = TOP
    cases["ids_at_2_31_minus_2"] = (_frontier(ids[:12], 16), 12, nbrs,
                                    16 * 9)
    prev = rng.permutation(5000)[:30].astype(np.int32)
    nbrs = rng.integers(0, 5000, (40, 25)).astype(np.int32)
    nbrs[rng.random((40, 25)) < 0.8] = 4999
    cases["single_hub"] = (_frontier(prev, 40), 30, nbrs, 40 * 26)
    ids = rng.permutation(5000).astype(np.int32)
    cases["zipf_small"] = (_frontier(ids[:100], 128), 100,
                           _zipf(rng, ids, (128, 10)), 128 * 11)
    ids = rng.choice(1 << 25, 200_000, replace=False).astype(np.int32)
    cases["zipf_large"] = (_frontier(ids[:6000], 8000), 6000,
                           _zipf(rng, ids, (8000, 8)), 8000 * 9)
    return cases


def tile_cases():
    """name -> (frontier_prev, num_prev, neighbors, cap_new) at the
    kernel's tile boundaries."""
    rng = np.random.default_rng(23)
    cases = {}
    # 899 entries below id 1000, then an old hub's 1501 (sorted entries
    # 899-2399: it starts in tile 0, covers tile 1 and ends in tile 2),
    # then a new hub's 5000 (2400-7399: whole tiles 3 to 6), then random
    # ids and padding
    prev = np.r_[1000, rng.permutation(np.arange(1, 800))[:99]]
    nbrs = np.r_[np.arange(1, 801), np.full(1500, 1000), np.full(5000, 4000),
                 rng.integers(4001, 90_000, 2692), np.full(8, -1)]
    nbrs = rng.permutation(nbrs).astype(np.int32).reshape(1000, 10)
    cases["groups_across_tiles"] = (_frontier(prev, 128), 100, nbrs, 10_000)
    cases["one_new_entry"] = (np.zeros(0, np.int32), 0,
                              np.array([[5]], np.int32), 1)
    cases["one_old_entry"] = (np.array([5], np.int32), 1,
                              np.zeros((1, 0), np.int32), 3)
    ids = rng.choice(1 << 26, 3_000_000, replace=False).astype(np.int32)
    cases["ragged_3m"] = (_frontier(ids[:200_000], 270_001), 200_000,
                          _zipf(rng, ids, (270_001, 10)), 2_000_000)
    return cases


def _run(case, device):
    prev, num, nbrs, cap = case
    out = grow_frontier(torch.from_numpy(prev).to(device),
                        torch.tensor(num, dtype=torch.int32, device=device),
                        torch.from_numpy(nbrs).to(device), cap)
    f, n, b = out
    return [t.cpu() for t in (f, n, b.nbr_pos, b.nbr_mask, b.num_src,
                              b.num_dst)]


def _assert_same(got, want, name):
    for g, w, what in zip(got, want, ("frontier", "num_new", "nbr_pos",
                                      "nbr_mask", "num_src", "num_dst")):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{name}: {what}"


def test_cases_keep_the_frontier_contract():
    """Every case's frontier holds distinct ids in front of its padding,
    and the cases reach what they are named for."""
    cases = {**hop_cases(), **tile_cases()}
    assert len(hop_cases()) >= 12
    for name, (prev, num, nbrs, cap) in cases.items():
        valid = prev[prev >= 0]
        assert len(np.unique(valid)) == len(valid), name
        assert (prev[:len(valid)] >= 0).all(), name
        assert nbrs.dtype == prev.dtype == np.int32, name
    c = cases
    assert (_new_count(c["overflow_at_cap"][0], c["overflow_at_cap"][2])
            + 40 == c["overflow_at_cap"][3])
    assert c["ids_past_2_24"][2].max() >= BIG
    assert c["ids_at_2_31_minus_2"][2].max() == TOP
    prev, _, nbrs, _ = c["groups_across_tiles"]
    s = np.sort(np.r_[prev[prev >= 0], nbrs[nbrs >= 0]])
    assert (np.searchsorted(s, [1000, 4000]).tolist() == [899, 2400]
            and np.searchsorted(s, [1000, 4000], "right").tolist()
            == [2400, 7400])
    prev, _, nbrs, _ = c["ragged_3m"]
    total = prev.shape[0] + nbrs.size
    assert total % TILE and 2_900_000 < total <= 3_000_000


@pytest.mark.parametrize("name", sorted(hop_cases()))
def test_cpu_wrapper_is_the_plain_version_and_launches_nothing(name):
    """On CPU tensors ``dedup_tail`` is ``dedup_tail_plain`` and counts no
    launch; positions at padding slots read 0."""
    prev, num, nbrs, cap = hop_cases()[name]
    cat = torch.from_numpy(np.r_[np.where(prev >= 0, prev, SENTINEL),
                                 np.where(nbrs >= 0, nbrs,
                                          SENTINEL).ravel()].astype(np.int32))
    s, sorig = torch.sort(cat, stable=True)
    args = (s, sorig, torch.from_numpy(prev), torch.tensor(num,
                                                           dtype=torch.int32),
            cap)
    n0 = dedup_tail.launches
    got, want = dedup_tail(*args), dedup_tail_plain(*args)
    assert dedup_tail.launches == n0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[2][torch.from_numpy(nbrs.ravel()) < 0] == 0).all()


def test_wrapper_rejects_bad_arguments():
    s = torch.zeros(8, dtype=torch.int32)
    sorig = torch.arange(8)
    prev = torch.full((2,), -1, dtype=torch.int32)
    num = torch.tensor(0, dtype=torch.int32)
    for bad in ((s.long(), sorig, prev, num), (s, sorig.int(), prev, num),
                (s, sorig, prev, num.long()), (s, sorig[:4], prev, num),
                (s[:1], sorig[:1], prev, num),
                (s, sorig, prev, num.reshape(1))):
        with pytest.raises(ValueError):
            dedup_tail(*bad, 4)


def test_traffic_counts_each_byte_once():
    # s and sorig read, nbr_pos and the frontier written
    assert dedup_traffic(10, 2, 6) == 10 * 12 + 8 * 4 + 6 * 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_is_bitwise_the_plain_version(cuda):
    """Every contract and tile case: frontier, counts and block of the
    kernel path equal the CPU path's, and each hop launches the kernel
    once."""
    for name, case in {**hop_cases(), **tile_cases()}.items():
        n0 = dedup_tail.launches
        got = _run(case, cuda)
        assert dedup_tail.launches == n0 + 1, name
        _assert_same(got, _run(case, "cpu"), name)


@pytest.mark.cuda
def test_replays_of_a_captured_hop_recompute_it(cuda):
    """A captured ``grow_frontier`` gives the eager result on every replay,
    for whichever inputs its buffers hold: the tile state is reset inside
    the graph."""
    cases = tile_cases()
    a, b = cases["groups_across_tiles"], hop_cases()["single_hub"]
    prev = torch.from_numpy(a[0]).to(cuda)
    num = torch.tensor(a[1], dtype=torch.int32, device=cuda)
    nbrs = torch.from_numpy(a[2]).to(cuda)
    cap = a[3]
    # b's hop in a's shapes: its neighbors tiled over a's rows
    b_nbrs = torch.from_numpy(np.resize(b[2], a[2].shape)).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grow_frontier(prev, num, nbrs, cap)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = grow_frontier(prev, num, nbrs, cap)

    def replayed():
        graph.replay()
        f, n, blk = out
        return [t.cpu() for t in (f, n, blk.nbr_pos, blk.nbr_mask,
                                  blk.num_src, blk.num_dst)]
    want_a = _run(a, "cpu")
    want_b = _run((a[0], a[1], b_nbrs.cpu().numpy(), cap), "cpu")
    _assert_same(replayed(), want_a, "replay 1")
    _assert_same(replayed(), want_a, "replay 2")
    nbrs.copy_(b_nbrs)
    _assert_same(replayed(), want_b, "replay on new inputs")
    nbrs.copy_(torch.from_numpy(a[2]).to(cuda))
    _assert_same(replayed(), want_a, "replay on the first inputs again")
