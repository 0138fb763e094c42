"""The port's sampling kernel (``ops/sample.py``, the counterpart of K4,
``legion_tpu/ops/select_pallas.py:46``) against K4 itself.

On the JAX side K4 runs only when node ids reach 2^24 (the f32 one-hot
select is exact only below that), so the parity test builds a CSR whose
every neighbor id lies in [2^24, 2^31 - 1), routes the JAX sampler's lane
select through ``select_lanes_pallas`` in interpret mode (as
tests/test_pallas_ops.py runs it), and holds the port's plain version to
it bit for bit on the same uniforms, for each of the JAX layouts (their
tail paths included: degrees reach 300). ``sample_traffic``, the count
the kernel's bound is computed from, is held to a brute-force count on
small CSRs. The ``cuda`` test holds the kernel to the plain version bit
for bit on the card, on the ragged cases of ``tools/k4_bench.py`` too.
JAX is imported inside the parity tests only, so ``pytest --noconftest
-m cuda`` runs where JAX is absent."""

import numpy as np
import pytest
import torch

from legion_tpu_torch.ops.sample import (sample_neighbors,
                                         sample_neighbors_plain,
                                         sample_traffic)
from legion_tpu_torch.sampling import sampler
from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
from legion_tpu_torch.tools.k4_bench import ragged_cases

torch.set_num_threads(2)

BIG = 1 << 24


def _big_id_csr(seed=0, n=1000):
    """~1000 nodes with degrees 0..300 and neighbor ids >= 2^24."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 301, n)
    deg[:20] = 0
    deg[20:25] = 300
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(BIG, 2 ** 31 - 1, int(indptr[-1]),
                           dtype=np.int64).astype(np.int32)
    return indptr, indices


def _frontier(n, seed=1, pad=24):
    """Every node once (the JAX tail path assumes a deduped frontier),
    shuffled, then -1 padding."""
    rng = np.random.default_rng(seed)
    return np.r_[rng.permutation(n), [-1] * pad].astype(np.int32)


def _torch_csr(indptr, indices, device="cpu"):
    g = DeviceGraph.from_host(indptr, indices, device)
    return g.indptr, g.indices


@pytest.mark.parametrize("fanout", [10, 25])
@pytest.mark.parametrize("layout", ["windowed", "aligned", "lined"])
def test_plain_version_matches_k4_on_big_ids(monkeypatch, layout, fanout):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from legion_tpu.ops.select_pallas import select_lanes_pallas
    from legion_tpu.sampling import sampler as jax_sampler
    indptr, indices = _big_id_csr()
    g = jax_sampler.DeviceGraph.from_host(indptr, indices, layout=layout)
    assert g.lined == (layout == "lined")
    assert (g.astart is not None) == (layout == "aligned")
    assert g.big_deg_count > 0                     # the tail path runs

    calls = []

    def k4(win, off, max_id):
        # concrete inputs and a concrete result, as tests/test_pallas_ops.py
        # runs the interpreter: no other dispatch in flight around it
        win, off = np.asarray(win), np.asarray(off)
        calls.append(win.shape)
        with pltpu.force_tpu_interpret_mode():
            out = np.asarray(select_lanes_pallas(jnp.asarray(win),
                                                 jnp.asarray(off)))
        return jnp.asarray(out)

    monkeypatch.setattr(jax_sampler, "_select_lanes", k4)
    frontier = _frontier(len(indptr) - 1)
    key = jax.random.PRNGKey(fanout)
    want = np.asarray(jax_sampler.sample_neighbors(
        key, g, jnp.asarray(frontier), fanout))
    assert calls and calls[0][1] == (256 if layout == "windowed" else 128)
    u = np.array(jax.random.uniform(key, (len(frontier), fanout),
                                    dtype=jnp.float32))
    got = sample_neighbors(*_torch_csr(indptr, indices),
                           torch.from_numpy(frontier), torch.from_numpy(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[want >= 0] >= BIG).all()
    assert (want == -1).any() and (want >= BIG).sum() > 0.5 * want.size


def test_draw_rounds_in_float32():
    """u * deg rounds up to deg for u just below 1: the draw clamps to
    deg - 1; with one neighbor every slot past the first is -1."""
    indptr = torch.tensor([0, 3, 4, 4], dtype=torch.int32)
    indices = torch.tensor([7, 8, 9, 5], dtype=torch.int32)
    top = float(np.nextafter(np.float32(1), np.float32(0)))
    u = torch.tensor([[top, 0.0, 0.34], [0.5, top, 0.0], [0.1, 0.2, 0.3],
                      [0.9, 0.9, 0.9]], dtype=torch.float32)
    frontier = torch.tensor([0, 1, 2, -1], dtype=torch.int32)
    got = sample_neighbors(indptr, indices, frontier, u)
    assert got.tolist() == [[9, 7, 8], [5, -1, -1], [-1, -1, -1],
                            [-1, -1, -1]]


def test_cpu_tensors_take_the_plain_version_without_launching():
    indptr, indices = _torch_csr(*_big_id_csr())
    frontier = torch.from_numpy(_frontier(1000))
    u = torch.rand((frontier.shape[0], 7),
                   generator=torch.Generator().manual_seed(0))
    n0 = sample_neighbors.launches
    assert torch.equal(sample_neighbors(indptr, indices, frontier, u),
                       sample_neighbors_plain(indptr, indices, frontier, u))
    assert sample_neighbors.launches == n0


def test_sample_neighbors_rejects_bad_arguments():
    indptr, indices = _torch_csr(*_big_id_csr())
    frontier = torch.arange(10, dtype=torch.int32)
    u = torch.zeros((10, 3))
    with pytest.raises(ValueError, match="int32"):
        sample_neighbors(indptr.long(), indices, frontier, u)
    with pytest.raises(ValueError, match="int32"):
        sample_neighbors(indptr, indices, frontier.long(), u)
    with pytest.raises(ValueError, match="float32"):
        sample_neighbors(indptr, indices, frontier, u.double())
    with pytest.raises(ValueError, match="float32"):
        sample_neighbors(indptr, indices, frontier, u[:9])
    with pytest.raises(ValueError, match="empty"):
        sample_neighbors(indptr, indices[:0], frontier, u)


def test_sampler_routes_every_hop_through_the_wrapper(monkeypatch,
                                                      small_graph):
    calls = []

    def counted(*args):
        calls.append(args[3].shape)
        return sample_neighbors(*args)

    monkeypatch.setattr(sampler, "sample_kernel", counted)
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices, "cpu")
    s = torch.arange(64, dtype=torch.int32)
    batch = sample_batch(g, s, torch.tensor(64, dtype=torch.int32), s,
                         (5, 3), generator=torch.Generator().manual_seed(0))
    assert calls == [(64, 5), (384, 3)]
    assert batch.frontier.shape[0] == 1536


def _brute_traffic(indptr, frontier, u):
    """sample_traffic's three counts, slot by slot in Python."""
    indptr, frontier, u = indptr.numpy(), frontier.numpy(), u.numpy()
    p, f = u.shape
    useful = sector = 4 * p + 4 * p * f           # frontier and out
    valid, ptr_sec, idx_sec, u_sec = 0, set(), set(), set()
    for r in range(p):
        node = int(frontier[r])
        if node < 0:
            continue
        useful += 8
        ptr_sec |= {node // 8, (node + 1) // 8}
        start = int(indptr[node])
        deg = int(indptr[node + 1]) - start
        for j in range(min(deg, f)):
            draw = min(int(np.float32(u[r, j]) * np.float32(deg)), deg - 1)
            valid += 1
            useful += 8
            idx_sec.add((start + draw) // 8)
            u_sec.add((r * f + j) // 8)
    sector += 32 * (len(ptr_sec) + len(idx_sec) + len(u_sec))
    return {"valid_slots": valid, "useful_bytes": useful,
            "sector_bytes": sector}


def _traffic_case(name):
    """Small hand-built CSRs, each aimed at one part of the count."""
    i32 = dict(dtype=torch.int32)
    if name == "degree_zero":
        # node 1 has no neighbor: its indptr pair is read, nothing else
        indptr = torch.tensor([0, 3, 3, 4, 12], **i32)
        frontier = torch.tensor([0, 1, 2, 3, 1], **i32)
        f = 4
    elif name == "shared_sector":
        # node 0's run lies in one sector and node 1's spans two; node 0
        # repeats, so its draws and its indptr pair share sectors
        indptr = torch.tensor([0, 8, 14, 14], **i32)
        frontier = torch.tensor([0, 0, 1, 0, 2], **i32)
        f = 6
    elif name == "padding":
        # -1 rows read nothing; whole and partial u sectors
        indptr = torch.tensor([0, 40, 41, 50], **i32)
        frontier = torch.tensor([-1, 0, -1, -1, 2, 1, -1], **i32)
        f = 10
    else:
        # ids past 2^24: the counts stay exact integers
        assert name == "big_ids"
        n = BIG + 16
        deg = torch.zeros(n, dtype=torch.int64)
        deg[[3, BIG + 1, BIG + 2, BIG + 9, BIG + 15]] = torch.tensor(
            [5, 30, 1, 12, 7])
        indptr = torch.zeros(n + 1, dtype=torch.int64)
        indptr[1:] = torch.cumsum(deg, 0)
        indptr = indptr.to(torch.int32)
        frontier = torch.tensor([BIG + 1, BIG + 2, -1, 3, BIG + 9, BIG + 15,
                                 BIG + 4, BIG + 1], **i32)
        f = 25
    u = torch.rand((frontier.shape[0], f),
                   generator=torch.Generator().manual_seed(len(name)))
    u[:, -1] = float(np.nextafter(np.float32(1), np.float32(0)))
    return indptr, frontier, u


@pytest.mark.parametrize("name", ["degree_zero", "shared_sector", "padding",
                                  "big_ids"])
def test_sample_traffic_counts_what_a_brute_force_count_does(name):
    indptr, frontier, u = _traffic_case(name)
    got = sample_traffic(indptr, frontier, u)
    assert got == _brute_traffic(indptr, frontier, u)
    indices = torch.arange(int(indptr[-1]), dtype=torch.int32)
    out = sample_neighbors_plain(indptr, indices, frontier, u)
    assert got["valid_slots"] == int((out >= 0).sum())


@pytest.fixture(scope="module")
def ragged():
    return {name: args for name, *args in ragged_cases()}


def test_ragged_cases_reach_every_edge(ragged):
    """The sweep the card holds the kernel to has what it claims: 28
    cases, degrees 0, 1 and > 2^16 in its frontiers, ids past 2^24, a
    whole tile of -1, a tile of degree-0 nodes and uniforms below 1.0
    that round up."""
    assert len(ragged) == 28
    indptr, _, frontier, u = ragged["p8017_f64"]
    deg = (indptr[1:] - indptr[:-1])[frontier[frontier >= 0].long()]
    assert {0, 1}.issubset(set(deg.tolist())) and int(deg.max()) > 1 << 16
    assert int(frontier.max()) >= BIG
    assert (frontier[32:64] == -1).all()
    assert (frontier[64:96] >= 0).all()
    assert ((indptr[frontier[64:96].long() + 1]
             - indptr[frontier[64:96].long()]) == 0).all()
    top = float(np.nextafter(np.float32(1), np.float32(0)))
    assert (u == top).any()
    assert ragged["p1_f25"][2].tolist() == [int(frontier[0])]


@pytest.mark.parametrize("name", ["p1_f25", "p31_f7", "p33_f33", "p33_f64"])
def test_sample_traffic_on_ragged_cases(ragged, name):
    indptr, _, frontier, u = ragged[name]
    assert sample_traffic(indptr, frontier, u) == _brute_traffic(
        indptr, frontier, u)


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("fanout", [10, 25])
def test_cuda_sample_neighbors_is_bitwise_the_plain_version(fanout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    indptr, indices = _torch_csr(*_big_id_csr(), device=dev)
    frontier = torch.from_numpy(_frontier(1000)).to(dev)
    for seed in range(3):
        u = torch.rand((frontier.shape[0], fanout), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))
        if seed == 2:     # draws that round up to deg and clamp
            u = torch.full_like(u, float(np.nextafter(np.float32(1),
                                                      np.float32(0))))
        n0 = sample_neighbors.launches
        got = sample_neighbors(indptr, indices, frontier, u)
        assert sample_neighbors.launches == n0 + 1
        assert torch.equal(got, sample_neighbors_plain(indptr, indices,
                                                       frontier, u))
    with pytest.raises(ValueError, match="device"):
        sample_neighbors(indptr, indices, frontier.cpu(), u)
    if fanout != 10:
        return
    # the ragged edges of the warp-per-tile design, once
    for name, *args in ragged_cases():
        args = [t.to(dev) for t in args]
        n0 = sample_neighbors.launches
        got = sample_neighbors(*args)
        assert sample_neighbors.launches == n0 + 1
        assert torch.equal(got, sample_neighbors_plain(*args)), name
