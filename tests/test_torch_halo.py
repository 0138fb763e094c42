"""The halo exchange of the edge-partitioned path
(``legion_tpu_torch/parallel/halo.py``, the caps and owner table of
``parallel/multihost.py``, ``utils.comm.ppermute`` and the halo closed
forms) against ``legion_tpu``; the counterparts of ``tests/test_halo.py``.

The pure pieces run in this process: ``HostShard``'s arrays, the local
lookup, the routing by ring distance and the probed per-distance caps must
equal the reference's exactly. The exchanges run in one spawn of 4
single-threaded gloo ranks, as one group of 4 and as two groups of 2, and
write what they saw to files; the reference runs the same requests under
``shard_map`` on the virtual CPU devices of ``tests/conftest.py``, each
host drawing its own (k * M, fanout) grid, which reaches the ranks in a
file. Draws and rows must be bitwise the reference's, through the exact
and the psum exchange alike; the overflow counts equal; every collective's
counted bytes equal to the closed forms. Only the reference helpers
import JAX, inside the functions this process runs."""

import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from legion_tpu_torch.data.partition import partition_graph
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.parallel import halo, mesh
from legion_tpu_torch.parallel import multihost
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.seeds import shard_node_set
from legion_tpu_torch.utils import comm

torch.set_num_threads(2)

WORLD = 4
HOP_M, FANOUT, FETCH_M, TIGHT = 64, 5, 48, 8
PROBE_B, PROBE_FANOUTS = 32, (4, 3)


def _graph():
    """conftest's ``small_graph``, built here so that the ranks need no
    conftest."""
    return random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=7, seed=1)


def _requests(kind, k, host):
    """Host ``host``'s requests of a case: hop frontiers with -1 padding,
    fetch ids with -1 padding, or fetch ids with no padding (to overflow
    the tight caps as the reference's test does)."""
    rng = np.random.default_rng({"hop": 3, "fetch": 7, "dense": 5}[kind]
                                + 100 * k + host)
    n = 2000
    if kind == "hop":
        return rng.integers(-1, n, size=HOP_M).astype(np.int32)
    if kind == "fetch":
        return rng.integers(-1, n, size=FETCH_M).astype(np.int32)
    return rng.integers(0, n, size=FETCH_M).astype(np.int32)


def _dcaps(k, tight):
    m = HOP_M
    return (TIGHT,) * (k - 1) if tight else (m,) * (k - 1)


# -- the ranks ----------------------------------------------------------------

def _exchange_rank(device, d):
    """Every case at k = 4 (the world) and k = 2 (groups {0, 1}, {2, 3});
    the outputs, overflow counts and counted bytes."""
    rank = dist.get_rank()
    g = _graph()
    grids = np.load(os.path.join(d, "grids.npz"))
    probe = np.load(os.path.join(d, "probe.npz"))
    groups = {4: None}
    for lo in (0, 2):           # every rank makes every group, in order
        pair = dist.new_group([lo, lo + 1])
        if rank in (lo, lo + 1):
            groups[2] = pair
    out = {}
    for k, group in groups.items():
        p = dist.get_rank(group)
        part = partition_graph(g, k, mode="greedy")
        shard = halo.HostShard.to_device(halo.HostShard.build(
            g.indptr, g.indices, g.features, part, k)[p], device)
        owner = multihost.owner_table(part, device)
        u = torch.from_numpy(grids[f"k{k}_h{p}"])
        hop_ids = torch.from_numpy(_requests("hop", k, p))
        for tight in (False, True):
            dcaps = _dcaps(k, tight)
            comm.reset_counts()
            ex, ov = halo.partitioned_sample_hop_exact(shard, owner, u,
                                                       hop_ids, dcaps, group)
            out[("hop", k, tight)] = (ex, int(ov), comm.read_counts(),
                                      comm.read_calls())
        comm.reset_counts()
        out[("hop_psum", k)] = (halo.partitioned_sample_hop(
            shard, u, hop_ids, group), comm.read_counts())
        for kind in ("fetch", "dense"):
            ids = torch.from_numpy(_requests(kind, k, p))
            for tight in (False, True):
                comm.reset_counts()
                rows, ov = halo.partitioned_row_fetch_exact(
                    shard, owner, ids, _dcaps(k, tight), group)
                out[(kind, k, tight)] = (rows, int(ov), comm.read_counts(),
                                         comm.read_calls())
            comm.reset_counts()
            out[(f"{kind}_psum", k)] = (halo.partitioned_row_fetch(
                shard, ids, group), comm.read_counts())
    # probed caps on the real step: 4 ranks, greedy parts, each rank's
    # probe batch through the exact sampler and fetch
    part = partition_graph(g, WORLD, mode="greedy")
    shard = halo.HostShard.to_device(halo.HostShard.build(
        g.indptr, g.indices, g.features, part, WORLD)[rank], device)
    dcaps = tuple(int(c) for c in probe["dcaps"])
    caps = frontier_caps(PROBE_B, PROBE_FANOUTS)
    path = multihost.HaloPath(shard, multihost.owner_table(part, device),
                              dcaps)
    seeds = torch.from_numpy(probe[f"seeds{rank}"])
    batch = path.sampler(PROBE_FANOUTS, caps)(
        shard, seeds, torch.tensor(PROBE_B, dtype=torch.int32),
        torch.zeros_like(seeds), torch.Generator().manual_seed(rank), None)
    x = path.fetch(shard.feat_rows, batch.frontier)
    out["probed"] = {"overflow": int(path.overflow),
                     "frontier": batch.frontier, "x": x}
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


# -- the reference ------------------------------------------------------------

def _ref_grids(k):
    """Each host's (k * M, fanout) grid: uniform from PRNGKey(11) folded
    with the host index."""
    import jax
    return [np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(11), h), (k * HOP_M, FANOUT),
        dtype=jax.numpy.float32)) for h in range(k)]


def _ref_run(k, kind, dcaps):
    """The reference's exact and psum exchanges of ``kind`` on k virtual
    devices: (exact (k, M, ...), psum (k, M, ...), overflow (k,))."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from legion_tpu.data.partition import partition_graph as jpart
    from legion_tpu.parallel import halo as jhalo
    g = _graph()
    jm = Mesh(np.array(jax.devices()[:k]), ("data",))
    part = jpart(g, k, mode="greedy")
    parts = jhalo.HostShard.build(g.indptr, g.indices, g.features, part, k)
    sh = NamedSharding(jm, P("data"))
    stacked = [jax.device_put(jnp.asarray(np.stack([p[i] for p in parts])),
                              sh) for i in range(4)]
    owner = jax.device_put(jnp.asarray(part.astype(np.int8)),
                           NamedSharding(jm, P()))
    ids = jax.device_put(jnp.asarray(np.concatenate(
        [_requests(kind, k, h) for h in range(k)])), sh)

    def f(owned, sp, si, fr, owner_t, ids):
        shard = jhalo.HostShard(owned_ids=owned[0], sub_indptr=sp[0],
                                sub_indices=si[0], feat_rows=fr[0])
        if kind == "hop":
            key = jax.random.fold_in(jax.random.PRNGKey(11),
                                     jax.lax.axis_index("data"))
            ex, ov = jhalo.partitioned_sample_hop_exact(
                shard, owner_t, key, ids, FANOUT, "data", dcaps)
            ps = jhalo.partitioned_sample_hop(shard, key, ids, FANOUT,
                                              "data")
        else:
            ex, ov = jhalo.partitioned_row_fetch_exact(shard, owner_t, ids,
                                                       "data", dcaps)
            ps = jhalo.partitioned_row_fetch(shard, ids, "data")
        return ex, ps, ov[None]

    ex, ps, ov = jax.jit(jax.shard_map(
        f, mesh=jm, in_specs=(P("data"),) * 4 + (P(), P("data")),
        out_specs=(P("data"),) * 3))(*stacked, owner, ids)
    m = HOP_M if kind == "hop" else FETCH_M
    return (np.asarray(ex).reshape(k, m, -1), np.asarray(ps).reshape(k, m, -1),
            np.asarray(ov))


def _probe_caps_reference():
    """The reference's probed caps for 4 greedy parts of the graph, and
    the batches it probed first (rank i's seeds)."""
    from legion_tpu.data.partition import partition_graph as jpart
    from legion_tpu.parallel.multihost import probe_dist_caps
    g = _graph()
    part = jpart(g, WORLD, mode="greedy")
    shards = shard_node_set(np.asarray(g.train_ids), WORLD, part)
    caps = frontier_caps(PROBE_B, PROBE_FANOUTS)
    dcaps = probe_dist_caps(g.indptr, g.indices, part, shards,
                            PROBE_FANOUTS, caps, WORLD, PROBE_B)
    rng = np.random.default_rng(0 * 7907 + 3)
    seeds = {f"seeds{i}": rng.permutation(shards[i])[:PROBE_B].astype(
        np.int32) for i in range(WORLD)}
    return np.asarray(dcaps), seeds


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "grids.npz"), **{
            f"k{k}_h{h}": u for k in (WORLD, 2)
            for h, u in enumerate(_ref_grids(k))})
        dcaps, seeds = _probe_caps_reference()
        np.savez(os.path.join(d, "probe.npz"), dcaps=dcaps, **seeds)
        mesh.spawn(_exchange_rank, WORLD, "cpu", args=(d,), threads=1)
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(WORLD)]


def _host_of(rank, k):
    return rank % k


# -- the pure pieces ----------------------------------------------------------

@pytest.mark.parametrize("mode,k", [("hash", 4), ("greedy", 4),
                                    ("greedy", 2), ("greedy", 1)])
def test_host_shards_are_the_reference_arrays(small_graph, mode, k):
    from legion_tpu.parallel.halo import HostShard as JaxShard
    part = partition_graph(small_graph, k, mode=mode)
    args = (small_graph.indptr, small_graph.indices, small_graph.features,
            part, k)
    got, want = halo.HostShard.build(*args), JaxShard.build(*args)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for x, y in zip(halo.HostShard.part_shapes(*args[:1], part, k),
                    JaxShard.part_shapes(*args[:1], part, k)):
        np.testing.assert_array_equal(x, y)
    padded = halo.HostShard.build(*args, pad_to=(2100, 20000))
    assert padded[0][0].shape == (2100,) and padded[0][2].shape == (20000,)
    for a, b in zip(padded, JaxShard.build(*args, pad_to=(2100, 20000))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_host_shards_are_the_reference_arrays_at_scale():
    """300,000 nodes and 3.6M edges in 4 hash parts: every array of
    every part equal to the reference's."""
    from legion_tpu.parallel.halo import HostShard as JaxShard
    g = random_power_law_graph(num_nodes=300_000, avg_degree=12,
                               feature_dim=8, num_classes=4, seed=3)
    part = (np.arange(g.num_nodes) % 4).astype(np.int32)
    rows, edges = halo.HostShard.part_shapes(g.indptr, part, 4)
    for p in range(4):
        args = (g.indptr, g.indices, g.features, part, p,
                int(rows.max()), int(edges.max()))
        for x, y in zip(halo.HostShard.build_one(*args),
                        JaxShard.build_one(*args)):
            np.testing.assert_array_equal(x, y)


def test_local_lookup_is_the_reference(small_graph):
    import jax.numpy as jnp

    from legion_tpu.parallel.halo import _local_lookup as jax_lookup
    part = partition_graph(small_graph, 3, mode="greedy")
    owned = halo.HostShard.build(small_graph.indptr, small_graph.indices,
                                 small_graph.features, part, 3)[1][0]
    ids = np.random.default_rng(0).integers(-3, 2000, size=500).astype(
        np.int32)
    ids[:3] = [0, 1999, halo.INT32_MAX - 1]
    mine, pos = halo._local_lookup(torch.from_numpy(owned),
                                   torch.from_numpy(ids))
    jmine, jpos = jax_lookup(jnp.asarray(owned), jnp.asarray(ids))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(jmine))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    real = (ids >= 0) & (ids < 2000)
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(
        mine.numpy(), real & (part[np.where(real, ids, 0)] == 1))


@pytest.mark.parametrize("k,caps", [(2, (5,)), (4, (3, 40, 1)),
                                    (8, (2,) * 7), (4, (64, 64, 64))])
def test_route_by_distance_gives_the_reference_rounds(k, caps):
    """One scatter at (distance, position) gives each round's send buffer
    (ids and grid rows), positions and overflow as the reference's sort
    grouping and round slices do."""
    import jax.numpy as jnp

    from legion_tpu.parallel.halo import _dist_grouping, _round_send
    rng = np.random.default_rng(k)
    m = 64
    ids = rng.integers(-1, 500, size=m).astype(np.int32)
    dist_ = np.where(ids >= 0, rng.integers(0, k, size=m), k).astype(
        np.int32)
    if k == 4:
        dist_[ids >= 0] = np.where(rng.random((ids >= 0).sum()) < 0.6, 1,
                                   dist_[ids >= 0])
    gidx = (np.arange(m) + 7 * m).astype(np.int32)
    send, slot, ov, pay = halo.route_by_distance(
        torch.from_numpy(ids), torch.from_numpy(dist_), k, caps,
        payload=torch.from_numpy(gidx))
    pos, counts, s_ids, s_g = _dist_grouping(
        jnp.asarray(ids), jnp.asarray(dist_), k, extra=jnp.asarray(gidx))
    start = jnp.cumsum(counts) - counts
    want_ov = 0
    off = 0
    for r in range(1, k):
        cap = caps[r - 1]
        np.testing.assert_array_equal(
            send[off:off + cap].numpy(),
            np.asarray(_round_send(s_ids, start, counts, r, cap, -1)))
        np.testing.assert_array_equal(
            pay[off:off + cap].numpy(),
            np.asarray(_round_send(s_g, start, counts, r, cap, 0)))
        sel = (dist_ == r) & (np.asarray(pos) < cap)
        np.testing.assert_array_equal(slot.numpy()[sel],
                                      off + np.asarray(pos)[sel])
        want_ov += max(int(counts[r]) - cap, 0)
        off += cap
    remote = (dist_ > 0) & (dist_ < k)
    sent = np.zeros(m, bool)
    cap_of = np.array([0] + list(caps))[np.minimum(dist_, k - 1)]
    sent[remote] = np.asarray(pos)[remote] < cap_of[remote]
    assert ((slot.numpy() >= 0) == sent).all()
    assert int(ov) == want_ov
    if k == 4 and caps[0] == 3:
        assert want_ov > 0


def test_owner_table(small_graph):
    part = partition_graph(small_graph, 4, mode="greedy")
    t = multihost.owner_table(part, "cpu")
    assert t.dtype == torch.int8 and t.shape == (2000,)
    np.testing.assert_array_equal(t.numpy(), part)
    with pytest.raises(ValueError, match="127 parts"):
        multihost.owner_table(np.array([0, 127], np.int32), "cpu")


@pytest.mark.parametrize("k", [2, 4])
def test_probed_caps_are_the_reference(small_graph, k):
    """``probe_dist_caps`` over random train batches and
    ``probe_dist_caps_batches`` over the eval schedule's chunks: the
    reference's caps, within the frontier cap, below the loose bound."""
    from legion_tpu.parallel import multihost as jax_multihost
    part = partition_graph(small_graph, k, mode="greedy")
    shards = shard_node_set(np.asarray(small_graph.train_ids), k, part)
    caps = frontier_caps(32, PROBE_FANOUTS)
    args = (small_graph.indptr, small_graph.indices, part, shards,
            PROBE_FANOUTS, caps, k, 32)
    got = multihost.probe_dist_caps(*args, slack=1.05, probes=3, seed=4)
    assert got == jax_multihost.probe_dist_caps(*args, slack=1.05, probes=3,
                                                seed=4)
    assert len(got) == k - 1 and all(8 <= c <= caps[-1] for c in got)
    assert sum(got) < (k - 1) * caps[-1]
    batches = [(i, s[:20]) for i, s in enumerate(shards)]
    bargs = (small_graph.indptr, small_graph.indices, part, batches,
             PROBE_FANOUTS, caps, k)
    assert multihost.probe_dist_caps_batches(*bargs) == \
        jax_multihost.probe_dist_caps_batches(*bargs)


def test_halo_closed_forms_are_the_reference():
    from legion_tpu.utils import comm as jax_comm
    for dcaps in ((8,), (64, 16, 8), (0, 5, 9, 1)):
        assert comm.halo_exact_fetch_bytes(dcaps, 32) == \
            jax_comm.halo_exact_fetch_bytes(dcaps, 32)
        assert comm.halo_exact_hop_bytes(dcaps, 10) == \
            jax_comm.halo_exact_hop_bytes(dcaps, 10)
    for k in (1, 2, 4, 8):
        assert comm.link_bytes({"collective-permute": 1000}, k) == \
            jax_comm.link_bytes({"collective-permute": 1000}, k) == 1000


def test_host_shard_refuses_ids_at_the_padding():
    """Ids must stay below INT32_MAX, the owned ids' padding: a graph that
    large (here an indptr of 2^31 + 1 entries that takes no memory) is
    refused before any array is built."""
    indptr = np.broadcast_to(np.int64(0), (halo.INT32_MAX + 1,))
    with pytest.raises(ValueError, match="below 2"):
        halo.HostShard.build_one(indptr, None, None, None, 0, 1, 1)


# -- the exchanges at 2 and 4 ranks -------------------------------------------

@pytest.mark.parametrize("k", [WORLD, 2])
@pytest.mark.parametrize("tight", [False, True], ids=["loose", "tight"])
def test_exact_hop_draws_are_the_reference(ranks, k, tight):
    """The exact hop's draws bitwise the reference's (-1 past a cap), the
    same overflow, and at loose caps bitwise the psum hop's."""
    ex, ps, ov = _ref_run(k, "hop", _dcaps(k, tight))
    for r, got in enumerate(ranks):
        h = _host_of(r, k)
        draws, n_ov, _, _ = got[("hop", k, tight)]
        np.testing.assert_array_equal(draws.numpy(), ex[h])
        assert n_ov == int(ov[h])
        if not tight:
            assert n_ov == 0
            np.testing.assert_array_equal(draws.numpy(), ps[h])
    if tight:
        assert ov.sum() > 0, "the tight caps must overflow"


@pytest.mark.parametrize("k", [WORLD, 2])
def test_psum_hop_draws_are_the_reference_and_the_graph(ranks, k,
                                                        small_graph):
    _, ps, _ = _ref_run(k, "hop", _dcaps(k, False))
    indptr, indices = small_graph.indptr, small_graph.indices
    for r, got in enumerate(ranks):
        h = _host_of(r, k)
        draws = got[("hop_psum", k)][0].numpy()
        np.testing.assert_array_equal(draws, ps[h])
        for v, row in zip(_requests("hop", k, h), draws):
            if v < 0:
                assert (row == -1).all()
                continue
            deg = int(indptr[v + 1] - indptr[v])
            nbrs = set(indices[indptr[v]:indptr[v + 1]].tolist())
            assert all(x in nbrs for x in row[:min(deg, FANOUT)])
            assert (row[deg:] == -1).all()


@pytest.mark.parametrize("k", [WORLD, 2])
@pytest.mark.parametrize("kind", ["fetch", "dense"])
@pytest.mark.parametrize("tight", [False, True], ids=["loose", "tight"])
def test_exact_fetch_rows_are_the_reference(ranks, small_graph, k, kind,
                                            tight):
    """Rows bitwise the reference's exact fetch (zero past a cap), the
    same overflow count; at loose caps bitwise the psum fetch and the
    feature rows themselves."""
    ex, ps, ov = _ref_run(k, kind, _dcaps(k, tight))
    feats = small_graph.features
    for r, got in enumerate(ranks):
        h = _host_of(r, k)
        rows, n_ov, _, _ = got[(kind, k, tight)]
        np.testing.assert_array_equal(rows.numpy(), ex[h])
        assert n_ov == int(ov[h])
        np.testing.assert_array_equal(got[(f"{kind}_psum", k)][0].numpy(),
                                      ps[h])
        if not tight:
            ids = _requests(kind, k, h)
            want = np.where((ids >= 0)[:, None],
                            feats[np.clip(ids, 0, None)], 0)
            np.testing.assert_array_equal(rows.numpy(), want)
            np.testing.assert_array_equal(rows.numpy(), ps[h])
    if tight and kind == "dense":
        assert ov.sum() > 0, "the tight caps must overflow"


@pytest.mark.parametrize("k", [WORLD, 2])
def test_exchange_bytes_are_the_closed_forms(ranks, k):
    """Exact: 2 (k - 1) ppermutes, counted as the reference's
    collective-permute, of ``halo_exact_*_bytes``; psum: the all-gather
    and reduce-scatter of ``psum_exchange_bytes``."""
    for got in ranks:
        for tight in (False, True):
            dcaps = _dcaps(k, tight)
            _, _, counted, calls = got[("hop", k, tight)]
            assert counted == comm.halo_exact_hop_bytes(dcaps, FANOUT)
            assert calls == {"collective-permute": 2 * (k - 1)}
            for kind in ("fetch", "dense"):
                _, _, counted, calls = got[(kind, k, tight)]
                assert counted == comm.halo_exact_fetch_bytes(dcaps, 32)
                assert calls == {"collective-permute": 2 * (k - 1)}
        assert got[("hop_psum", k)][1] == comm.psum_exchange_bytes(
            HOP_M, k, FANOUT)
        assert got[("fetch_psum", k)][1] == comm.psum_exchange_bytes(
            FETCH_M, k, 32)


def test_probed_caps_bound_the_realized_requests(ranks, small_graph):
    """A batch of the probe's own seeds through the exact sampler and
    fetch at the probed caps: nothing capped, and the rows are the
    frontier's features."""
    feats = small_graph.features
    for got in ranks:
        p = got["probed"]
        assert p["overflow"] == 0
        f = p["frontier"].numpy()
        want = np.where((f >= 0)[:, None], feats[np.clip(f, 0, None)], 0)
        np.testing.assert_array_equal(p["x"].numpy(), want)
        assert (f >= 0).sum() > PROBE_B


def test_ppermute_refuses_a_shift_to_self(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="sends to self"):
            comm.ppermute(torch.zeros(3), 1)
    finally:
        dist.destroy_process_group()
