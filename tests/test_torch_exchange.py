"""The row exchange over a cache group (``parallel/feature_exchange.py``),
its counting collectives (``utils/comm.py``), the cache groups of
``parallel/mesh.py`` and the striped plan's demotion
(``cache/striped.py``), against ``legion_tpu``.

The pure functions (routing, caps, counts, demotion) run in this process
on the same ids as the reference's and must agree exactly. The exchanges
run in one spawn of 4 single-threaded gloo ranks, which write what they
saw to files; the reference runs the same ids under ``shard_map`` on the
virtual CPU devices of ``tests/conftest.py``. Rows must be bitwise equal,
the overflow counts equal, and every collective's counted bytes equal the
closed forms (themselves equal to the reference's). Only the reference
helpers import JAX, inside the functions this process runs."""

import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from legion_tpu_torch.cache.feature_cache import FeatureCache
from legion_tpu_torch.cache.striped import StripedFeatureCache
from legion_tpu_torch.parallel import feature_exchange as fx
from legion_tpu_torch.parallel import mesh
from legion_tpu_torch.utils import comm

N, D, M, K = 203, 8, 40, 4


def _ids(kind, rank, k=K, m=M, n=N):
    """Rank ``rank``'s (m,) requests of a case: uniform with -1 padding
    and repeats, all owned by owner 0 (past any cap), or mostly owner 1."""
    rng = np.random.default_rng(100 * rank + {"uniform": 1, "skewed": 2,
                                              "lopsided": 3}[kind])
    if kind == "uniform":
        return rng.integers(-1, n, size=m).astype(np.int32)
    if kind == "skewed":
        return (rng.integers(0, n // k, size=m) * k).astype(np.int32)
    ids = rng.integers(0, n // k, size=m) * k + 1
    ids[::5] = -1
    return np.minimum(ids, n - 1).astype(np.int32)


CASES = [("uniform", None), ("skewed", None), ("lopsided", None),
         ("uniform", 8), ("lopsided", 16)]


def _table():
    return np.random.default_rng(7).standard_normal((N, D)).astype(
        np.float32)


# -- the ranks ----------------------------------------------------------------

def _exchange_rank(device, d):
    """Every exchange case over the whole world as one cache group, and
    one over cache groups of 2; the outputs and the bytes each counted."""
    rank = dist.get_rank()
    table = _table()
    out = {}
    for k in (K, 2):
        m_ = mesh.make_mesh(k)
        local = torch.from_numpy(fx.stripe_rows(table, k, m_.cache_rank))
        for kind, cap in CASES:
            ids = torch.from_numpy(_ids(kind, rank))
            comm.reset_counts()
            rows, ov = fx.sharded_row_fetch_stats(local, ids, m_.group, cap)
            exact = (rows, int(ov), comm.read_counts(), comm.read_calls())
            comm.reset_counts()
            ps = fx.sharded_row_fetch_psum(local, ids, m_.group)
            out[(k, kind, cap)] = {"exact": exact, "psum": (
                ps, comm.read_counts(), comm.read_calls())}
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as d:
        mesh.spawn(_exchange_rank, K, "cpu", args=(d,), threads=1)
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(K)]


# -- the reference ------------------------------------------------------------

def _ref_exchange(kind, cap, k):
    """The reference's exact and psum exchanges on every rank's ids, with
    ``k`` virtual devices to a cache group: ((world, M, D) rows,
    (world,) overflow, (world, M, D) psum rows)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from legion_tpu.parallel.feature_exchange import (
        shard_rows, sharded_row_fetch_psum, sharded_row_fetch_stats)
    world = K
    jm = Mesh(np.array(jax.devices()[:world]).reshape(world // k, k),
              ("data", "cache"))
    table = _table()
    rows = jax.device_put(shard_rows(table, k).reshape(-1, D),
                          NamedSharding(jm, P("cache")))
    ax = P(("data", "cache"))
    ids = jax.device_put(
        jnp.asarray(np.concatenate([_ids(kind, r) for r in range(world)])),
        NamedSharding(jm, ax))

    def ex(rl, il):
        o, ov = sharded_row_fetch_stats(rl, il, "cache", cap)
        return o, ov[None], sharded_row_fetch_psum(rl, il, "cache")

    o, ov, ps = jax.jit(jax.shard_map(
        ex, mesh=jm, in_specs=(P("cache"), ax),
        out_specs=(ax, ax, ax)))(rows, ids)
    return (np.asarray(o).reshape(world, M, D), np.asarray(ov),
            np.asarray(ps).reshape(world, M, D))


# -- the checks ---------------------------------------------------------------

@pytest.mark.parametrize("k", [K, 2])
@pytest.mark.parametrize("kind,cap", CASES)
def test_exact_exchange_matches_the_reference(ranks, kind, cap, k):
    """Rows bitwise the reference's (zero for padding and past the cap),
    the same overflow count, and the rows of the table where served."""
    want, want_ov, _ = _ref_exchange(kind, cap, k)
    table = _table()
    for r, got in enumerate(ranks):
        rows, ov, _, _ = got[(k, kind, cap)]["exact"]
        np.testing.assert_array_equal(rows.numpy(), want[r])
        assert ov == int(want_ov[r])
        ids = _ids(kind, r)
        served = (rows.abs().sum(1) > 0).numpy()
        np.testing.assert_array_equal(rows.numpy()[served],
                                      table[ids[served]])
    if kind == "skewed" and cap is None:      # everything to owner 0
        assert all(g[(k, kind, cap)]["exact"][1] == M - fx.owner_cap(M, k)
                   for g in ranks)


@pytest.mark.parametrize("k", [K, 2])
@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_psum_exchange_matches_the_reference(ranks, kind, k):
    """The cap-free oracle: every valid request gets its row."""
    _, _, want = _ref_exchange(kind, None, k)
    table = _table()
    for r, got in enumerate(ranks):
        ps = got[(k, kind, None)]["psum"][0].numpy()
        np.testing.assert_array_equal(ps, want[r])
        ids = _ids(kind, r)
        np.testing.assert_array_equal(
            ps, np.where((ids >= 0)[:, None], table[np.clip(ids, 0, None)],
                         0))


@pytest.mark.parametrize("k", [K, 2])
@pytest.mark.parametrize("kind,cap", CASES)
def test_exchange_bytes_are_the_closed_forms(ranks, kind, cap, k):
    """Two all-to-alls of the exact exchange, an all-gather and a
    reduce-scatter of the psum one, each of the closed form's bytes."""
    for got in ranks:
        _, _, counts, calls = got[(k, kind, cap)]["exact"]
        assert calls == {"all_to_all": 2}
        assert counts == comm.exact_exchange_bytes(M, k, D, cap=cap)
        _, pcounts, pcalls = got[(k, kind, cap)]["psum"]
        assert pcalls == {"all_gather": 1, "reduce_scatter": 1}
        assert pcounts == comm.psum_exchange_bytes(M, k, D)


def test_closed_forms_are_the_references():
    from legion_tpu.utils import comm as jax_comm
    names = {"all_to_all": "all-to-all", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter", "all_reduce": "all-reduce"}

    def hlo(d):
        return {names[k]: v for k, v in d.items()}

    for m, k, d, cap, payload in [(40, 4, 8, None, False),
                                  (1000, 2, 128, 640, False),
                                  (96, 4, 10, None, True), (7, 1, 3, None,
                                                            False)]:
        assert hlo(comm.exact_exchange_bytes(
            m, k, d, cap=cap, payload=payload)) == (
            jax_comm.exact_exchange_bytes(m, k, d, cap=cap, payload=payload))
        assert hlo(comm.psum_exchange_bytes(m, k, d)) == (
            jax_comm.psum_exchange_bytes(m, k, d))
        counts = {"all_to_all": 1000, "all_gather": 300,
                  "reduce_scatter": 40, "all_reduce": 12_345}
        assert comm.link_bytes(counts, k) == jax_comm.link_bytes(
            hlo(counts), k)


@pytest.mark.parametrize("kind", ["uniform", "skewed", "lopsided"])
@pytest.mark.parametrize("k,cap", [(4, None), (4, 8), (2, 16), (3, None)])
def test_route_by_owner_matches_the_reference(kind, k, cap):
    """The same send buffer, positions, in-cap mask, overflow and routed
    payload as the reference's sort-based grouping."""
    import jax.numpy as jnp

    from legion_tpu.parallel import feature_exchange as jfx
    ids = _ids(kind, 0, k=k)
    cap = cap or fx.owner_cap(M, k)
    pay = np.arange(M, dtype=np.int32) * 3 + 1
    got = fx.route_by_owner(torch.from_numpy(ids), k, cap,
                            payload=torch.from_numpy(pay))
    want = jfx.route_by_owner(jnp.asarray(ids), k, cap,
                              payload=jnp.asarray(pay))
    for name, g, w in zip(("send", "pos", "in_cap", "overflow", "payload"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    no_pay = fx.route_by_owner(torch.from_numpy(ids), k, cap)
    assert len(no_pay) == 4
    assert int(fx.owner_overflow(torch.from_numpy(ids), k, cap)) == int(
        jfx.owner_overflow(jnp.asarray(ids), k, cap))
    np.testing.assert_array_equal(
        fx.owner_counts(torch.from_numpy(ids), k).numpy(),
        np.asarray(jfx.owner_counts(jnp.asarray(ids), k)))


def test_caps_and_stripes_match_the_reference():
    from legion_tpu.parallel import feature_exchange as jfx
    assert fx.OWNER_CAP_SLACK == jfx.OWNER_CAP_SLACK
    assert fx.PROBED_OWNER_SLACK == jfx.PROBED_OWNER_SLACK
    for m in (1, 7, 40, 1000, 491_480):
        for k in (1, 2, 3, 4, 8):
            assert fx.owner_cap(m, k) == jfx.owner_cap(m, k)
            for obs in (0, 5, m // k, m):
                assert fx.probed_owner_cap(obs, m, k) == (
                    jfx.probed_owner_cap(obs, m, k))
                assert fx.probed_cap(obs, m) == jfx.probed_cap(obs, m)
    table = _table()
    for k in (1, 2, 4, 5):
        want = jfx.shard_rows(table, k)
        np.testing.assert_array_equal(fx.shard_rows(table, k), want)
        for j in range(k):
            np.testing.assert_array_equal(fx.stripe_rows(table, k, j),
                                          want[j])


@pytest.mark.parametrize("cap", [None, 8])
def test_demote_overflow_matches_the_reference(small_graph, cap):
    """Over-cap hits become misses: the same hit mask, miss ids, miss
    ranks and counts as the reference's ``demote_overflow``."""
    import jax.numpy as jnp

    from legion_tpu.cache.feature_cache import FeatureCache as JaxCache
    from legion_tpu.cache.striped import StripedFeatureCache as JaxStriped
    k, miss_cap = 4, 24
    # hot set: every id < 300 and the multiples of 4 beyond; the frontier
    # leans on owner 0 (hot rank % 4 == 0)
    hot = np.unique(np.concatenate([np.arange(300), np.arange(300, 2000, 4)]
                                   )).astype(np.int32)
    rng = np.random.default_rng(3)
    frontier = np.concatenate([hot[::4][:50], rng.integers(0, 2000, 30),
                               [-1] * 6]).astype(np.int32)
    rng.shuffle(frontier)
    base = FeatureCache.plan_ids(torch.from_numpy(hot),
                                 torch.from_numpy(frontier), miss_cap)
    got = StripedFeatureCache.demote_overflow(
        base, torch.from_numpy(frontier), miss_cap, k, cap)
    jbase = JaxCache.plan_ids(jnp.asarray(hot), jnp.asarray(frontier),
                              miss_cap)
    want = JaxStriped.demote_overflow(jbase, jnp.asarray(frontier), miss_cap,
                                      k, cap)
    for name in ("hit", "miss_ids", "num_miss", "num_hit", "num_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    miss = np.asarray(want.miss_ids) >= 0
    np.testing.assert_array_equal(
        got.miss_idx.numpy()[np.asarray(~want.hit) & (frontier >= 0)],
        np.asarray(want.miss_idx)[np.asarray(~want.hit) & (frontier >= 0)])
    assert int(base.num_hit) > int(got.num_hit)          # some demoted
    assert miss.sum() == min(int(got.num_miss), miss_cap)


def test_one_rank_exchange_is_the_local_gather(tmp_path):
    """On a group of one rank the exchange serves every request from the
    one stripe (the whole table): the rows ``gather_rows`` gives, no
    overflow, at the probe-free cap."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        m_ = mesh.make_mesh(1)
        assert m_.shape == {"data": 1, "cache": 1}
        assert (m_.data_rank, m_.cache_rank) == (0, 0)
        table = torch.from_numpy(_table())
        ids = torch.from_numpy(_ids("uniform", 0))
        rows, ov = fx.sharded_row_fetch_stats(table, ids, m_.group)
        ps = fx.sharded_row_fetch_psum(table, ids, m_.group)
    finally:
        dist.destroy_process_group()
    want = torch.where((ids >= 0)[:, None], table[ids.clamp(min=0).long()],
                       0.0)
    assert torch.equal(rows, want) and torch.equal(ps, want)
    assert int(ov) == 0


def test_mesh_groups_and_the_share_device_mode(tmp_path):
    """A cache group is ``group_size`` consecutive ranks; the share-device
    mode is asked for by name, is CUDA's only, and runs gloo."""
    m_ = mesh.Mesh(data=2, cache=2, rank=3)
    assert (m_.world, m_.data_rank, m_.cache_rank) == (4, 1, 1)
    assert mesh.backend_for("cuda", share_device=True) == "gloo"
    assert mesh.backend_for("cuda") == "nccl"
    with pytest.raises(ValueError, match="share_device"):
        mesh.backend_for("cpu", share_device=True)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"this process sees {n}"):
        mesh.check_world(n + 2, "cuda")
    if n == 0:
        with pytest.raises(ValueError, match="need 1 CUDA devices"):
            mesh.check_world(2, "cuda", share_device=True)
    with pytest.raises(ValueError, match="not divisible"):
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/i",
                                world_size=1, rank=0)
        try:
            mesh.make_mesh(2)
        finally:
            dist.destroy_process_group()


def test_cache_group_cell_runs_on_the_cpu(tmp_path):
    """``tools/cache_group_cell`` (chip_smoke's ``mesh_striped_k2``) at its
    small size on two gloo ranks: each path's feature matrix and hot draws
    bitwise equal at cache axes 1 and 2, the exchange's bytes the closed
    forms', the same losses at both axes."""
    import json

    from legion_tpu_torch.tools import cache_group_cell
    out = tmp_path / "cell.json"
    cache_group_cell.main([str(out), "--device", "cpu", "--small"])
    res = json.loads(out.read_text())
    assert [r["rank"] for r in res["ranks"]] == [0, 1]
    for r in res["ranks"]:
        assert r["x_equal"] == {"sharded": True, "cached": True,
                                "hybrid": True}
        assert r["hot_draws_equal"]
        for b in r["bytes"].values():
            assert b["counted"] == b["closed_form"]
        assert r["sharded_k1"]["losses"] == r["sharded_k2"]["losses"]
        for p in ("cached", "hybrid"):
            assert [h["losses"] for h in r[f"{p}_k1"]["history"]] == [
                h["losses"] for h in r[f"{p}_k2"]["history"]]
        assert r["sharded_k2"]["stripe_rows"] == 1500
