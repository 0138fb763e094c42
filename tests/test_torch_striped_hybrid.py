"""Striped hybrid training (``cache/striped.py``'s ``StripedTopoCache``,
``cache/striped_hybrid.py``, ``train/hybrid_driver.py`` on a mesh) and the
host frontier probe (``cache/hotness.py``), against ``legion_tpu`` and
against the port's single-device hybrid driver.

One spawn of 4 single-threaded gloo ranks (a module-scoped fixture) builds
the hot sub-CSR striped 1, 2 and 4 ways and draws one hop of every rank's
frontier through ``sample_hot``: against the reference's ``sample_hot``
under ``shard_map`` on the virtual CPU devices of ``tests/conftest.py``,
given the uniform grid its key draws, the draws and the hit masks are
bitwise equal; with each rank's grid rows fixed (one (M, f) array per
rank), the draws are bitwise the same at every group size and equal to
the single-device ``TopoCache.sample_hot`` on those rows. Each rank's
stripe is the reference's stripe. One spawn of 2 ranks runs
``run_hybrid_training`` at cache group 2 against group 1 with the
same group budget: the same losses within 1e-5 relative (bitwise unless a
hot request is demoted), and kill and resume at an epoch end exactly. On
one rank (in this process) the driver on a mesh is the driver without one
exactly.
The ranks import this module by name and load no JAX."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from legion_tpu_torch import config as port_config
from legion_tpu_torch.cache.hotness import host_frontier_probe
from legion_tpu_torch.cache.striped import StripedTopoCache
from legion_tpu_torch.cache.topo_cache import TopoCache
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.parallel import mesh
from legion_tpu_torch.train.hybrid_driver import (_probe_owner_caps,
                                                  run_hybrid_training)
from legion_tpu_torch.utils import comm

torch.set_num_threads(2)

M, FANOUT, TOPO_CAP = 64, 5, 600


def _graph():
    return random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=7, seed=1)


def _csr(g):
    return (np.ascontiguousarray(np.asarray(g.indptr), np.int64),
            np.ascontiguousarray(np.asarray(g.indices), np.int32))


def _order(indptr):
    """tests/test_striped_topo.py's hot order: densest first."""
    return np.argsort(-np.diff(indptr), kind="stable").astype(np.int32)


def _frontier(rank):
    rng = np.random.default_rng(70 + rank)
    f = rng.integers(0, 2000, size=M).astype(np.int32)
    f[-4:] = -1
    return f


def _rows(rank):
    """Rank ``rank``'s own (M, f) rows of the uniform grid."""
    return np.random.default_rng(90 + rank).random(
        (M, FANOUT), dtype=np.float32)


def _cfg(cm, epochs=2, dropout=0.0, group=1, budget=96 << 10, ck=None):
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=7, topology_placement="host",
                                 feature_placement="host"),
        sampler=cm.SamplerConfig(fanouts=(4, 3), batch_size=32,
                                 eval_batch_size=32, probe_caps=False),
        model=cm.ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                             dropout=dropout),
        train=cm.TrainConfig(learning_rate=0.01, seed=0, epochs=epochs,
                             checkpoint_dir=ck),
        cache=cm.CacheConfig(enabled=True, budget_bytes=budget,
                             group_size=group, presample_steps=2))


# -- the 4 ranks --------------------------------------------------------------

def _topo_rank_checks(device, d):
    rank = dist.get_rank()
    indptr, indices = _csr(_graph())
    ref = np.load(os.path.join(d, "ref.npz"))
    frontier = torch.from_numpy(_frontier(rank))
    out = {}
    for k in (1, 2, 4):
        m_ = mesh.make_mesh(k)
        topo = StripedTopoCache.build(indptr, indices, _order(indptr),
                                      TOPO_CAP, m_, "cpu")
        group = range(m_.data_rank * k, (m_.data_rank + 1) * k)
        comm.reset_counts()
        # the reference's grid, drawn from its key
        nb, hit = topo.sample_hot(frontier, torch.from_numpy(ref[f"u{k}"]))
        counts = comm.read_counts()
        # the grid of each rank's own rows
        own = torch.from_numpy(np.concatenate([_rows(c) for c in group]))
        nb_own, hit_own = topo.sample_hot(frontier, own)
        out[k] = {"ref_grid": (nb, hit), "own_grid": (nb_own, hit_own),
                  "stripe": (topo.sub_indptr.clone(),
                             topo.sub_indices.clone()),
                  "hot_ids": topo.hot_ids.clone(), "counts": counts}
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


def _reference_topo(d):
    """The reference's striped draws of every rank's frontier at cache
    groups of 1, 2 and 4 (data 4, 2, 1), its grids and stripes."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from legion_tpu.cache.striped import StripedTopoCache as JaxTopo
    from legion_tpu.parallel.feature_exchange import owner_cap
    from legion_tpu.parallel.mesh import make_mesh as jax_make_mesh
    indptr, indices = _csr(_graph())
    key = jax.random.PRNGKey(11)
    frontiers = np.stack([_frontier(r) for r in range(4)])
    grids, res = {}, {}
    for k in (1, 2, 4):
        jm = jax_make_mesh(4, cache_group_size=k)
        topo = JaxTopo.build(indptr, indices, _order(indptr), TOPO_CAP, jm)

        def f(hot, sp, si, key, fr):
            nb, hit = JaxTopo.sample_hot(hot, sp, si, key, fr[0], FANOUT)
            return nb[None], hit[None]

        ax = P(("data", "cache"))
        nb, hit = jax.jit(jax.shard_map(
            f, mesh=jm, in_specs=(P(), P("cache"), P("cache"), P(), ax),
            out_specs=(ax, ax)))(
            topo.hot_ids, topo.sub_indptr, topo.sub_indices,
            jax.device_put(key, NamedSharding(jm, P())),
            jax.device_put(frontiers, NamedSharding(jm, ax)))
        grids[f"u{k}"] = np.asarray(jax.random.uniform(
            key, (k * M, FANOUT), dtype=np.float32))
        res[k] = {"nb": np.asarray(nb), "hit": np.asarray(hit),
                  "sp": np.asarray(topo.sub_indptr),
                  "si": np.asarray(topo.sub_indices),
                  "hot_ids": np.asarray(topo.hot_ids),
                  "cap": owner_cap(M, k)}
    np.savez(os.path.join(d, "ref.npz"), **grids)
    return res


@pytest.fixture(scope="module")
def topo_run():
    with tempfile.TemporaryDirectory() as d:
        ref = _reference_topo(d)
        mesh.spawn(_topo_rank_checks, 4, "cpu", args=(d,), threads=1)
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in range(4)]
    return ref, ranks


# -- the 2 ranks --------------------------------------------------------------

def _driver_rank_checks(device, d):
    rank = dist.get_rank()
    g = _graph()
    out = {}
    q = lambda s: None  # noqa: E731
    for k in (1, 2):
        # the same group budget, so the same hot sets
        cfg = _cfg(port_config, group=k, budget=(192 << 10) // k)
        res = run_hybrid_training(cfg, g, device, mesh=mesh.make_mesh(k),
                                  log=q)
        out[k] = {"history": res["history"], "test_acc": res["test_acc"],
                  "mesh": res["mesh"], "alpha": res["cost"].alpha,
                  "topo_capacity": res["cost"].topo_capacity}
    ck = os.path.join(d, "ck")
    m2 = mesh.make_mesh(2)
    kw = dict(dropout=0.3, group=2)
    whole = run_hybrid_training(_cfg(port_config, **kw), g, device,
                                mesh=m2, log=q)
    first = run_hybrid_training(
        _cfg(port_config, epochs=1, ck=ck, **kw), g, device, mesh=m2, log=q)
    rest = run_hybrid_training(_cfg(port_config, ck=ck, **kw), g,
                               device, mesh=m2, log=q)
    out["resume"] = {
        "whole": [h["losses"] for h in whole["history"]],
        "first": [h["losses"] for h in first["history"]],
        "rest": [h["losses"] for h in rest["history"]],
        "test": (whole["test_acc"], rest["test_acc"])}
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def two():
    with tempfile.TemporaryDirectory() as d:
        mesh.spawn(_driver_rank_checks, 2, "cpu", args=(d,), threads=1)
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]


# -- the checks ---------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_stripes_are_the_references(topo_run, k):
    """Rank r of a group holds the reference's stripe r % k: its
    sub-indptr (padded rows of degree 0) and its edges."""
    ref, ranks = topo_run
    want = ref[k]
    for r, got in enumerate(ranks):
        sp, si = got[k]["stripe"]
        j = r % k
        np.testing.assert_array_equal(sp.numpy(), want["sp"][j])
        n_edges = int(want["sp"][j][-1])
        np.testing.assert_array_equal(si.numpy()[:n_edges],
                                      want["si"][j][:n_edges])
        np.testing.assert_array_equal(got[k]["hot_ids"].numpy(),
                                      want["hot_ids"])


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sample_hot_matches_the_reference(topo_run, k):
    """Given the grid the reference's key draws, bitwise its draws and hit
    masks; the exchange's bytes are the closed form's with the grid index
    riding along."""
    ref, ranks = topo_run
    for r, got in enumerate(ranks):
        nb, hit = got[k]["ref_grid"]
        np.testing.assert_array_equal(nb.numpy(), ref[k]["nb"][r])
        np.testing.assert_array_equal(hit.numpy(), ref[k]["hit"][r])
        assert got[k]["counts"] == comm.exact_exchange_bytes(
            M, k, FANOUT, payload=True)
    assert any(bool(got[k]["ref_grid"][1].any()) for got in ranks)


def test_sample_hot_is_the_same_at_every_group_size(topo_run):
    """With each rank's grid rows its own, the draws do not depend on the
    group size: bitwise the single-device ``TopoCache.sample_hot`` on the
    same rows, at groups of 1, 2 and 4."""
    _, ranks = topo_run
    indptr, indices = _csr(_graph())
    tc = TopoCache.build(indptr, indices, _order(indptr), TOPO_CAP, "cpu")
    for r, got in enumerate(ranks):
        want_nb, want_hit = tc.sample_hot(torch.from_numpy(_frontier(r)),
                                          torch.from_numpy(_rows(r)))
        for k in (1, 2, 4):
            nb, hit = got[k]["own_grid"]
            assert torch.equal(hit, want_hit), k
            assert torch.equal(nb, want_nb), k


def test_host_frontier_probe_and_owner_caps_match_the_reference():
    """The host probe visits the reference's frontiers (the runtimes are
    bit-equal), so the probed owner caps are the reference's."""
    from legion_tpu.cache.hotness import host_frontier_probe as jax_probe
    from legion_tpu.train.striped_hybrid_driver import (
        _probe_owner_caps as jax_owner_caps)
    g = _graph()
    indptr, indices = _csr(g)
    seeds = [np.asarray(g.train_ids[i * 32:(i + 1) * 32], np.int32)
             for i in range(2)]
    seeds[1][-3:] = -1
    caps = (32, 90, 200)
    got, want = [], []
    host_frontier_probe(indptr, indices, seeds, (4, 3), caps,
                        lambda h, f: got.append((h, f.copy())),
                        np.random.default_rng(5), seed_base=77)
    jax_probe(indptr, indices, seeds, (4, 3), caps,
              lambda h, f: want.append((h, f.copy())),
              np.random.default_rng(5), seed_base=77)
    assert len(got) == len(want) == 6
    for (hg, fg), (hw, fw) in zip(got, want):
        assert hg == hw
        np.testing.assert_array_equal(fg, fw)
    assert [len(f) for h, f in got if h == 2] == [200, 200]    # cut
    order = _order(indptr)
    for kg in (2, 4):
        hot_t = np.sort(order[:300].astype(np.int64))
        hot_f = np.sort(order[:900].astype(np.int64))
        assert _probe_owner_caps(indptr, indices, seeds, (4, 3), caps,
                                 hot_t, hot_f, kg, seed=0) == (
            jax_owner_caps(indptr, indices, seeds, (4, 3), caps, hot_t,
                           hot_f, kg, seed=0))


def test_group_size_leaves_the_training_unchanged(two):
    """Cache group 2 against 1 at the same group budget: the same cost
    model, hot fraction and fetches, and losses within 1e-5 relative."""
    for r in two:
        a, b = r[1], r[2]
        assert (a["mesh"], b["mesh"]) == ({"data": 2, "cache": 1},
                                          {"data": 1, "cache": 2})
        assert (a["alpha"], a["topo_capacity"]) == (b["alpha"],
                                                    b["topo_capacity"])
        assert 0 < a["topo_capacity"]
        for ha, hb in zip(a["history"], b["history"]):
            np.testing.assert_allclose(hb["losses"], ha["losses"],
                                       rtol=1e-5)
            assert hb["topo_hot_fraction"] == ha["topo_hot_fraction"]
            assert 0.0 < hb["topo_hot_fraction"] < 1.0
            assert hb["fetches"] == ha["fetches"] == 2 * hb["steps"] + 1
            assert ha["exchange_overflow"] == 0
            assert hb["feat_hit_rate"] <= ha["feat_hit_rate"]
            assert hb["topo_owner_caps"] is not None
            assert ha["topo_owner_caps"] is None
        assert [h["valid"] for h in a["history"]] == [
            h["valid"] for h in b["history"]]


def test_kill_and_resume_at_two_ranks(two):
    for r in two:
        res = r["resume"]
        assert res["first"] == res["whole"][:1]
        assert res["rest"] == res["whole"][1:]
        assert res["test"][0] == res["test"][1]


def test_one_rank_is_the_hybrid_driver(tmp_path):
    """On one gloo rank ``run_hybrid_training`` on a mesh is
    ``run_hybrid_training`` without one exactly (dropout 0.3, two
    epochs): losses, hot fraction, hit rate, host bytes, fetches,
    validation and test."""
    cfg = _cfg(port_config, dropout=0.3)
    g = _graph()
    want = run_hybrid_training(cfg, g, "cpu", log=lambda s: None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        got = run_hybrid_training(cfg, g, "cpu", mesh=mesh.make_mesh(1),
                                  log=lambda s: None)
    finally:
        dist.destroy_process_group()
    assert got["mesh"] == {"data": 1, "cache": 1}
    for a, b in zip(got["history"], want["history"]):
        for key in ("losses", "feat_hit_rate", "topo_hot_fraction",
                    "host_feat_gb", "host_topo_gb", "host_topo_copied_gb",
                    "fetches", "staging_overflow", "cap_overflow", "valid",
                    "miss_cap", "caps"):
            assert a[key] == b[key], key
        assert a["exchange_overflow"] == 0
    assert got["test_acc"] == want["test_acc"]
    assert 0.0 < got["history"][0]["topo_hot_fraction"] < 1.0
