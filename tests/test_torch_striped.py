"""Striped cached training (``cache/striped.py``'s ``StripedFeatureCache``,
``cache/striped_pipeline.py``, ``train/cached_driver.py`` on a mesh) and
``MeshTrainer`` on ``feature_placement="hbm_sharded"`` over a cache group,
against ``legion_tpu`` and against the port's single-device drivers.

Two spawns of single-threaded gloo ranks, each a module-scoped fixture:

* 4 ranks (data 2 x cache 2). The reference's ``StripedCachedTrainer``
  and ``MeshTrainer`` run in this process on the virtual CPU devices of
  ``tests/conftest.py``; its key schedule gives every rank's uniforms,
  which reach the ranks in a file with its initial weights, its hot set
  and its caps. With dropout 0 the last loss agrees within rtol 1e-5
  (per-step losses within rtol 1e-4 / atol 1e-5 for ``MeshTrainer``),
  the parameters after the epoch within 1e-4, the hit, staging and
  exchange figures and the eval counts exactly. The same ranks build the
  feature matrix of a frontier through caches striped 1, 2 and 4 ways
  (with an owner cap that demotes): bitwise the single-device cache's.
* 2 ranks: ``run_cached_training`` at cache group 2 against cache group
  1 with the same group budget (so the same hot set): bitwise the same
  losses; kill and resume at an epoch end gives exactly the
  uninterrupted run.

On one rank (in this process) ``run_cached_training`` on a mesh is
exactly ``run_cached_training`` without one. The ranks import this
module by name and load no JAX."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from legion_tpu_torch import config as port_config
from legion_tpu_torch.cache.feature_cache import FeatureCache
from legion_tpu_torch.cache.striped import StripedFeatureCache
from legion_tpu_torch.cache.striped_pipeline import StripedCachedTrainer
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.models import build_model
from legion_tpu_torch.parallel import mesh
from legion_tpu_torch.parallel.trainer import MeshTrainer
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import DeviceGraph
from legion_tpu_torch.train.cached_driver import run_cached_training
from legion_tpu_torch.train.train_state import create_train_state
from legion_tpu_torch.utils import comm

torch.set_num_threads(2)

B, EB, FANOUTS, HIDDEN, CAPACITY, STEPS = 32, 64, (4, 3), 16, 700, 4
CAPS = frontier_caps(B, FANOUTS)


def _graph():
    """conftest's ``small_graph``, built here so that the ranks need no
    conftest."""
    return random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=7, seed=1)


def _cached_cfg(cm, epochs=2, dropout=0.0, group=1, budget=1 << 16,
                ck=None, world=0):
    """tests/test_striped.py's configuration."""
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=7, feature_placement="host"),
        sampler=cm.SamplerConfig(fanouts=FANOUTS, batch_size=B,
                                 eval_batch_size=EB, probe_caps=False),
        model=cm.ModelConfig(arch="sage", hidden_dim=HIDDEN, num_layers=2,
                             dropout=dropout),
        train=cm.TrainConfig(learning_rate=0.01, seed=0, pipeline_depth=2,
                             epochs=epochs, checkpoint_dir=ck),
        cache=cm.CacheConfig(enabled=True, budget_bytes=budget,
                             group_size=group, presample_steps=2),
        parallel=cm.ParallelConfig(num_devices=world))


def _mesh_cfg(cm, world):
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=7, feature_pad_align=0,
                                 feature_placement="hbm_sharded"),
        sampler=cm.SamplerConfig(fanouts=FANOUTS, batch_size=B,
                                 eval_batch_size=EB, probe_caps=False),
        model=cm.ModelConfig(arch="sage", hidden_dim=HIDDEN, num_layers=2,
                             dropout=0.0),
        train=cm.TrainConfig(learning_rate=0.01, seed=0, epochs=1),
        cache=cm.CacheConfig(group_size=2),
        parallel=cm.ParallelConfig(num_devices=world))


def _frontier(rank):
    rng = np.random.default_rng(50 + rank)
    f = rng.integers(0, 2000, size=96).astype(np.int32)
    f[-5:] = -1
    return torch.from_numpy(f)


# -- the 4 ranks --------------------------------------------------------------

def _four_rank_checks(device, d):
    rank = dist.get_rank()
    g = _graph()
    ref = np.load(os.path.join(d, "ref.npz"))
    feats = np.asarray(g.features, np.float32)
    out = {}

    # the striped trainer against the reference's, (data 2 x cache 2)
    m2 = mesh.make_mesh(2)
    cfg = _cached_cfg(port_config)
    cache = StripedFeatureCache.build(feats, np.arange(g.num_nodes),
                                      CAPACITY, CAPS[-1], m2, device="cpu")
    model = build_model("sage", feats.shape[1], HIDDEN, 7, 2, 0.0)
    model.load_state_dict(torch.load(os.path.join(d, "init.pt")))
    graph = DeviceGraph.from_host(g.indptr, g.indices, "cpu")
    tr = StripedCachedTrainer(cfg, model, CAPS, graph, cache)
    state = create_train_state(model, 0.01, 0, "cpu")
    cols = slice(rank * B, (rank + 1) * B)
    comm.reset_counts()
    r = tr.run_epoch(state, ref["seeds"][:, cols], ref["labels"][:, cols],
                     uniforms=lambda s, k: torch.from_numpy(
                         ref[f"t{rank}_{s}_{k}"]))
    out["epoch_counts"], out["epoch_calls"] = (comm.read_counts(),
                                               comm.read_calls())
    out["cached"] = {k: v for k, v in r.items() if k != "state"}
    out["cached_params"] = {k: v.clone()
                            for k, v in model.state_dict().items()}
    out["cached_eval"] = tr.eval_epoch(
        model, ref["eval_seeds"][:, cols], ref["eval_counts"][:, rank],
        ref["eval_labels"][:, cols],
        uniforms=lambda t, k: torch.from_numpy(ref[f"e{rank}_{t}_{k}"]))

    # MeshTrainer striping the whole table over cache groups of 2
    mt = MeshTrainer(_mesh_cfg(port_config, 4), g, device, mesh=m2)
    mt.model.load_state_dict(torch.load(os.path.join(d, "mesh_init.pt")))
    rec = mt.train_one_epoch(0, uniforms=lambda s, k: torch.from_numpy(
        ref[f"m{rank}_{s}_{k}"]))
    out["mesh"] = {"losses": rec["losses"], "cap_overflow":
                   rec["cap_overflow"], "stripe_rows": mt.features.shape[0],
                   "params": {k: v.clone()
                              for k, v in mt.model.state_dict().items()}}

    # the feature matrix of one frontier through caches striped 1, 2, 4
    # ways, the owner cap tight enough to demote (8 a owner)
    frontier = _frontier(rank)
    fc = FeatureCache.build(feats, np.arange(g.num_nodes), CAPACITY, 96,
                            device="cpu")
    p = fc.plan(frontier)
    want = fc.combine(p, fc.stage(p.miss_ids.numpy()), frontier)
    xs, demoted = {}, {}
    for k in (1, 2, 4):
        mk = m2 if k == 2 else mesh.make_mesh(k)
        sc = StripedFeatureCache.build(feats, np.arange(g.num_nodes),
                                       CAPACITY, 96, mk, device="cpu",
                                       owner_cap_rows=8)
        plan, dem = sc.plan_demoted(frontier)
        xs[k] = sc.combine(plan, sc.stage(plan.miss_ids.numpy()), frontier)
        demoted[k] = int(dem)
    out["x_equal"] = [torch.equal(xs[k], want) for k in (1, 2, 4)]
    out["demoted"] = demoted
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


def _reference_four(d):
    """The reference's StripedCachedTrainer and MeshTrainer at (data 2 x
    cache 2): their results, and every rank's uniforms of their key
    schedules, with the initial weights, written to ``d``."""
    import jax
    import jax.numpy as jnp

    from legion_tpu import config as jax_config
    from legion_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from legion_tpu.parallel.trainer import MeshTrainer as JaxMeshTrainer
    from legion_tpu.sampling.seeds import epoch_train_seeds, interleave_shards
    from legion_tpu.train.train_state import create_train_state as jax_state
    from legion_tpu_torch.models.convert import params_from_flax
    from tests.test_striped import _epoch_seeds, _mk_trainer
    from tests.test_torch_sampler import jax_uniforms
    g = _graph()
    jm = jax_make_mesh(4, cache_group_size=2)
    _, caps, _, _, _, _, params, jtr = _mk_trainer(g, jm)
    assert tuple(caps) == CAPS
    torch.save(params_from_flax(params), os.path.join(d, "init.pt"))
    seeds, labels = _epoch_seeds(g, 4, B, steps=STEPS)
    state = jax_state(jax.tree_util.tree_map(jnp.copy, params), 0.01, 0)
    u = {"seeds": seeds, "labels": labels}
    key = jax.random.fold_in(state.rng, 0)
    for i in range(STEPS):
        for r in range(4):
            sk = jax.random.fold_in(jax.random.fold_in(key, i), r)
            for k, a in enumerate(jax_uniforms(sk, caps, FANOUTS)):
                u[f"t{r}_{i}_{k}"] = a
    res = jtr.run_epoch(state, seeds, labels)
    # two eval steps of 24 valid seeds a rank
    ids = np.asarray(g.valid_ids)
    es = np.full((2, 4 * B), -1, np.int32)
    ec = np.zeros((2, 4), np.int32)
    for t in range(2):
        for r in range(4):
            chunk = ids[(t * 4 + r) * 24:(t * 4 + r + 1) * 24]
            es[t, r * B: r * B + len(chunk)] = chunk
            ec[t, r] = len(chunk)
            sk = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(4242), t), r)
            for k, a in enumerate(jax_uniforms(sk, caps, FANOUTS)):
                u[f"e{r}_{t}_{k}"] = a
    el = np.where(es >= 0, np.asarray(g.labels)[np.clip(es, 0, None)],
                  -1).astype(np.int32)
    u.update(eval_seeds=es, eval_counts=ec, eval_labels=el)
    acc = jtr.eval_epoch(res["state"].params, es, ec, el)
    out = {"cached": {k: v for k, v in res.items() if k != "state"},
           "cached_params": params_from_flax(res["state"].params),
           "cached_eval": acc}

    # MeshTrainer, feature_placement "hbm_sharded" over cache groups of 2
    mtr = JaxMeshTrainer(_mesh_cfg(jax_config, 4), g)
    assert dict(mtr.mesh.shape) == {"data": 2, "cache": 2}
    assert mtr.sharded_features
    torch.save(params_from_flax(mtr.state.params),
               os.path.join(d, "mesh_init.pt"))
    for s in range(mtr.plan.train_steps):
        base = jax.random.fold_in(mtr.state.rng, s)
        for r in range(4):
            sk, _ = jax.random.split(jax.random.fold_in(base, r))
            for k, a in enumerate(jax_uniforms(sk, mtr.caps, FANOUTS)):
                u[f"m{r}_{s}_{k}"] = a
    np.savez(os.path.join(d, "ref.npz"), **u)
    rng = np.random.default_rng(0 * 100003 + 0)
    s_ep, _ = epoch_train_seeds(rng, mtr.shards_train, mtr.plan)
    lab = np.asarray(g.labels)[s_ep].astype(np.int32)
    mtr.state, losses, (_, overflow) = mtr.jit_epoch(
        mtr.state, mtr.graph, mtr.features,
        jax.device_put(interleave_shards(s_ep), mtr._mat),
        jax.device_put(interleave_shards(lab), mtr._mat))
    out["mesh"] = {"losses": np.asarray(losses).tolist(),
                   "cap_overflow": int(np.asarray(overflow).sum()),
                   "params": params_from_flax(mtr.state.params)}
    return out


@pytest.fixture(scope="module")
def four():
    with tempfile.TemporaryDirectory() as d:
        ref = _reference_four(d)
        mesh.spawn(_four_rank_checks, 4, "cpu", args=(d,), threads=1)
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in range(4)]
    return ref, ranks


# -- the 2 ranks --------------------------------------------------------------

def _two_rank_checks(device, d):
    rank = dist.get_rank()
    g = _graph()
    out = {}
    q = lambda s: None  # noqa: E731
    for k in (1, 2):
        # the same group budget, so the same hot set
        cfg = _cached_cfg(port_config, group=k, budget=(1 << 17) // k)
        comm.reset_counts()
        res = run_cached_training(cfg, g, device, mesh=mesh.make_mesh(k),
                                  log=q)
        out[k] = {"history": [{kk: v for kk, v in h.items()}
                              for h in res["history"]],
                  "test_acc": res["test_acc"], "mesh": res["mesh"],
                  "feat_capacity": res["cost"].feat_capacity,
                  "calls": comm.read_calls()}
    ck = os.path.join(d, "ck")
    m2 = mesh.make_mesh(2)
    kw = dict(dropout=0.3, group=2, budget=1 << 16)
    whole = run_cached_training(_cached_cfg(port_config, **kw), g, device,
                                mesh=m2, log=q)
    first = run_cached_training(_cached_cfg(port_config, epochs=1, ck=ck,
                                            **kw), g, device, mesh=m2,
                                log=q)
    logs = []
    rest = run_cached_training(_cached_cfg(port_config, ck=ck, **kw), g,
                               device, mesh=m2, log=logs.append)
    out["resume"] = {
        "whole": [h["losses"] for h in whole["history"]],
        "first": [h["losses"] for h in first["history"]],
        "rest": [h["losses"] for h in rest["history"]],
        "valid": ([h["valid"] for h in whole["history"]],
                  [h["valid"] for h in rest["history"]]),
        "test": (whole["test_acc"], rest["test_acc"]), "logs": logs,
        "files": sorted(os.listdir(ck))}
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def two():
    with tempfile.TemporaryDirectory() as d:
        mesh.spawn(_two_rank_checks, 2, "cpu", args=(d,), threads=1)
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]


# -- the checks ---------------------------------------------------------------

def test_striped_trainer_matches_the_reference(four):
    ref, ranks = four
    want = ref["cached"]
    for r in ranks:
        got = r["cached"]
        assert got["steps"] == STEPS
        np.testing.assert_allclose(got["loss"], float(want["loss"]),
                                   rtol=1e-5)
        for key in ("cache_hit_rate", "staging_overflow",
                    "exchange_overflow", "edges"):
            assert got[key] == want[key], key
        assert 0.0 < got["cache_hit_rate"] < 1.0
        for k, w in ref["cached_params"].items():
            np.testing.assert_allclose(r["cached_params"][k].numpy(),
                                       w.numpy(), rtol=0, atol=1e-4,
                                       err_msg=k)
        assert r["cached_eval"] == ref["cached_eval"]
    assert all(r["cached"]["losses"] == ranks[0]["cached"]["losses"]
               for r in ranks)


def test_striped_epoch_collectives(four):
    """A step: the exchange's two all-to-alls (the closed form's bytes at
    the probe-free owner cap) and the gradient all-reduce; the epoch one
    more all-reduce, of the losses and figures."""
    _, ranks = four
    m, d = CAPS[-1], 32
    for r in ranks:
        calls, counts = r["epoch_calls"], r["epoch_counts"]
        assert calls == {"all_to_all": 2 * STEPS, "all_reduce": STEPS + 1}
        assert counts["all_to_all"] == STEPS * comm.exact_exchange_bytes(
            m, 2, d)["all_to_all"]


def test_hbm_sharded_mesh_trainer_matches_the_reference(four):
    """``MeshTrainer`` on (data 2 x cache 2), each rank holding its
    stripe of the table and fetching the frontier's rows over its group:
    the reference's losses and parameters."""
    ref, ranks = four
    want = ref["mesh"]
    for r in ranks:
        got = r["mesh"]
        assert got["stripe_rows"] == 1000          # ceil(2000 / 2)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                                   atol=1e-5)
        assert got["cap_overflow"] == want["cap_overflow"]
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(),
                                       rtol=0, atol=1e-4, err_msg=k)


def test_feature_matrix_is_the_same_at_every_group_size(four):
    """Striped 1, 2 or 4 ways, with hits demoted past a tight owner cap,
    the frontier's rows are bitwise the single-device cache's."""
    _, ranks = four
    for r in ranks:
        assert r["x_equal"] == [True, True, True]
        assert r["demoted"][1] == 0
        assert r["demoted"][2] > 0 and r["demoted"][4] > 0


def test_group_size_leaves_the_training_unchanged(two):
    """Cache group 2 against 1 at the same group budget: the same hot set
    and bitwise the same losses, validation and test figures; each step
    of the striped run made its two all-to-alls."""
    for r in two:
        a, b = r[1], r[2]
        assert (a["mesh"], b["mesh"]) == ({"data": 2, "cache": 1},
                                          {"data": 1, "cache": 2})
        assert a["feat_capacity"] == b["feat_capacity"]
        assert [h["losses"] for h in a["history"]] == [
            h["losses"] for h in b["history"]]
        assert [h["valid"] for h in a["history"]] == [
            h["valid"] for h in b["history"]]
        assert a["test_acc"] == b["test_acc"]
        for ha, hb in zip(a["history"], b["history"]):
            assert ha["exchange_overflow"] == 0
            assert hb["owner_cap"] is not None and ha["owner_cap"] is None
            assert ha["staging_overflow"] == hb["staging_overflow"] == 0
            # demoted hits are staged: a lower hit rate, the same rows
            assert 0.0 < hb["cache_hit_rate"] <= ha["cache_hit_rate"] < 1.0
            if hb["exchange_overflow"] == 0:
                assert hb["cache_hit_rate"] == ha["cache_hit_rate"]
        assert b["calls"]["all_to_all"] > 0
        assert "all_to_all" in a["calls"]      # a group of one rank too
    assert two[0][2]["history"][0]["losses"] == two[1][2]["history"][0][
        "losses"]


def test_kill_and_resume_at_two_ranks(two):
    """Killed after epoch 0, resumed by a fresh driver on every rank: the
    uninterrupted run's next epoch exactly (dropout 0.3: every rank's
    generator comes back from rank 0's file)."""
    for r in two:
        res = r["resume"]
        assert res["first"] == res["whole"][:1]
        assert res["rest"] == res["whole"][1:]
        assert res["valid"][1] == res["valid"][0][1:]
        assert res["test"][0] == res["test"][1]
        assert len(res["files"]) == 2
    assert any("resumed from checkpoint" in s
               for s in two[0]["resume"]["logs"])
    assert not two[1]["resume"]["logs"]                 # rank 0 logs


@pytest.mark.parametrize("arch", ["sage", "lp_sage"])
def test_one_rank_is_the_cached_driver(tmp_path, arch):
    """On one gloo rank ``run_cached_training`` on a mesh is
    ``run_cached_training`` without one exactly: losses, hit rate, host
    bytes, validation and test (dropout 0.3, two epochs)."""
    cfg = _cached_cfg(port_config, dropout=0.3, budget=1 << 16)
    if arch == "lp_sage":
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, arch="lp_sage"),
            sampler=dataclasses.replace(cfg.sampler, batch_size=48,
                                        eval_batch_size=48))
    g = _graph()
    want = run_cached_training(cfg, g, "cpu", log=lambda s: None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        got = run_cached_training(cfg, g, "cpu", mesh=mesh.make_mesh(1),
                                  log=lambda s: None)
    finally:
        dist.destroy_process_group()
    assert got["mesh"] == {"data": 1, "cache": 1}
    for a, b in zip(got["history"], want["history"]):
        for key in ("losses", "cache_hit_rate", "host_gb",
                    "staging_overflow", "valid", "miss_cap", "caps"):
            assert a[key] == b[key], key
        assert a["exchange_overflow"] == 0 and a["owner_cap"] is None
    assert got["test_acc"] == want["test_acc"]
    assert all(torch.equal(p, q) for p, q in zip(
        got["state"].model.parameters(), want["state"].model.parameters()))


def test_the_driver_refuses_what_it_does_not_run():
    cfg = _cached_cfg(port_config)
    one = mesh.Mesh(data=1, cache=1, rank=0)
    with pytest.raises(ValueError, match="CacheConfig"):
        run_cached_training(dataclasses.replace(
            cfg, cache=port_config.CacheConfig(enabled=False)), _graph(),
            "cpu", mesh=one)
    with pytest.raises(ValueError, match="run_hybrid_training"):
        run_cached_training(dataclasses.replace(
            cfg, dataset=dataclasses.replace(cfg.dataset,
                                             topology_placement="host")),
            _graph(), "cpu", mesh=one)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_rank_eval_is_the_reference_drivers_plan(n):
    """Each rank's eval seeds, counts and labels are its columns of the
    reference striped driver's interleaved eval plan (short shards padded
    with -1); on one rank, the plan the drivers without a mesh use."""
    from legion_tpu.sampling.seeds import (epoch_eval_seeds,
                                           interleave_shards, shard_node_set)
    from legion_tpu_torch.sampling.seeds import shard_node_set as port_shard
    from legion_tpu_torch.train.cached_driver import rank_eval
    g = _graph()
    ids = np.asarray(g.valid_ids)[:-3]
    labels = np.asarray(g.labels)
    b, eb = 48, 40
    eshards = shard_node_set(ids, n)
    mx = max(max(len(s) for s in eshards), 1)
    steps = (mx - 1) // min(eb, b) + 1
    per = tuple((len(s) - 1) // steps + 1 if len(s) else 0 for s in eshards)
    seeds_e, counts_e = epoch_eval_seeds(eshards, steps, per, b)
    want = interleave_shards(seeds_e)
    for r in range(n):
        s, c, lab = rank_eval(port_shard(ids, n), b, eb, r, labels)
        np.testing.assert_array_equal(s, want[:, r * b:(r + 1) * b])
        np.testing.assert_array_equal(c, counts_e[r])
        np.testing.assert_array_equal(
            lab, np.where(s >= 0, labels[np.clip(s, 0, None)], -1))


# -- the driver at 4 ranks against the reference's ----------------------------

def _driver_rank(device, d):
    """``run_cached_training`` at (data 2 x cache 2) with the reference's
    presample result, initial weights and every batch's uniforms."""
    from legion_tpu_torch.cache import feature_cache, striped_pipeline
    from legion_tpu_torch.cache.hotness import HotnessResult
    from legion_tpu_torch.train import cached_driver
    rank = dist.get_rank()
    ref = np.load(os.path.join(d, "driver.npz"))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    cached_driver.presample_hotness = lambda *a, **k: HotnessResult(
        t(ref["node_hot"]), t(ref["edge_hot"]), t(ref["max_frontier"]),
        t(ref["max_per_hop"]))
    build = cached_driver.build_model

    def build_from_ref(*a, **k):
        m = build(*a, **k)
        m.load_state_dict(torch.load(os.path.join(d, "driver_init.pt")))
        return m
    cached_driver.build_model = build_from_ref
    sample, probe = feature_cache.sample_batch, iter(range(2))

    def sample_probe(*a, generator, **k):
        i = next(probe)
        return sample(*a, uniforms=[t(ref[f"p{i}_{h}"]) for h in range(2)],
                      **k)
    feature_cache.sample_batch = sample_probe
    cls = striped_pipeline.StripedCachedTrainer
    run_epoch, eval_epoch = cls.run_epoch, cls.eval_epoch

    def run_keyed(self, state, s, lab, uniforms=None):
        e = state.epoch
        return run_epoch(self, state, s, lab, uniforms=lambda i, h: t(
            ref[f"t{e}_{rank}_{i}_{h}"]))

    def eval_keyed(self, model, s, c, lab, generator=None, uniforms=None):
        return eval_epoch(self, model, s, c, lab, uniforms=lambda i, h: t(
            ref[f"e{rank}_{i}_{h}"]))
    cls.run_epoch, cls.eval_epoch = run_keyed, eval_keyed
    res = run_cached_training(_cached_cfg(port_config, group=2, world=4),
                              _graph(), device, mesh=mesh.make_mesh(2),
                              log=lambda s: None)
    torch.save({"history": [{k: v for k, v in h.items()}
                            for h in res["history"]],
                "test_acc": res["test_acc"], "mesh": res["mesh"]},
               os.path.join(d, f"driver{rank}.pt"))


def _reference_driver(d):
    """The reference's ``run_striped_training`` on 4 virtual devices
    (cache group 2), spied on for its presample result and initial
    weights; every batch's uniforms of its key schedule, written to
    ``d``."""
    import jax

    from legion_tpu import config as jax_config
    from legion_tpu.train import striped_driver as jsd
    from legion_tpu_torch.models.convert import params_from_flax
    from tests.test_torch_sampler import jax_uniforms
    seen = {}
    presample, state0, caps0 = (jsd.presample_hotness, jsd.create_train_state,
                                jsd.observed_caps)

    def spy_presample(*a, **k):
        seen["hot"] = presample(*a, **k)
        return seen["hot"]

    def spy_state(params, *a, **k):
        # a copy: the epochs donate the state's buffers
        seen["params"] = jax.tree_util.tree_map(np.array, params)
        return state0(params, *a, **k)

    def spy_caps(*a, **k):
        seen["caps"] = caps0(*a, **k)
        return seen["caps"]
    jsd.presample_hotness, jsd.create_train_state, jsd.observed_caps = (
        spy_presample, spy_state, spy_caps)
    try:
        res = jsd.run_striped_training(
            _cached_cfg(jax_config, group=2, world=4), _graph(),
            log=lambda s: None)
    finally:
        jsd.presample_hotness, jsd.create_train_state, jsd.observed_caps = (
            presample, state0, caps0)
    assert res["mesh"] == {"data": 2, "cache": 2}
    caps, hot = seen["caps"], seen["hot"]
    u = {k: np.asarray(getattr(hot, k)) for k in (
        "node_hot", "edge_hot", "max_frontier", "max_per_hop")}
    for i in range(2):
        for h, a in enumerate(jax_uniforms(jax.random.PRNGKey(9000 + i),
                                           caps, FANOUTS)):
            u[f"p{i}_{h}"] = a
    steps = res["history"][0]["steps"]
    for e in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(0), e)
        for i in range(steps):
            for r in range(4):
                sk = jax.random.fold_in(jax.random.fold_in(key, i), r)
                for h, a in enumerate(jax_uniforms(sk, caps, FANOUTS)):
                    u[f"t{e}_{r}_{i}_{h}"] = a
    for i in range(16):
        for r in range(4):
            sk = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(4242), i), r)
            for h, a in enumerate(jax_uniforms(sk, caps, FANOUTS)):
                u[f"e{r}_{i}_{h}"] = a
    np.savez(os.path.join(d, "driver.npz"), **u)
    torch.save(params_from_flax(seen["params"]),
               os.path.join(d, "driver_init.pt"))
    return res


def test_striped_driver_matches_the_reference_at_four_ranks():
    """``run_cached_training`` at (data 2 x cache 2) from the reference
    striped driver's presample result, weights and batch uniforms (dropout 0):
    each epoch's loss within rtol 1e-5, the same hit rate, staging and
    exchange overflow and sampled edges, validation and test accuracy
    exactly, on every rank."""
    with tempfile.TemporaryDirectory() as d:
        ref = _reference_driver(d)
        mesh.spawn(_driver_rank, 4, "cpu", args=(d,), threads=1)
        ranks = [torch.load(os.path.join(d, f"driver{r}.pt"),
                            weights_only=False) for r in range(4)]
    for got in ranks:
        assert got["mesh"] == {"data": 2, "cache": 2}
        assert len(got["history"]) == len(ref["history"]) == 2
        for a, b in zip(got["history"], ref["history"]):
            assert a["steps"] == b["steps"]
            np.testing.assert_allclose(a["loss"], float(b["loss"]),
                                       rtol=1e-5)
            for key in ("cache_hit_rate", "staging_overflow",
                        "exchange_overflow", "edges"):
                assert a[key] == b[key], key
            assert a["valid"] == b["valid"]
        assert got["test_acc"] == ref["test_acc"]
    assert 0.0 < ranks[0]["history"][0]["cache_hit_rate"] < 1.0
