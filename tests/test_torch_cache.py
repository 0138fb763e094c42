"""Port parity: the cached host-feature path (``legion_tpu_torch.cache``
and ``train.cached_driver``) against ``legion_tpu``'s on the CPU.

* ``presample_hotness``: the same seeds and the per-step uniforms rebuilt
  from the JAX key chain give exactly the same histograms and maxima.
* ``solve_cost_model``: the numpy copy gives the same plan.
* ``FeatureCache``: the same frontier, hot set and staged rows give the
  same plan (miss overflow included) and bitwise the same merged rows.
* ``train_from`` / ``eval_from``: one step from the same flax params,
  batch, plan and staged rows in float32 with dropout 0 — loss at 1e-5,
  params after Adam at 1e-4 absolute (Adam's first step divides by |g| +
  eps, as in tests/test_torch_train.py), eval counts exactly.
* ``run_cached_training`` end to end on a small graph, returning the JAX
  driver's keys."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from legion_tpu import config as jax_config
from legion_tpu.cache.cost_model import solve_cost_model as jax_solve
from legion_tpu.cache.feature_cache import FeatureCache as JaxFeatureCache
from legion_tpu.cache.feature_cache import cache_dtype_for as jax_cache_dtype
from legion_tpu.cache.hotness import presample_hotness as jax_presample
from legion_tpu.cache.pipeline import make_cache_step_fns as jax_step_fns
from legion_tpu.models import build_model as jax_build_model
from legion_tpu.sampling.sampler import DeviceGraph as JaxDeviceGraph
from legion_tpu.sampling.sampler import gather_features as jax_gather
from legion_tpu.sampling.sampler import sample_batch as jax_sample_batch
from legion_tpu.train.cached_driver import (
    run_cached_training as jax_run_cached_training)
from legion_tpu.train.train_state import create_train_state as jax_state
from legion_tpu_torch import config as port_config
from legion_tpu_torch.cache.cost_model import solve_cost_model
from legion_tpu_torch.cache.feature_cache import (CachePlan, FeatureCache,
                                                  cache_dtype_for)
from legion_tpu_torch.cache.hotness import observed_caps, presample_hotness
from legion_tpu_torch.cache.pipeline import CachedTrainer, make_cache_step_fns
from legion_tpu_torch.models import build_model
from legion_tpu_torch.models.convert import params_from_flax
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import DeviceGraph
from legion_tpu_torch.train.cached_driver import run_cached_training
from legion_tpu_torch.train.train_state import create_train_state
from tests.test_torch_sampler import to_torch_batch, torch_uniforms

torch.set_num_threads(2)

B, FANOUTS, HIDDEN = 64, (4, 3), 16
CAPS = frontier_caps(B, FANOUTS)


def _cfg(cm, num_classes, **kw):
    """The cached path's configuration from either package's config."""
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=num_classes,
                                 feature_placement="host"),
        sampler=cm.SamplerConfig(fanouts=FANOUTS, batch_size=B,
                                 dedup_last=True, probe_caps=False),
        model=cm.ModelConfig(arch="sage", hidden_dim=kw.pop("hidden", 32),
                             num_layers=2, dropout=kw.pop("dropout", 0.0)),
        train=cm.TrainConfig(epochs=kw.pop("epochs", 2), learning_rate=0.01),
        cache=cm.CacheConfig(enabled=True, **kw))


def _jax_batch(g, key=0, n_valid=B):
    seeds = np.full(B, -1, np.int32)
    seeds[:n_valid] = g.train_ids[:n_valid]
    labels = np.where(seeds >= 0, np.asarray(g.labels)[np.clip(seeds, 0,
                                                              None)], -1)
    return jax_sample_batch(
        jax.random.PRNGKey(key), JaxDeviceGraph.from_host(g.indptr,
                                                          g.indices),
        jnp.asarray(seeds), jnp.int32(n_valid),
        jnp.asarray(labels.astype(np.int32)), FANOUTS, CAPS)


def _hot_order(n, seed=0):
    return np.random.default_rng(seed).permutation(n).astype(np.int32)


def _torch_plan(jplan) -> CachePlan:
    return CachePlan(*(torch.from_numpy(np.array(x)) for x in jplan))


# -- presampling and the cost model -------------------------------------------

def _presample_both(g, steps=3, key=5):
    seeds = np.stack([g.train_ids[i * B:(i + 1) * B]
                      for i in range(steps)]).astype(np.int32)
    seeds[-1, 50:] = -1
    num_seeds = np.array([B] * (steps - 1) + [50], np.int32)
    k = jax.random.PRNGKey(key)
    want = jax_presample(k, JaxDeviceGraph.from_host(g.indptr, g.indices),
                         jnp.asarray(seeds), jnp.asarray(num_seeds), FANOUTS,
                         CAPS, g.num_nodes)
    uniforms = [torch_uniforms(sk, CAPS, FANOUTS)
                for sk in jax.random.split(k, steps)]
    got = presample_hotness(
        DeviceGraph.from_host(g.indptr, g.indices, "cpu"),
        torch.from_numpy(seeds), torch.from_numpy(num_seeds), FANOUTS, CAPS,
        g.num_nodes, uniforms=uniforms)
    return got, want


def test_presample_hotness_matches_jax(small_graph):
    got, want = _presample_both(small_graph)
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got.node_hot.sum()) > 0 and int(got.edge_hot.sum()) > 0
    assert (observed_caps(got.max_per_hop)
            == observed_caps(np.asarray(want.max_per_hop)))


def test_presample_hotness_from_a_generator(small_graph):
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices, "cpu")
    seeds = torch.from_numpy(small_graph.train_ids[:2 * B].reshape(2, B)
                             .astype(np.int32))
    nb = torch.full((2,), B, dtype=torch.int32)
    runs = [presample_hotness(g, seeds, nb, FANOUTS, CAPS,
                              small_graph.num_nodes,
                              generator=torch.Generator().manual_seed(0))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    r = runs[0]
    # every presampled frontier node was counted once per step it was in
    assert int(r.node_hot.sum()) <= 2 * int(r.max_frontier)
    assert int(r.max_per_hop[0]) == B
    assert int(r.max_frontier) == int(r.max_per_hop[-1])


@pytest.mark.parametrize("kw", [
    dict(budget_bytes=20_000, feat_row_bytes=128, topo_cacheable=False),
    dict(budget_bytes=50_000, feat_row_bytes=64),
    dict(budget_bytes=50_000, feat_row_bytes=64, granularity=0.1,
         feat_cacheable=False),
    dict(budget_bytes=10 ** 9, feat_row_bytes=128),
    dict(budget_bytes=20_000, feat_row_bytes=64, group_size=2),
    dict(budget_bytes=20_000, feat_row_bytes=64, group_size=2,
         granularity=0.05, topo_cacheable=False),
    dict(budget_bytes=5_000, feat_row_bytes=64, feat_cacheable=False,
         topo_cacheable=False)])
def test_solve_cost_model_matches_jax(small_graph, kw):
    got, _ = _presample_both(small_graph)
    args = (got.node_hot.numpy(), got.edge_hot.numpy(),
            np.diff(small_graph.indptr))
    a, b = solve_cost_model(*args, **kw), jax_solve(*args, **kw)
    for f in dataclasses.fields(b):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      err_msg=f.name)


# -- the feature cache --------------------------------------------------------

@pytest.mark.parametrize("model_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity,miss_cap", [(700, 1536), (700, 128),
                                               (1, 256), (2000, 128)])
def test_feature_cache_matches_jax(small_graph, capacity, miss_cap,
                                   model_dtype):
    """Plan, staging and merged rows; miss_cap 128 overflows staging, and
    overflowed and padded slots come out zero in both."""
    g = small_graph
    feats = np.asarray(g.features, np.float32)
    jdt, jbytes = jax_cache_dtype(model_dtype, feats.shape[1])
    dt, nbytes = cache_dtype_for(model_dtype, feats.shape[1])
    assert nbytes == jbytes
    frontier = _jax_batch(g, n_valid=50).frontier
    order = _hot_order(g.num_nodes)
    jcache = JaxFeatureCache.build(feats, order, capacity, miss_cap, jdt)
    jplan = JaxFeatureCache.plan_ids(jcache.hot_ids, frontier, miss_cap)
    jstaged = jcache.stage(np.asarray(jplan.miss_ids))
    want = np.asarray(JaxFeatureCache.combine_rows(
        jcache.rows, jplan, jnp.asarray(jstaged), frontier)).astype(
            np.float32)

    cache = FeatureCache.build(feats, order, capacity, miss_cap, dt,
                               device="cpu")
    assert cache.rows.dtype == dt
    np.testing.assert_array_equal(cache.hot_ids.numpy(),
                                  np.asarray(jcache.hot_ids))
    fr = torch.from_numpy(np.array(frontier))
    plan = FeatureCache.plan_ids(cache.hot_ids, fr, miss_cap)
    for name, a, b in zip(plan._fields, plan, jplan):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(plan.overflow()) == int(jplan.overflow())
    assert int(plan.overflow()) == max(int(plan.num_miss) - miss_cap, 0)
    if (capacity, miss_cap) == (700, 128):
        assert int(plan.overflow()) > 0
    staged = cache.stage(plan.miss_ids.numpy())
    assert staged.dtype == dt
    np.testing.assert_array_equal(staged.float().numpy(),
                                  jstaged.astype(np.float32))
    got = cache.combine(plan, staged, fr)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (got[fr < 0] == 0).all()


def test_empty_cache_stages_every_row(small_graph):
    """A budget below one row caches nothing (JAX's combine cannot take
    an empty cache): every valid row is a miss and comes from staging."""
    feats = np.asarray(small_graph.features, np.float32)
    cache = FeatureCache.build(feats, _hot_order(small_graph.num_nodes), 0,
                               CAPS[-1], device="cpu")
    fr = torch.from_numpy(np.array(_jax_batch(small_graph).frontier))
    plan = cache.plan(fr)
    assert int(plan.num_hit) == 0 and int(plan.num_miss) == int(
        plan.num_valid)
    got = cache.combine(plan, cache.stage(plan.miss_ids.numpy()), fr)
    want = np.where((fr >= 0)[:, None].numpy(),
                    feats[np.clip(fr.numpy(), 0, None)], 0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stage_writes_into_a_given_buffer(small_graph):
    feats = np.asarray(small_graph.features, np.float32)
    cache = FeatureCache.build(feats, _hot_order(small_graph.num_nodes), 10,
                               64, torch.bfloat16, device="cpu")
    out = torch.full((64, feats.shape[1]), 7.0, dtype=torch.bfloat16)
    ids = np.array([5, 1999, 0], np.int32)
    got = cache.stage(ids, out=out[:3])
    assert got.data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(
        out[:3].float().numpy(),
        feats[ids].astype(ml_dtypes.bfloat16).astype(np.float32))
    assert (out[3:] == 7.0).all()


# -- one step of the cached path ----------------------------------------------

def _step_setup(g):
    jcfg = _cfg(jax_config, g.num_classes, hidden=HIDDEN)
    cfg = _cfg(port_config, g.num_classes, hidden=HIDDEN)
    jb = _jax_batch(g, key=3)
    feats = np.asarray(g.features, np.float32)
    jcache = JaxFeatureCache.build(feats, _hot_order(g.num_nodes), 700,
                                   CAPS[-1])
    jplan = JaxFeatureCache.plan_ids(jcache.hot_ids, jb.frontier, CAPS[-1])
    staged = jcache.stage(np.asarray(jplan.miss_ids))
    jmodel = jax_build_model("sage", HIDDEN, g.num_classes, 2, 0.0)
    params = jmodel.init(jax.random.PRNGKey(0), tuple(reversed(jb.blocks)),
                         jax_gather(jnp.asarray(feats), jb.frontier),
                         deterministic=True)["params"]
    model = build_model("sage", feats.shape[1], HIDDEN, g.num_classes, 2, 0.0)
    model.load_state_dict(params_from_flax(params))
    port = (torch.from_numpy(np.array(jcache.rows)), to_torch_batch(jb),
            _torch_plan(jplan), torch.from_numpy(staged))
    return jcfg, cfg, jmodel, params, model, jb, jcache, jplan, staged, port


def test_train_from_matches_jax(small_graph):
    (jcfg, cfg, jmodel, params, model, jb, jcache, jplan, staged,
     port) = _step_setup(small_graph)
    jtrain, _ = jax_step_fns(jcfg, jmodel)
    new_state, jloss = jax.jit(jtrain)(jax_state(params, 0.01, 0),
                                       jcache.rows, jb, jplan,
                                       jnp.asarray(staged))
    train_from, _ = make_cache_step_fns(cfg)
    state = create_train_state(model, 0.01, 0, "cpu")
    loss = train_from(state, *port)
    assert loss.dim() == 0 and state.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    want = params_from_flax(new_state.params)
    got = model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
    before = params_from_flax(params)
    assert all(not torch.equal(got[k], before[k]) for k in want)


def test_eval_from_matches_jax(small_graph):
    (jcfg, cfg, jmodel, params, model, jb, jcache, jplan, staged,
     port) = _step_setup(small_graph)
    _, jeval = jax_step_fns(jcfg, jmodel)
    a, b = jeval(params, jcache.rows, jb, jplan, jnp.asarray(staged))
    _, eval_from = make_cache_step_fns(cfg)
    ta, tb = eval_from(model, *port)
    assert ta.dtype == tb.dtype == torch.int32
    assert (int(ta), int(tb)) == (int(a), int(b))
    assert int(tb) == B


# -- the pipelined trainer ----------------------------------------------------

def _trainer(g, capacity=700, miss_cap=None, depth=2):
    cfg = _cfg(port_config, g.num_classes)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, pipeline_depth=depth))
    feats = np.asarray(g.features, np.float32)
    cache = FeatureCache.build(feats, _hot_order(g.num_nodes), capacity,
                               miss_cap or CAPS[-1], device="cpu")
    model = build_model("sage", feats.shape[1], 32, g.num_classes, 2, 0.0,
                        generator=torch.Generator().manual_seed(0))
    tr = CachedTrainer(cfg, model, CAPS,
                       DeviceGraph.from_host(g.indptr, g.indices, "cpu"),
                       cache)
    seeds = g.train_ids[:4 * B].reshape(4, B).astype(np.int32)
    return tr, create_train_state(model, 0.01, 0, "cpu"), seeds, \
        np.asarray(g.labels)[seeds]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_run_epoch_overlaps_staging_with_training(monkeypatch, small_graph,
                                                  depth):
    """``pipeline_depth`` steps are enqueued before the first is staged,
    and step i + depth is enqueued right after step i's training."""
    tr, state, seeds, labels = _trainer(small_graph, depth=depth)
    events = []
    for obj, name, tag in ((tr, "sample_plan", "d"), (tr, "stage", "s"),
                           (tr, "train_from", "t")):
        orig = getattr(obj, name)
        monkeypatch.setattr(obj, name, lambda *a, _o=orig, _t=tag, **k: (
            events.append(_t), _o(*a, **k))[1])
    r = tr.run_epoch(state, seeds, labels)
    want = "d" * depth + "".join(
        "st" + "d" * (i + depth < 4) for i in range(4))
    assert events == list(want)
    if depth == 2:
        assert want == "ddst" "dst" "dst" "st"
    assert r["steps"] == 4 and state.step == 4
    assert np.isfinite(r["losses"]).all() and r["loss"] == r["losses"][-1]
    assert 0.0 < r["cache_hit_rate"] < 1.0 and r["host_gb"] > 0
    assert r["staging_overflow"] == 0 and r["edges_per_s"] > 0


def test_run_epoch_reports_staging_overflow(small_graph):
    tr, state, seeds, labels = _trainer(small_graph, capacity=100,
                                        miss_cap=128)
    r = tr.run_epoch(state, seeds, labels)
    assert r["staging_overflow"] > 0
    # only the staged rows cross: at most miss_cap rows of 128 B a step
    assert r["host_gb"] * 2 ** 30 == pytest.approx(4 * 128 * 128)
    assert np.isfinite(r["losses"]).all()


def test_full_cache_trains_as_the_device_table(small_graph):
    """A cache holding every row stages nothing and gives the features
    of a table in device memory: the same losses as the same trainer over
    a second full cache, and a hit rate of 1."""
    a = _trainer(small_graph, capacity=small_graph.num_nodes)
    r = a[0].run_epoch(*a[1:])
    assert r["cache_hit_rate"] == 1.0 and r["host_gb"] == 0.0
    tr, state, seeds, labels = _trainer(small_graph,
                                        capacity=small_graph.num_nodes)
    assert tr.run_epoch(state, seeds, labels)["losses"] == r["losses"]


def test_eval_epoch_counts_every_valid_seed(small_graph):
    tr, _, _, _ = _trainer(small_graph)
    ids = small_graph.valid_ids[:150].astype(np.int32)
    seeds = np.full((3, B), -1, np.int32)
    counts = np.array([50, 50, 50], np.int32)
    for t in range(3):
        seeds[t, :50] = ids[t * 50:(t + 1) * 50]
    labels = np.where(seeds >= 0, np.asarray(small_graph.labels)[
        np.clip(seeds, 0, None)], -1).astype(np.int32)
    acc = tr.eval_epoch(tr.model, seeds, counts, labels)
    assert 0.0 <= acc <= 1.0
    # the same seeds give the same accuracy (the generator is reseeded)
    assert tr.eval_epoch(tr.model, seeds, counts, labels) == acc


# -- the driver ---------------------------------------------------------------

def test_run_cached_training_end_to_end(small_graph):
    """2 epochs on the CPU with a budget that caches a quarter of the rows
    (64 KiB of 128-byte rows): JAX's result keys, finite losses, a hit
    rate strictly inside (0, 1), host bytes, and learning."""
    g = small_graph
    logs = []
    res = run_cached_training(_cfg(port_config, g.num_classes,
                                   budget_bytes=64 * 1024, dropout=0.2),
                              g, "cpu", log=logs.append)
    jres = jax_run_cached_training(
        _cfg(jax_config, g.num_classes, budget_bytes=64 * 1024, epochs=1),
        g, log=lambda s: None)
    assert set(res) == set(jres)
    assert res["cost"].feat_capacity == jres["cost"].feat_capacity == 512
    assert len(res["history"]) == 2 and res["state"].epoch == 2
    for h in res["history"]:
        assert set(jres["history"][0]) - {"state"} <= set(h)
        assert np.isfinite(h["losses"]).all()
        assert 0.0 < h["cache_hit_rate"] < 1.0 and h["host_gb"] > 0
        assert h["staging_overflow"] == 0
    assert res["history"][-1]["valid"] > 2.0 / g.num_classes
    assert res["test_acc"] > 2.0 / g.num_classes
    assert any(s.startswith("cost model") for s in logs)
    assert logs[-1].startswith("Accuracy on test data")


@pytest.fixture(scope="module")
def host_features_run(small_graph):
    """The port's cached driver on its usual config (host features)."""
    return run_cached_training(
        _cfg(port_config, small_graph.num_classes, budget_bytes=64 * 1024),
        small_graph, "cpu", log=lambda s: None)


def _same_history(res, want):
    assert [h["losses"] for h in res["history"]] == [
        h["losses"] for h in want["history"]]
    assert [h["valid"] for h in res["history"]] == [
        h["valid"] for h in want["history"]]
    assert res["test_acc"] == want["test_acc"]


def _run_both_drivers(cfg_of, g, monkeypatch):
    """The reference's ``run_cached_training`` on ``cfg_of(jax_config)``,
    then the port's on ``cfg_of(port_config)`` from the reference's
    initial weights, at the reference's caps, with every batch (train and
    eval) drawn from the uniforms of the reference's key for that batch:
    train step i of epoch e ``fold_in(fold_in(PRNGKey(seed), e), i)``,
    eval step t ``fold_in(PRNGKey(4242), t)``. The cache's contents may
    differ (each side presamples its own hotness), but with float32 rows
    and no staging overflow the merged features are the host's rows
    either way. Returns (port result, reference result)."""
    from legion_tpu.train import cached_driver as jax_driver
    from legion_tpu_torch.cache import pipeline as port_pipeline
    from legion_tpu_torch.train import cached_driver as port_driver
    seen = {}
    jcaps, jstate = jax_driver.observed_caps, jax_driver.create_train_state

    def caps_spy(*a, **k):
        seen["caps"] = jcaps(*a, **k)
        return seen["caps"]

    def state_spy(params, *a, **k):
        seen["params"] = jax.tree_util.tree_map(np.array, params)
        return jstate(params, *a, **k)
    monkeypatch.setattr(jax_driver, "observed_caps", caps_spy)
    monkeypatch.setattr(jax_driver, "create_train_state", state_spy)
    jcfg = cfg_of(jax_config)
    jres = jax_run_cached_training(jcfg, g, log=lambda s: None)

    build = port_driver.build_model

    def build_from_ref(*a, **k):
        m = build(*a, **k)
        m.load_state_dict(params_from_flax(seen["params"]))
        return m
    monkeypatch.setattr(port_driver, "build_model", build_from_ref)
    monkeypatch.setattr(port_driver, "observed_caps",
                        lambda *a, **k: seen["caps"])
    sched = {}
    run_epoch, eval_epoch = CachedTrainer.run_epoch, CachedTrainer.eval_epoch

    def run_epoch_keyed(self, state, *a, **k):
        sched.update(key=jax.random.fold_in(
            jax.random.PRNGKey(jcfg.train.seed), state.epoch), i=0)
        return run_epoch(self, state, *a, **k)

    def eval_epoch_keyed(self, *a, **k):
        sched.update(key=jax.random.PRNGKey(4242), i=0)
        return eval_epoch(self, *a, **k)
    sample = port_pipeline.sample_batch

    def sample_keyed(*a, generator, **k):
        key = jax.random.fold_in(sched["key"], sched["i"])
        sched["i"] += 1
        return sample(*a, uniforms=torch_uniforms(key, a[5], a[4]), **k)
    monkeypatch.setattr(CachedTrainer, "run_epoch", run_epoch_keyed)
    monkeypatch.setattr(CachedTrainer, "eval_epoch", eval_epoch_keyed)
    monkeypatch.setattr(port_pipeline, "sample_batch", sample_keyed)
    return run_cached_training(cfg_of(port_config), g, "cpu",
                               log=lambda s: None), jres


@pytest.mark.parametrize("placement,enabled", [("host", False),
                                               ("hbm", True),
                                               ("hbm", False)])
def test_run_cached_training_needs_host_features_and_the_cache(
        small_graph, monkeypatch, placement, enabled):
    """With the cache on, ``feature_placement`` is not read (the
    reference's driver reads neither it nor ``enabled``; ``train.py``'s
    dispatch sends a ``--config`` with "hbm" here): "hbm" trains as the
    reference's driver does on the same config. From its initial weights,
    at its caps, on its batches' uniforms and with dropout 0, each epoch's
    last loss agrees within rtol 1e-4 / atol 1e-5 and the validation and
    test accuracies within 1e-6; the cache plan is the same size and
    neither side overflows its staging. The cache off stays refused: the
    dispatch never sends it here."""
    g = small_graph

    def cfg_of(cm):
        c = _cfg(cm, g.num_classes, budget_bytes=64 * 1024)
        return dataclasses.replace(
            c, dataset=dataclasses.replace(c.dataset,
                                           feature_placement=placement),
            cache=dataclasses.replace(c.cache, enabled=enabled))
    if not enabled:
        with pytest.raises(ValueError, match="enabled=True"):
            run_cached_training(cfg_of(port_config), g, "cpu")
        return
    res, jres = _run_both_drivers(cfg_of, g, monkeypatch)
    assert res["cost"].feat_capacity == jres["cost"].feat_capacity == 512
    assert len(res["history"]) == len(jres["history"]) == 2
    for h, jh in zip(res["history"], jres["history"]):
        assert h["steps"] == jh["steps"] > 1
        assert h["staging_overflow"] == jh["staging_overflow"] == 0
        assert 0.0 < h["cache_hit_rate"] < 1.0
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-4,
                                   atol=1e-5)
        assert h["valid"] == pytest.approx(jh["valid"], abs=1e-6)
    assert res["test_acc"] == pytest.approx(jres["test_acc"], abs=1e-6)


@pytest.mark.parametrize("what", ["profile_dir"])
def test_run_cached_training_rejects_unported_settings(
        small_graph, host_features_run, tmp_path, what):
    """``profile_dir``: the driver profiles its first epoch after the one
    that captured the stages (epoch 1 of 2): the same run, and that
    epoch's chrome trace alone in the directory, its host rows holding
    the pipeline's spans. (The name dates from when the setting was
    refused.)"""
    cfg = _cfg(port_config, small_graph.num_classes, budget_bytes=64 * 1024)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, **{what: str(tmp_path / "p")}))
    _same_history(run_cached_training(cfg, small_graph, "cpu",
                                      log=lambda s: None), host_features_run)
    assert [p.name for p in (tmp_path / "p").iterdir()] == [
        "epoch_1.pt.trace.json"]
    names = {e.get("name") for e in json.loads(
        (tmp_path / "p" / "epoch_1.pt.trace.json").read_text())[
            "traceEvents"]}
    assert {"epoch", "pipeline.plan_wait", "pipeline.stage",
            "stage.train_from"} <= names
