"""Port parity: the host-topology (hybrid) path — ``cache/topo_cache.py``,
``cache/hybrid.py``, ``train/hybrid_driver.py`` — against ``legion_tpu``'s
on the CPU.

* ``TopoCache``: the same sub-CSR, lookup and hot draws for the uniforms
  the reference's key gives, capacity 0 and capacity = all nodes included.
* ``HybridSampler`` / ``HybridTrainer``: the device uniforms injected are
  those of the reference's key schedule and the host legs run the same C++
  sampler with the same seeds, so frontiers, blocks and the hot / cold /
  byte / fetch counts are exactly equal; with the flax weights carried
  over and dropout 0, each step's float32 loss agrees within rtol 1e-4 /
  atol 1e-5 and the eval accuracy exactly.
* ``presample_hotness_host`` exactly, and the driver end to end: the
  reference's result and history keys, an equal cost-model split, caps and
  staging capacity, H reads a step plus one an epoch, learning, LP-SAGE,
  kill-and-resume with exactly the uninterrupted losses, and the config
  refusals.

JAX and ``legion_tpu`` are imported inside the parity tests only, so that
``pytest --noconftest -m cuda tests/test_torch_hybrid.py`` runs the
``cuda`` legs where JAX is absent."""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from legion_tpu_torch import config as port_config
from legion_tpu_torch.cache.feature_cache import FeatureCache
from legion_tpu_torch.cache.hybrid import HybridSampler, HybridTrainer
from legion_tpu_torch.cache.topo_cache import TopoCache, host_sample_cold
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.models import build_model
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.train.cached_driver import run_cached_training
from legion_tpu_torch.train.hybrid_driver import (presample_hotness_host,
                                                  run_hybrid_training)
from legion_tpu_torch.train.graphed import store
from legion_tpu_torch.train.loop import Trainer
from legion_tpu_torch.train.train_state import (create_train_state,
                                                latest_checkpoint)
from legion_tpu_torch.utils import trace

torch.set_num_threads(2)

B, FANOUTS, HIDDEN = 64, (5, 4), 16
CAPS = frontier_caps(B, FANOUTS)
HOPS = len(FANOUTS)


def _ref():
    """The reference's names, imported when a parity test asks."""
    import jax
    import jax.numpy as jnp

    from legion_tpu import config
    from legion_tpu.cache.feature_cache import FeatureCache as JFeatureCache
    from legion_tpu.cache.hybrid import HybridSampler as JHybridSampler
    from legion_tpu.cache.hybrid import HybridTrainer as JHybridTrainer
    from legion_tpu.cache.topo_cache import TopoCache as JTopoCache
    from legion_tpu.models import build_model as jbuild_model
    from legion_tpu.train import hybrid_driver
    from legion_tpu.train.train_state import create_train_state as jstate
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, config=config, FeatureCache=JFeatureCache,
        HybridSampler=JHybridSampler, HybridTrainer=JHybridTrainer,
        TopoCache=JTopoCache, build_model=jbuild_model,
        hybrid_driver=hybrid_driver, create_train_state=jstate)


def _graph():
    """conftest's ``small_graph``, built here too so that the ``cuda``
    legs need no conftest."""
    return random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=7, seed=1)


def _hot_order(g):
    return np.argsort(-np.diff(g.indptr), kind="stable").astype(np.int32)


def _cfg(cm, num_classes, arch="sage", epochs=2, ck=None, every=0,
         budget=96 << 10, dropout=0.0, batch=B, eval_batch=32, lr=0.01):
    """The hybrid path's configuration from either package's config. 96
    KiB feeds both caches on ``small_graph`` (alpha 0.23: 591 feature
    rows, 569 adjacency rows of 2000)."""
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=num_classes,
                                 topology_placement="host",
                                 feature_placement="host"),
        sampler=cm.SamplerConfig(fanouts=FANOUTS, batch_size=batch,
                                 eval_batch_size=eval_batch),
        model=cm.ModelConfig(arch=arch, hidden_dim=HIDDEN, num_layers=2,
                             dropout=dropout),
        train=cm.TrainConfig(epochs=epochs, learning_rate=lr,
                             checkpoint_dir=ck, checkpoint_every_steps=every),
        cache=cm.CacheConfig(enabled=True, budget_bytes=budget,
                             presample_steps=3))


def _frontier(g, n_valid=50, cap=CAPS[0]):
    fr = np.full(cap, -1, np.int32)
    fr[:n_valid] = g.train_ids[:n_valid]
    return fr


def _assert_batches_equal(jb, tb):
    np.testing.assert_array_equal(tb.frontier.cpu().numpy(),
                                  np.asarray(jb.frontier))
    assert int(tb.num_frontier) == int(jb.num_frontier)
    assert len(tb.blocks) == len(jb.blocks)
    for bt, bj in zip(tb.blocks, jb.blocks):
        np.testing.assert_array_equal(bt.nbr_pos.cpu().numpy(),
                                      np.asarray(bj.nbr_pos))
        np.testing.assert_array_equal(bt.nbr_mask.cpu().numpy(),
                                      np.asarray(bj.nbr_mask))
        assert int(bt.num_src) == int(bj.num_src)
        assert int(bt.num_dst) == int(bj.num_dst)


# -- the topology cache -------------------------------------------------------

@pytest.mark.parametrize("capacity", [0, 1, 800, 2000, 5000])
def test_topo_cache_matches_jax(small_graph, capacity):
    """Sub-CSR, lookup and hot draws exactly the reference's; capacity 0
    (no hot row: every node misses; the reference builds and looks up but
    cannot sample from its empty arrays, the port draws nothing), all
    nodes (no miss) and one past the node count."""
    r = _ref()
    g = small_graph
    order = _hot_order(g)
    want = r.TopoCache.build(g.indptr, g.indices, order, capacity)
    got = TopoCache.build(g.indptr, g.indices, order, capacity, "cpu")
    c = min(capacity, g.num_nodes)
    total = int(np.asarray(want.sub_indptr)[-1])
    assert got.hot_ids.shape == (c,) and got.sub_indptr.shape == (c + 1,)
    for a in got:
        assert a.dtype == torch.int32
    np.testing.assert_array_equal(got.hot_ids.numpy(),
                                  np.asarray(want.hot_ids))
    np.testing.assert_array_equal(got.sub_indptr.numpy(),
                                  np.asarray(want.sub_indptr))
    np.testing.assert_array_equal(got.sub_indices.numpy()[:total],
                                  np.asarray(want.sub_indices))
    assert got.sub_indices.shape[0] == max(total, 1)
    assert got.device_bytes() == 4 * (c + c + 1 + max(total, 1))

    fr = _frontier(g)
    hit, pos = got.lookup(torch.from_numpy(fr))
    jhit, jpos = want.lookup(r.jnp.asarray(fr))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert pos.dtype == torch.int32
    for fanout in (3, 25):
        key = r.jax.random.PRNGKey(fanout)
        u = np.asarray(r.jax.random.uniform(key, (len(fr), fanout),
                                            dtype=r.jnp.float32))
        tn, th = got.sample_hot(torch.from_numpy(fr),
                                torch.from_numpy(u.copy()))
        assert tn.dtype == torch.int32 and tn.shape == (len(fr), fanout)
        assert torch.equal(th, hit)
        if capacity:
            jn, jh = want.sample_hot(key, r.jnp.asarray(fr), fanout)
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    n_hit = int(hit.sum())
    if capacity == 0:
        assert n_hit == 0 and (tn == -1).all()
    if capacity >= g.num_nodes:
        assert n_hit == 50
    if capacity == 800:
        assert 0 < n_hit < 50


def test_topo_cache_reads_int64_offsets_and_a_memmap(small_graph, tmp_path):
    """An int64 ``indptr`` and memmapped ``indices`` build the same cache
    as arrays in memory; a sub-CSR of 2^31 edges or more is refused."""
    g = small_graph
    np.asarray(g.indices, np.int32).tofile(tmp_path / "i")
    mm = np.memmap(tmp_path / "i", dtype=np.int32, mode="r")
    order = _hot_order(g)
    a = TopoCache.build(np.asarray(g.indptr, np.int64), mm, order, 300,
                        "cpu")
    b = TopoCache.build(g.indptr, np.asarray(g.indices), order, 300,
                        "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    huge = np.array([0, 2 ** 31], np.int64)
    with pytest.raises(ValueError, match="2\\^31"):
        TopoCache.build(huge, np.zeros(1, np.int32),
                        np.zeros(1, np.int32), 1, "cpu")


def test_host_sample_cold_matches_jax(small_graph):
    from legion_tpu.cache.topo_cache import host_sample_cold as jcold
    g = small_graph
    ids = _frontier(g, 40)
    want = jcold(g.indptr, g.indices, ids, 6, np.random.default_rng(3))
    got = host_sample_cold(g.indptr, g.indices, ids, 6,
                           np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got[40:] == -1).all()


# -- the naive per-hop sampler ------------------------------------------------

def _uniforms_of_split_chain(r, key, caps, fanouts):
    out = []
    for k, f in enumerate(fanouts):
        key, sub = r.jax.random.split(key)
        out.append(torch.from_numpy(np.asarray(r.jax.random.uniform(
            sub, (caps[k], f), dtype=r.jnp.float32)).copy()))
    return out


@pytest.mark.parametrize("capacity", [1, 800, 2000])
def test_hybrid_sampler_matches_jax(small_graph, capacity):
    r = _ref()
    g = small_graph
    order = _hot_order(g)
    jhs = r.HybridSampler(
        r.TopoCache.build(g.indptr, g.indices, order, capacity),
        g.indptr, g.indices, FANOUTS, CAPS)
    hs = HybridSampler(
        TopoCache.build(g.indptr, g.indices, order, capacity, "cpu"),
        g.indptr, g.indices, FANOUTS, CAPS)
    seeds = _frontier(g, 48, B)
    labels = np.zeros(B, np.int32)
    for step in range(2):
        key = r.jax.random.PRNGKey(step)
        jb = jhs.sample_batch(key, r.jnp.asarray(seeds), 48,
                              r.jnp.asarray(labels), host_seed=7 + step)
        tb = hs.sample_batch(
            torch.from_numpy(seeds), 48, torch.from_numpy(labels),
            host_seed=7 + step,
            uniforms=_uniforms_of_split_chain(r, key, CAPS, FANOUTS))
        _assert_batches_equal(jb, tb)
        assert hs.stats == jhs.stats
    assert hs.hot_fraction() == jhs.hot_fraction()
    if capacity == 800:
        assert 0.0 < hs.hot_fraction() < 1.0 and hs.stats["host_bytes"] > 0
    if capacity == 1:
        assert hs.stats["hot"] <= 2
    if capacity == 2000:
        assert hs.stats["cold"] == 0 and hs.hot_fraction() == 1.0


def test_hybrid_sampler_from_a_generator(small_graph):
    """Every valid edge is a true edge whichever leg drew it; without a
    host seed two calls draw different cold neighbors; injected uniforms
    need one."""
    g = small_graph
    hs = HybridSampler(
        TopoCache.build(g.indptr, g.indices, _hot_order(g), 800, "cpu"),
        g.indptr, g.indices, FANOUTS, CAPS)
    seeds = torch.from_numpy(_frontier(g, B, B))
    gen = torch.Generator().manual_seed(0)
    a = hs.sample_batch(seeds, B, torch.zeros_like(seeds), generator=gen)
    b = hs.sample_batch(seeds, B, torch.zeros_like(seeds), generator=gen)
    assert not torch.equal(a.blocks[0].nbr_pos, b.blocks[0].nbr_pos)
    fr, n = a.frontier.numpy(), int(a.num_frontier)
    assert len(np.unique(fr[:n])) == n and (fr[n:] == -1).all()
    for blk in a.blocks:
        pos, m = blk.nbr_pos.numpy(), blk.nbr_mask.numpy()
        for d, j in zip(*np.nonzero(m)):
            assert fr[pos[d, j]] in g.indices[g.indptr[fr[d]]:
                                              g.indptr[fr[d] + 1]]
    # with nothing cached every draw is the host sampler's
    cold = HybridSampler(
        TopoCache.build(g.indptr, g.indices, _hot_order(g), 0, "cpu"),
        g.indptr, g.indices, FANOUTS[:1], CAPS[:2])
    c = cold.sample_batch(seeds, B, torch.zeros_like(seeds), host_seed=3,
                          generator=torch.Generator().manual_seed(0))
    assert cold.stats["hot"] == 0 and cold.stats["cold"] == B
    from legion_tpu_torch import runtime
    draws = runtime.sample_neighbors(
        np.asarray(g.indptr, np.int64), np.asarray(g.indices, np.int32),
        seeds.numpy(), FANOUTS[0], 3 * 1_000_003)
    np.testing.assert_array_equal(c.blocks[0].nbr_mask.numpy(), draws >= 0)
    with pytest.raises(ValueError, match="host_seed"):
        hs.sample_batch(seeds, B, torch.zeros_like(seeds),
                        uniforms=[torch.zeros(CAPS[0], 5)] * 2)
    with pytest.raises(ValueError, match="exactly one"):
        hs.sample_batch(seeds, B, torch.zeros_like(seeds), host_seed=1)


# -- the pipelined trainer ----------------------------------------------------

def _trainers(g, r, lr=0.01, topo_capacity=800, feat_capacity=700,
              miss_cap=CAPS[-1]):
    """The reference's HybridTrainer and the port's over the same caches,
    the port's model holding the flax weights."""
    from legion_tpu_torch.models.convert import params_from_flax
    order = _hot_order(g)
    feats = np.asarray(g.features, np.float32)
    forder = np.random.default_rng(0).permutation(g.num_nodes).astype(
        np.int32)
    jcfg = _cfg(r.config, g.num_classes, lr=lr)
    cfg = _cfg(port_config, g.num_classes, lr=lr)
    jtopo = r.TopoCache.build(g.indptr, g.indices, order, topo_capacity)
    jcache = r.FeatureCache.build(feats, forder, feat_capacity, miss_cap)
    jmodel = r.build_model("sage", HIDDEN, g.num_classes, 2, 0.0)
    key = r.jax.random.PRNGKey(0)
    batch0 = r.HybridSampler(jtopo, g.indptr, g.indices, FANOUTS,
                             CAPS).sample_batch(
        key, r.jnp.asarray(_frontier(g, B, B)), B,
        r.jnp.zeros((B,), r.jnp.int32), host_seed=1)
    params = jmodel.init(key, tuple(reversed(batch0.blocks)),
                         r.jnp.zeros((CAPS[-1], feats.shape[1])),
                         deterministic=True)["params"]
    jtr = r.HybridTrainer(jcfg, jmodel, CAPS, jtopo, g.indptr, g.indices,
                          jcache)
    model = build_model("sage", feats.shape[1], HIDDEN, g.num_classes, 2, 0.0)
    model.load_state_dict(params_from_flax(params))
    tr = HybridTrainer(
        cfg, model, CAPS,
        TopoCache.build(g.indptr, g.indices, order, topo_capacity, "cpu"),
        g.indptr, g.indices,
        FeatureCache.build(feats, forder, feat_capacity, miss_cap,
                           device="cpu"))
    return jtr, r.create_train_state(params, lr, 0), tr, \
        create_train_state(model, lr, 0, "cpu")


def _schedule(r, key):
    """uniforms(step, hop) of the reference's key schedule under ``key``:
    fold_in(fold_in(key, step), hop)."""
    def uniforms(step, hop):
        k = r.jax.random.fold_in(r.jax.random.fold_in(key, step), hop)
        return torch.from_numpy(np.asarray(r.jax.random.uniform(
            k, (CAPS[hop], FANOUTS[hop]), dtype=r.jnp.float32)).copy())
    return uniforms


def test_hybrid_trainer_epoch_matches_jax(small_graph):
    """One epoch of 4 steps and an eval epoch of 3: batches, statistics
    and fetch counts exactly equal, each step's loss within rtol 1e-4 /
    atol 1e-5 (float32, dropout 0), eval accuracy equal."""
    r = _ref()
    g = small_graph
    jtr, jstate, tr, state = _trainers(g, r)
    seeds = g.train_ids[:4 * B].reshape(4, B).astype(np.int32)
    labels = np.asarray(g.labels)[seeds].astype(np.int32)
    epoch = 3

    jlosses, jbatches = [], []
    jtrain = jtr._jit_train

    def recording_train(st, rows, batch, plan, staged):
        st, loss = jtrain(st, rows, batch, plan, staged)
        jlosses.append(float(loss))
        jbatches.append(batch)
        return st, loss
    jtr._jit_train = recording_train
    tbatches = []
    ttrain = tr.train_from

    def recording_train_from(st, rows, batch, plan, staged):
        # a copy: the batch lives in the pipeline's static buffers, which
        # the next step overwrites
        tbatches.append(store(None, batch))
        return ttrain(st, rows, batch, plan, staged)
    tr.train_from = recording_train_from

    key = r.jax.random.fold_in(jstate.rng, epoch)    # the state is donated
    want = jtr.run_epoch(jstate, seeds, labels, epoch)
    got = tr.run_epoch(state, seeds, labels, epoch,
                       uniforms=_schedule(r, key))
    assert len(tbatches) == len(jbatches) == 4
    for jb, tb in zip(jbatches, tbatches):
        _assert_batches_equal(jb, tb)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4, atol=1e-5)
    assert got["loss"] == got["losses"][-1]
    assert set(want) - {"state"} <= set(got)
    for k in ("steps", "staging_overflow", "fetches", "feat_hit_rate",
              "host_feat_gb", "host_topo_gb", "topo_hot_fraction"):
        assert got[k] == want[k], k
    assert got["fetches"] == HOPS * 4 + 1
    assert 0.0 < got["topo_hot_fraction"] < 1.0
    assert 0.0 < got["feat_hit_rate"] < 1.0 and got["host_feat_gb"] > 0
    assert got["edges_per_s"] > 0 and got["stage_s"] > 0
    assert got["host_sample_s"] > 0
    for k in ("hot", "cold", "host_topo_bytes"):
        assert tr.stats[k] == jtr.stats[k], k
    assert got["fetches"] == jtr.stats["fetches"]
    assert state.step == 4

    # eval: the reference's own key, the same structure and budget
    ids = g.valid_ids[:120].astype(np.int32)
    eseeds = np.full((3, B), -1, np.int32)
    counts = np.array([40, 40, 40], np.int32)
    for t in range(3):
        eseeds[t, :40] = ids[t * 40:(t + 1) * 40]
    elabels = np.where(eseeds >= 0, np.asarray(g.labels)[
        np.clip(eseeds, 0, None)], -1).astype(np.int32)
    jacc = jtr.eval_epoch(want["state"].params, eseeds, counts, elabels)
    acc = tr.eval_epoch(tr.model, eseeds, counts, elabels,
                        uniforms=_schedule(r, r.jax.random.PRNGKey(4242)))
    assert acc == pytest.approx(jacc, abs=1e-6) and 0.0 < acc < 1.0
    eval_fetches = trace.epochs("eval")[-1]["counts"]["fetches"]
    assert eval_fetches == HOPS * 3 + 1
    for k in ("hot", "cold", "host_topo_bytes"):
        assert tr.stats[k] == jtr.stats[k], k
    assert got["fetches"] + eval_fetches == jtr.stats["fetches"]
    assert np.isnan(tr.eval_epoch(tr.model, eseeds[:0], counts[:0],
                                  elabels[:0]))              # no step


def _small_trainer(g, feat_capacity=700, miss_cap=None,
                   topo_capacity=800):
    cfg = _cfg(port_config, g.num_classes)
    feats = np.asarray(g.features, np.float32)
    model = build_model("sage", feats.shape[1], HIDDEN, g.num_classes, 2, 0.0,
                        generator=torch.Generator().manual_seed(0))
    tr = HybridTrainer(
        cfg, model, CAPS,
        TopoCache.build(g.indptr, g.indices, _hot_order(g), topo_capacity,
                        "cpu"),
        g.indptr, g.indices,
        FeatureCache.build(feats, _hot_order(g), feat_capacity,
                           miss_cap or CAPS[-1], device="cpu"))
    seeds = g.train_ids[:4 * B].reshape(4, B).astype(np.int32)
    return tr, create_train_state(model, 0.01, 0, "cpu"), seeds, \
        np.asarray(g.labels)[seeds]


def test_next_batch_hop0_is_opened_in_this_batch_finish_stage(small_graph,
                                                              monkeypatch):
    """The stage order of an epoch: prologue (start, fetch), then per step
    cold, step, fetch, cold, finish (which opens the next batch, the last
    one wrapping to step 0), fetch, stage, train."""
    tr, state, seeds, labels = _small_trainer(small_graph)
    events, started = [], []
    for name, tag in (("_start", "S"), ("_step", "h"), ("_finish", "F"),
                      ("_fetch", "f"), ("_cold", "c"), ("train_from", "t")):
        orig = getattr(tr, name)
        monkeypatch.setattr(tr, name, lambda *a, _o=orig, _t=tag, **k: (
            events.append(_t), _o(*a, **k))[1])
    stage = tr.fcache.stage_to
    monkeypatch.setattr(tr.fcache, "stage_to", lambda *a: (
        events.append("s"), stage(*a))[1])
    start = tr._start
    monkeypatch.setattr(tr, "_start", lambda s, n, u: (
        started.append(s.tolist()), start(s, n, u))[1])
    r = tr.run_epoch(state, seeds, labels, 0)
    assert "".join(events) == "Sf" + "chfcFSfst" * 4
    assert started == [seeds[i].tolist() for i in (0, 1, 2, 3, 0)]
    assert r["fetches"] == events.count("f") == HOPS * 4 + 1


def test_run_epoch_reports_this_epochs_figures(small_graph):
    """Per-epoch deltas, not the trainer's running totals; a staging
    capacity below the misses is reported, and only staged rows count as
    host bytes."""
    tr, state, seeds, labels = _small_trainer(small_graph, feat_capacity=100,
                                              miss_cap=128)
    a = tr.run_epoch(state, seeds, labels, 0)
    b = tr.run_epoch(state, seeds, labels, 0)
    assert a["fetches"] == b["fetches"] == HOPS * 4 + 1
    assert [e["counts"]["fetches"] for e in trace.epochs("train")[-2:]] == [
        a["counts"]["fetches"], b["counts"]["fetches"]] == [a["fetches"]] * 2
    # the same seeds under other uniforms: figures of one epoch's size
    for k in ("host_topo_gb", "topo_hot_fraction", "staging_overflow",
              "feat_hit_rate"):
        assert b[k] == pytest.approx(a[k], rel=0.2), k
    assert a["host_feat_gb"] == b["host_feat_gb"]
    assert (tr.stats["host_topo_bytes"] / 2 ** 30
            == pytest.approx(a["host_topo_gb"] + b["host_topo_gb"]))
    # the buffers that carry the cold draws up: every hop's whole
    # (cap, fanout) int32 array, each step
    copied = 4 * sum(4 * c * f for c, f in zip(CAPS, FANOUTS))
    assert a["host_topo_copied_gb"] * 2 ** 30 == pytest.approx(copied)
    assert a["host_topo_copied_gb"] > a["host_topo_gb"]
    assert a["staging_overflow"] > 0
    assert a["host_feat_gb"] * 2 ** 30 == pytest.approx(4 * 128 * 128)
    assert np.isfinite(a["losses"]).all()
    assert a["losses"] != b["losses"]                 # the model moved on


# -- the driver ---------------------------------------------------------------

def test_presample_hotness_host_matches_jax(small_graph):
    r = _ref()
    g = small_graph
    seeds = g.train_ids[:3 * B].reshape(3, B).astype(np.int32).copy()
    seeds[-1, 50:] = -1
    args = (np.asarray(g.indptr, np.int64), np.asarray(g.indices, np.int32),
            seeds, FANOUTS, g.num_nodes, 5)
    got = presample_hotness_host(*args)
    want = r.hybrid_driver.presample_hotness_host(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    assert got[0].sum() > 0 and got[1].sum() > 0 and got[2][0] == B


@pytest.fixture(scope="module")
def driver_runs(small_graph):
    """One run of each package's driver (2 epochs)."""
    r = _ref()
    g = small_graph
    logs = []
    res = run_hybrid_training(_cfg(port_config, g.num_classes), g, "cpu",
                              log=logs.append)
    jres = r.hybrid_driver.run_hybrid_training(
        _cfg(r.config, g.num_classes), g, log=lambda s: None)
    return res, jres, logs


def test_run_hybrid_training_matches_the_reference_driver(small_graph,
                                                          driver_runs):
    """The reference's keys; an equal cost-model split with both caches
    fed; equal caps and staging capacity; hit and hot fractions close to
    the reference's (their device draws differ: a generator here, a key
    there); H reads a step plus one in every epoch; learning above 1.5x
    chance."""
    g = small_graph
    res, jres, logs = driver_runs
    assert set(res) == set(jres)
    for k in ("alpha", "feat_capacity", "topo_capacity"):
        assert getattr(res["cost"], k) == getattr(jres["cost"], k), k
    np.testing.assert_array_equal(res["cost"].topo_order,
                                  jres["cost"].topo_order)
    assert 0.0 < res["cost"].alpha < 1.0
    assert res["cost"].feat_capacity > 0 and res["cost"].topo_capacity > 0
    assert res["trainer"].caps == tuple(jres["trainer"].caps)
    assert res["trainer"].fcache.miss_cap == jres["trainer"].fcache.miss_cap
    assert len(res["history"]) == len(jres["history"]) == 2
    chance = 1.0 / g.num_classes
    for h, jh in zip(res["history"], jres["history"]):
        assert set(jh) <= set(h)
        assert h["caps"] == list(res["trainer"].caps)
        assert h["miss_cap"] == res["trainer"].fcache.miss_cap
        assert h["steps"] == jh["steps"]
        assert h["fetches"] == jh["fetches"] == HOPS * h["steps"] + 1
        assert np.isfinite(h["losses"]).all()
        assert h["feat_hit_rate"] == pytest.approx(jh["feat_hit_rate"],
                                                   abs=0.05)
        assert h["topo_hot_fraction"] == pytest.approx(
            jh["topo_hot_fraction"], abs=0.05)
        assert 0.0 < h["feat_hit_rate"] < 1.0
        assert 0.0 < h["topo_hot_fraction"] < 1.0
        assert h["host_feat_gb"] > 0 and h["host_topo_gb"] > 0
    assert res["history"][-1]["valid"] > 1.5 * chance
    assert res["test_acc"] > 1.5 * chance
    assert res["history"][1]["loss"] < res["history"][0]["loss"]
    assert res["state"].epoch == 2
    assert res["state"].step == 2 * res["history"][0]["steps"]
    assert isinstance(res["sampler"], HybridSampler)
    assert isinstance(res["trainer"], HybridTrainer)
    assert logs[0].startswith("host presampling")
    assert any(s.startswith("cost model: alpha=") for s in logs)
    assert logs[-1].startswith("Accuracy on test data")


def test_hybrid_eval_fetch_budget(small_graph, driver_runs):
    """Eval spends the same H reads a step plus one (the reference's
    ``tests/test_hybrid.py::test_hybrid_eval_fetch_budget``)."""
    g = small_graph
    tr = driver_runs[0]["trainer"]
    ids = np.asarray(g.valid_ids)[:48]
    seeds = np.full((3, B), -1, np.int32)
    counts = np.zeros((3,), np.int32)
    for t in range(3):
        chunk = ids[t * 16:(t + 1) * 16]
        seeds[t, : len(chunk)] = chunk
        counts[t] = len(chunk)
    labels = np.where(seeds >= 0, np.asarray(g.labels)[
        np.clip(seeds, 0, None)], -1).astype(np.int32)
    acc = tr.eval_epoch(tr.model, seeds, counts, labels)
    assert 0.0 <= acc <= 1.0
    assert trace.epochs("eval")[-1]["counts"]["fetches"] == HOPS * 3 + 1
    # the eval generator is seeded anew: the same figure again
    assert tr.eval_epoch(tr.model, seeds, counts, labels) == acc


def test_lp_sage_through_the_hybrid_driver(small_graph):
    """``tests/test_lp_trainers.py::test_lp_hybrid_driver``'s checks."""
    g = small_graph
    logs = []
    cfg = _cfg(port_config, g.num_classes, arch="lp_sage", batch=48,
               eval_batch=48, budget=1 << 20)
    cfg = dataclasses.replace(cfg, cache=dataclasses.replace(
        cfg.cache, presample_steps=2))
    history = run_hybrid_training(cfg, g, "cpu", log=logs.append)["history"]
    assert np.isfinite(history[-1]["loss"])
    assert history[-1]["loss"] < history[0]["loss"] * 1.2
    valid = history[-1]["valid"]
    assert np.isfinite(valid) and valid > history[-1]["loss"] * 0.2
    assert any("Val LP-loss" in s for s in logs)
    assert not any("Val Acc" in s for s in logs)
    assert logs[-1].startswith("LP-loss on test data")


@pytest.mark.parametrize("arch", ["sage", "lp_sage"])
def test_hybrid_driver_kill_and_resume(small_graph, tmp_path, arch):
    """A run killed after epoch 0 and resumed by a fresh driver gives
    exactly the uninterrupted run's losses (dropout 0.3: the generator's
    state comes back, and the next batch's hop-0 uniforms are always drawn
    before this batch's dropout)."""
    g, ck = small_graph, str(tmp_path / "ck")
    kw = dict(arch=arch, dropout=0.3, batch=48, eval_batch=48)
    want = run_hybrid_training(_cfg(port_config, g.num_classes, **kw), g,
                               "cpu", log=lambda s: None)
    logs1 = []
    out1 = run_hybrid_training(
        _cfg(port_config, g.num_classes, epochs=1, ck=ck, every=2, **kw), g,
        "cpu", log=logs1.append)
    assert not any("resumed from checkpoint" in s for s in logs1)
    steps = out1["history"][0]["steps"]
    assert sorted(os.listdir(ck), key=lambda d: int(d[5:])) == [
        f"step_{n}" for n in sorted({*range(2, steps + 1, 2), steps})]
    assert latest_checkpoint(ck) == os.path.join(ck, f"step_{steps}")
    assert out1["history"][0]["losses"] == want["history"][0]["losses"]

    logs2 = []
    out2 = run_hybrid_training(
        _cfg(port_config, g.num_classes, ck=ck, **kw), g, "cpu",
        log=logs2.append)
    assert any(f"resumed from checkpoint at step {steps}, epoch 1" in s
               for s in logs2)
    assert [h["epoch"] for h in out2["history"]] == [1]
    assert out2["history"][0]["losses"] == want["history"][1]["losses"]
    assert out2["history"][0]["valid"] == want["history"][1]["valid"]
    assert out2["test_acc"] == want["test_acc"]
    assert out2["state"].epoch == 2 and out2["state"].step == 2 * steps
    # a finished run restarts nothing
    done = run_hybrid_training(_cfg(port_config, g.num_classes, ck=ck, **kw),
                               g, "cpu", log=lambda s: None)
    assert done["history"] == []


@pytest.mark.parametrize("topo,feat,enabled", [
    ("hbm", "host", True), ("host", "hbm", True), ("host", "host", False)])
def test_run_hybrid_training_refuses_another_drivers_config(
        small_graph, driver_runs, topo, feat, enabled):
    """The driver reads neither placement nor ``enabled``, as the
    reference's does (``train.py --synthetic N --topology host`` sends it
    ``topology_placement="hbm"``; a ``--config`` may send the rest): each
    config runs exactly as the fixture's host / host / enabled run, which
    is held against the reference's driver above. (The name dates from
    when these configs were refused.)"""
    cfg = _cfg(port_config, small_graph.num_classes)
    cfg = dataclasses.replace(
        cfg, dataset=dataclasses.replace(cfg.dataset,
                                         topology_placement=topo,
                                         feature_placement=feat),
        cache=dataclasses.replace(cfg.cache, enabled=enabled))
    res = run_hybrid_training(cfg, small_graph, "cpu", log=lambda s: None)
    want = driver_runs[0]
    assert [h["losses"] for h in res["history"]] == [
        h["losses"] for h in want["history"]]
    assert res["test_acc"] == want["test_acc"]
    assert res["cost"].feat_capacity == want["cost"].feat_capacity > 0


def test_run_hybrid_training_with_no_budget_matches_the_reference(
        small_graph, monkeypatch):
    """``train.py --topology host`` with no ``--cache-budget-gb`` (the
    fault of ROADMAP queue 3, closed): features "hbm", the cache off and a
    zero budget train through the hybrid driver with two empty caches,
    every hop and every row served from the host. From the reference's
    initial weights, with dropout 0, the batches are the host sampler's
    alone, so each epoch's last loss agrees with the reference's within
    rtol 1e-4 / atol 1e-5 and the validation and test figures are
    equal. The reference's own run stops at its first gather from an
    empty cache: JAX cannot gather from the zero-size ``sub_indices`` of
    the empty sub-CSR (``TopoCache.sample_hot``) nor from the zero rows of
    the empty feature cache (``FeatureCache.combine_rows``), a fault of
    the reference (ROADMAP queue 3). So here each of its empty caches
    holds one entry that nothing reads, as the port's sub-CSR does
    (``topo_cache.py``)."""
    from legion_tpu_torch.models.convert import params_from_flax
    from legion_tpu_torch.train import hybrid_driver as port_driver
    r = _ref()
    g = small_graph

    def cfg(cm):
        c = _cfg(cm, g.num_classes, budget=0)
        return dataclasses.replace(
            c, dataset=dataclasses.replace(c.dataset,
                                           feature_placement="hbm"),
            cache=dataclasses.replace(c.cache, enabled=False))

    jbuild = r.TopoCache.build.__func__

    def build_padded(cls, *a, **k):
        t = jbuild(cls, *a, **k)
        if t.sub_indices.shape[0] == 0:
            t = t._replace(sub_indices=r.jnp.zeros((1,), r.jnp.int32))
        return t
    monkeypatch.setattr(r.TopoCache, "build", classmethod(build_padded))
    fbuild = r.FeatureCache.build.__func__

    def fbuild_padded(cls, *a, **k):
        c = fbuild(cls, *a, **k)
        if c.rows.shape[0] == 0:
            c = cls(c.hot_ids, r.jnp.zeros((1, c.rows.shape[1]),
                                            c.rows.dtype),
                    c.host_features, c.miss_cap)
        return c
    monkeypatch.setattr(r.FeatureCache, "build", classmethod(fbuild_padded))
    init = {}
    jstate = r.hybrid_driver.create_train_state

    def spy(params, *a, **k):
        init["params"] = r.jax.tree_util.tree_map(np.array, params)
        return jstate(params, *a, **k)
    monkeypatch.setattr(r.hybrid_driver, "create_train_state", spy)
    jres = r.hybrid_driver.run_hybrid_training(cfg(r.config), g,
                                               log=lambda s: None)
    build = port_driver.build_model

    def build_from_ref(*a, **k):
        m = build(*a, **k)
        m.load_state_dict(params_from_flax(init["params"]))
        return m
    monkeypatch.setattr(port_driver, "build_model", build_from_ref)
    res = run_hybrid_training(cfg(port_config), g, "cpu", log=lambda s: None)

    assert (res["cost"].feat_capacity, res["cost"].topo_capacity) == (0, 0)
    assert (jres["cost"].feat_capacity, jres["cost"].topo_capacity) == (0, 0)
    assert len(res["history"]) == len(jres["history"]) == 2
    for h, jh in zip(res["history"], jres["history"]):
        assert h["steps"] == jh["steps"]
        assert h["feat_hit_rate"] == jh["feat_hit_rate"] == 0.0
        assert h["topo_hot_fraction"] == jh["topo_hot_fraction"] == 0.0
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-4,
                                   atol=1e-5)
        assert h["valid"] == pytest.approx(jh["valid"], abs=1e-6)
    assert res["test_acc"] == pytest.approx(jres["test_acc"], abs=1e-6)


def test_the_other_drivers_refuse_host_topology(small_graph):
    cfg = _cfg(port_config, 7)
    with pytest.raises(ValueError, match="run_hybrid_training"):
        run_cached_training(cfg, small_graph, "cpu")
    with pytest.raises(ValueError, match="run_hybrid_training"):
        Trainer(dataclasses.replace(
            cfg, dataset=port_config.DatasetConfig(topology_placement="host"),
            cache=port_config.CacheConfig()), small_graph, device="cpu")
    with pytest.raises(ValueError, match="topology_placement"):
        port_config.DatasetConfig(topology_placement="disk")


def test_run_hybrid_training_accepts_profile_dir(small_graph, driver_runs,
                                                 tmp_path):
    """``profile_dir`` is accepted and not read, as in the reference (the
    ``Trainer`` and the cached driver profile): the fixture's run
    exactly, and nothing in the directory."""
    cfg = _cfg(port_config, small_graph.num_classes)
    res = run_hybrid_training(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train,
                                       profile_dir=str(tmp_path / "p"))),
        small_graph, "cpu", log=lambda s: None)
    assert [h["losses"] for h in res["history"]] == [
        h["losses"] for h in driver_runs[0]["history"]]
    assert not (tmp_path / "p").exists()


# -- on the card -------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [0, 800, 2000])
def test_cuda_topo_cache_matches_the_cpu(capacity):
    """``sample_hot`` through the sampling kernel on the sub-CSR is
    bitwise the CPU's plain version, for no, some and all rows cached."""
    dev = _need_cuda()
    g = _graph()
    order = _hot_order(g)
    cpu = TopoCache.build(g.indptr, g.indices, order, capacity, "cpu")
    gpu = TopoCache.build(g.indptr, g.indices, order, capacity, dev)
    assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, gpu))
    fr = torch.from_numpy(_frontier(g))
    for fanout in (3, 25):
        u = torch.rand((len(fr), fanout),
                       generator=torch.Generator().manual_seed(fanout))
        want_n, want_h = cpu.sample_hot(fr, u)
        got_n, got_h = gpu.sample_hot(fr.to(dev), u.to(dev))
        assert torch.equal(got_n.cpu(), want_n)
        assert torch.equal(got_h.cpu(), want_h)


@pytest.mark.cuda
def test_cuda_hybrid_step_matches_the_cpu():
    """One train step and one eval epoch of the pipelined trainer on the
    card against the CPU on the same uniforms: the same batch and
    statistics, the loss within 1e-4 relative (float32; the card's sums
    run in another order), and the sampling kernel, K2 and K3 launched
    the exact number of times."""
    dev = _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from legion_tpu_torch.ops.gather import gather_rows
    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean, gathered_masked_mean_backward)
    from legion_tpu_torch.ops.sample import sample_neighbors
    g = _graph()
    seeds = g.train_ids[:B].reshape(1, B).astype(np.int32)
    labels = np.asarray(g.labels)[seeds]
    gen = torch.Generator().manual_seed(1)
    table = {(s, h): torch.rand((CAPS[h], FANOUTS[h]), generator=gen)
             for s in range(2) for h in range(HOPS)}
    out = {}
    for d in ("cpu", dev):
        cfg = _cfg(port_config, g.num_classes)
        feats = np.asarray(g.features, np.float32)
        model = build_model("sage", feats.shape[1], HIDDEN, g.num_classes, 2,
                            0.0, generator=torch.Generator().manual_seed(0)
                            ).to(d)
        tr = HybridTrainer(
            cfg, model, CAPS,
            TopoCache.build(g.indptr, g.indices, _hot_order(g), 800, d),
            g.indptr, g.indices,
            FeatureCache.build(feats, _hot_order(g), 700, CAPS[-1],
                               device=d))
        batches = []
        train = tr.train_from
        tr.train_from = lambda st, rows, batch, *a, _t=train: (
            batches.append(store(None, batch)), _t(st, rows, batch, *a))[1]
        kernels = (sample_neighbors, gathered_masked_mean,
                   gathered_masked_mean_backward, gather_rows)
        for k in kernels:
            k.launches = 0
        r = tr.run_epoch(create_train_state(model, 0.01, 0, d), seeds, labels,
                         0, uniforms=lambda s, h: table[(s, h)])
        launches = [k.launches for k in kernels]
        acc = tr.eval_epoch(model, seeds, np.array([B], np.int32), labels,
                            uniforms=lambda s, h: table[(s, h)])
        out[str(d)] = (r, batches[0], acc, launches, dict(tr.stats))
    (rc, bc, ac, lc, sc), (rg, bg, ag, lg, sg) = out["cpu"], out[str(dev)]
    assert torch.equal(bg.frontier.cpu(), bc.frontier)
    for x, y in zip(bg.blocks, bc.blocks):
        assert torch.equal(x.nbr_pos.cpu(), y.nbr_pos)
        assert torch.equal(x.nbr_mask.cpu(), y.nbr_mask)
    np.testing.assert_allclose(rg["losses"], rc["losses"], rtol=1e-4)
    for k in ("fetches", "feat_hit_rate", "topo_hot_fraction",
              "host_topo_gb", "host_feat_gb", "staging_overflow"):
        assert rg[k] == rc[k], k
    for k in ("hot", "cold", "host_topo_bytes", "fetches"):
        assert sg[k] == sc[k], k
    assert ag == pytest.approx(ac, abs=2.0 / B)
    assert lc == [0, 0, 0, 0]
    # one step: H hops and the prologue; K2 forward and backward in both
    # layers (each narrows its input, 32 -> 16 -> 7, so it transforms
    # first and gathers through K2); K3 for the cached and the staged rows
    assert lg == [HOPS + 1, 2, 2, 2]
