"""The staged programs: ``CachedTrainer`` (``cache/pipeline.py``) and
``HybridTrainer`` (``cache/hybrid.py``) run their device stages as CUDA
graphs between their host legs, the counterparts of ``legion_tpu``'s
``jit_sample_plan`` / ``jit_train_from`` / ``jit_eval_from`` and the
hybrid's ``_j_start`` / ``_j_steps`` / ``_j_finish``.

On the CPU the stages run eagerly on the same static buffers, so these
tests run the code that the graphs record on the card:

* the cached epoch and eval pass at pipeline depths 1, 2 and 3, and the
  hybrid's at 2 and 3 hops, against ``legion_tpu``'s trainers on the
  same injected uniforms, from the same weights, dropout 0, float32:
  each step's loss within rtol 1e-4 / atol 1e-5 (as
  ``tests/test_torch_hybrid.py`` holds one hybrid epoch), the statistics
  (hits, misses, valid ids, staging overflow, host bytes, hot / cold,
  fetches) exactly, the eval accuracy within 1e-6;
* the same epochs, with the generator's draws and dropout 0.3, bitwise
  equal to the eager loop the port ran before its stages were captured
  (fresh tensors every step), eagerly and through the stand-in capture
  of ``tests/test_torch_graphed.py`` (``faked_capture``);
* no host sync inside any stage (``_NoHostSync``);
* the kernels' launches after N steps those of N eager steps, captured or
  not;
* a trainer rebuilt for a larger staging capacity drops its graphs and
  captures anew;
* the striped trainers at 2 gloo ranks, eager and under the stand-in
  capture (which runs no collective while it captures), give the same
  losses and collectives.

The ``cuda``-marked legs run on the card
(``pytest --noconftest -m cuda tests/test_torch_staged_graphed.py``):
captured against eager from the same state, and the probe of one
generator registered with several graphs. JAX and ``legion_tpu`` are
imported inside the parity tests only."""

import collections
import contextlib
import functools
import os
import tempfile
import types
from unittest import mock

import numpy as np
import pytest
import torch

from legion_tpu_torch import config as port_config
from legion_tpu_torch import runtime
from legion_tpu_torch.cache import feature_cache
from legion_tpu_torch.cache.feature_cache import FeatureCache
from legion_tpu_torch.cache.hybrid import HybridTrainer
from legion_tpu_torch.cache.pipeline import CachedTrainer
from legion_tpu_torch.cache.topo_cache import TopoCache
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.models import build_model
from legion_tpu_torch.ops import dedup, gather, identity_agg, sample, spmm
from legion_tpu_torch.parallel import mesh
from legion_tpu_torch.sampling import sampler as port_sampler
from legion_tpu_torch.sampling.block import SampledBatch, frontier_caps
from legion_tpu_torch.sampling.sampler import DeviceGraph
from legion_tpu_torch.train import cached_driver, graphed, hybrid_driver
from legion_tpu_torch.train.train_state import (create_train_state,
                                                state_tensors)
from legion_tpu_torch.utils import comm, trace
from tests.test_torch_graphed import _exempt, _NoHostSync, faked_capture

torch.set_num_threads(2)

B, HIDDEN, FEAT_CAP, TOPO_CAP = 32, 16, 300, 800
CACHED_FANOUTS = (4, 3)
HYBRID_FANOUTS = {2: (25, 10), 3: (15, 10, 5)}
STEPS, EVAL_STEPS = 4, 2


def _graph():
    """conftest's ``small_graph``, built here so that the ``cuda`` legs
    and the ranks need no conftest."""
    return random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=7, seed=1)


def _cfg(cm, fanouts, depth=2, dropout=0.0, hybrid=False, **cache):
    return cm.Config(
        dataset=cm.DatasetConfig(
            num_classes=7, feature_placement="host",
            topology_placement="host" if hybrid else "hbm"),
        sampler=cm.SamplerConfig(fanouts=fanouts, batch_size=B,
                                 eval_batch_size=B, probe_caps=False),
        model=cm.ModelConfig(arch="sage", hidden_dim=HIDDEN,
                             num_layers=len(fanouts), dropout=dropout),
        train=cm.TrainConfig(learning_rate=0.01, seed=0, epochs=2,
                             pipeline_depth=depth),
        cache=cm.CacheConfig(enabled=True, **cache))


def _feat_order(g):
    return np.random.default_rng(0).permutation(g.num_nodes).astype(np.int32)


def _topo_order(g):
    return np.argsort(-np.diff(g.indptr), kind="stable").astype(np.int32)


def _seeds(g, steps=STEPS):
    seeds = g.train_ids[:steps * B].reshape(steps, B).astype(np.int32)
    return seeds, np.asarray(g.labels, np.int32)[seeds]


def _eval_seeds(g):
    ids = g.valid_ids[:EVAL_STEPS * 20].astype(np.int32)
    seeds = np.full((EVAL_STEPS, B), -1, np.int32)
    for t in range(EVAL_STEPS):
        seeds[t, :20] = ids[t * 20:(t + 1) * 20]
    labels = np.where(seeds >= 0, np.asarray(g.labels)[np.clip(seeds, 0,
                                                              None)], -1)
    return seeds, np.full(EVAL_STEPS, 20, np.int32), labels.astype(np.int32)


def _capturing(captured):
    """The stand-in capture of ``tests/test_torch_graphed.py``, or
    nothing."""
    return faked_capture() if captured else contextlib.nullcontext()


def _miss_cap(caps):
    """A staging capacity the misses overflow on both paths."""
    return min(caps[-1] // 4 // 128 * 128, 256)


def _cached(g, depth, dropout=0.0, pool=None, model=None):
    caps = frontier_caps(B, CACHED_FANOUTS)
    cfg = _cfg(port_config, CACHED_FANOUTS, depth, dropout)
    feats = np.asarray(g.features, np.float32)
    model = model or build_model("sage", feats.shape[1], HIDDEN, 7, 2,
                                 dropout,
                                 generator=torch.Generator().manual_seed(0))
    cache = FeatureCache.build(feats, _feat_order(g), FEAT_CAP,
                               _miss_cap(caps), device="cpu")
    tr = CachedTrainer(cfg, model, caps,
                       DeviceGraph.from_host(g.indptr, g.indices, "cpu"),
                       cache, pool=pool)
    return tr, create_train_state(model, 0.01, 0, "cpu")


def _hybrid(g, hops, dropout=0.0, pool=None, model=None):
    fanouts = HYBRID_FANOUTS[hops]
    caps = frontier_caps(B, fanouts)
    cfg = _cfg(port_config, fanouts, dropout=dropout, hybrid=True)
    feats = np.asarray(g.features, np.float32)
    model = model or build_model("sage", feats.shape[1], HIDDEN, 7, hops,
                                 dropout,
                                 generator=torch.Generator().manual_seed(0))
    tr = HybridTrainer(
        cfg, model, caps,
        TopoCache.build(g.indptr, g.indices, _topo_order(g), TOPO_CAP, "cpu"),
        g.indptr, g.indices,
        FeatureCache.build(feats, _feat_order(g), FEAT_CAP, _miss_cap(caps),
                           device="cpu"), pool=pool)
    return tr, create_train_state(model, 0.01, 0, "cpu")


# -- against legion_tpu ---------------------------------------------------------

def _ref():
    """The reference's names, imported when a parity test asks."""
    import jax
    import jax.numpy as jnp

    from legion_tpu import config
    from legion_tpu.cache.feature_cache import FeatureCache as JFeatureCache
    from legion_tpu.cache.hybrid import HybridSampler as JHybridSampler
    from legion_tpu.cache.hybrid import HybridTrainer as JHybridTrainer
    from legion_tpu.cache.pipeline import CachedTrainer as JCachedTrainer
    from legion_tpu.cache.topo_cache import TopoCache as JTopoCache
    from legion_tpu.models import build_model as jbuild_model
    from legion_tpu.sampling.sampler import DeviceGraph as JDeviceGraph
    from legion_tpu.sampling.sampler import sample_batch as jsample_batch
    from legion_tpu.train.train_state import create_train_state as jstate
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, config=config, FeatureCache=JFeatureCache,
        HybridSampler=JHybridSampler, HybridTrainer=JHybridTrainer,
        CachedTrainer=JCachedTrainer, TopoCache=JTopoCache,
        DeviceGraph=JDeviceGraph, sample_batch=jsample_batch,
        build_model=jbuild_model, create_train_state=jstate)


def _recording(fn, out):
    def wrapped(st, *a):
        st, loss = fn(st, *a)
        out.append(float(loss))
        return st, loss
    return wrapped


@pytest.fixture(scope="module")
def cached_ref():
    """legion_tpu's ``CachedTrainer``: one epoch (its losses step by
    step, its figures) and one eval pass, with its initial weights, and
    the uniforms of its key schedule for the port."""
    from tests.test_torch_sampler import torch_uniforms
    r = _ref()
    g = _graph()
    caps = frontier_caps(B, CACHED_FANOUTS)
    feats = np.asarray(g.features, np.float32)
    jcache = r.FeatureCache.build(feats, _feat_order(g), FEAT_CAP,
                                  _miss_cap(caps))
    jgraph = r.DeviceGraph.from_host(g.indptr, g.indices)
    seeds, labels = _seeds(g)
    jb = r.sample_batch(r.jax.random.PRNGKey(1), jgraph,
                        r.jnp.asarray(seeds[0]), r.jnp.int32(B),
                        r.jnp.asarray(labels[0]), CACHED_FANOUTS, caps)
    jmodel = r.build_model("sage", HIDDEN, 7, 2, 0.0)
    params = jmodel.init(r.jax.random.PRNGKey(0), tuple(reversed(jb.blocks)),
                         r.jnp.zeros((caps[-1], feats.shape[1])),
                         deterministic=True)["params"]
    jtr = r.CachedTrainer(_cfg(r.config, CACHED_FANOUTS), jmodel, caps,
                          jgraph, jcache)
    losses = []
    jtr.jit_train_from = _recording(jtr.jit_train_from, losses)
    params0 = r.jax.tree_util.tree_map(np.array, params)   # before donation
    state = r.create_train_state(params, 0.01, 0)
    key = r.jax.random.fold_in(state.rng, 0)
    rec = jtr.run_epoch(state, seeds, labels)
    es, ec, el = _eval_seeds(g)
    acc = jtr.eval_epoch(rec["state"].params, es, ec, el)

    def schedule(base):
        @functools.lru_cache(maxsize=None)
        def per_step(i):
            return torch_uniforms(r.jax.random.fold_in(base, i), caps,
                                  CACHED_FANOUTS)
        return lambda i, k: per_step(i)[k]
    return types.SimpleNamespace(
        params=params0, rec=rec, losses=losses, acc=acc,
        train_u=schedule(key),
        eval_u=schedule(r.jax.random.PRNGKey(4242)))


def _flax(model, params):
    from legion_tpu_torch.models.convert import params_from_flax
    model.load_state_dict(params_from_flax(params))
    return model


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_cached_epoch_matches_the_reference(cached_ref, depth, captured):
    """At pipeline depth 1, 2 and 3 (one slot's graphs per batch in
    flight) the static-buffer pipeline trains and evaluates as
    ``legion_tpu``'s ``CachedTrainer`` (tolerances: the module's
    docstring), staging overflow included."""
    g = _graph()
    with _capturing(captured) as captures:
        pool = graphed.GraphPool("cpu")
        tr, state = _cached(g, depth, pool=pool)
        _flax(tr.model, cached_ref.params)
        seeds, labels = _seeds(g)
        got = tr.run_epoch(state, seeds, labels, uniforms=cached_ref.train_u)
        acc = tr.eval_epoch(tr.model, *_eval_seeds(g),
                            uniforms=cached_ref.eval_u)
    np.testing.assert_allclose(got["losses"], cached_ref.losses, rtol=1e-4,
                               atol=1e-5)
    for k in ("steps", "cache_hit_rate", "host_gb", "staging_overflow"):
        assert got[k] == cached_ref.rec[k], k
    assert got["staging_overflow"] > 0 and 0 < got["cache_hit_rate"] < 1
    assert acc == pytest.approx(cached_ref.acc, abs=1e-6)
    assert state.step == STEPS
    if captured:      # a sample and a train (eval) graph per slot used
        assert len(captures) == (2 * min(depth, STEPS)
                                 + 2 * min(depth, EVAL_STEPS))


def _hybrid_ref(hops):
    r = _ref()
    g = _graph()
    fanouts = HYBRID_FANOUTS[hops]
    caps = frontier_caps(B, fanouts)
    feats = np.asarray(g.features, np.float32)
    jtopo = r.TopoCache.build(g.indptr, g.indices, _topo_order(g), TOPO_CAP)
    jcache = r.FeatureCache.build(feats, _feat_order(g), FEAT_CAP,
                                  _miss_cap(caps))
    jmodel = r.build_model("sage", HIDDEN, 7, hops, 0.0)
    key = r.jax.random.PRNGKey(0)
    seeds, labels = _seeds(g)
    batch0 = r.HybridSampler(jtopo, g.indptr, g.indices, fanouts,
                             caps).sample_batch(
        key, r.jnp.asarray(seeds[0]), B, r.jnp.asarray(labels[0]),
        host_seed=1)
    params = jmodel.init(key, tuple(reversed(batch0.blocks)),
                         r.jnp.zeros((caps[-1], feats.shape[1])),
                         deterministic=True)["params"]
    jtr = r.HybridTrainer(_cfg(r.config, fanouts, hybrid=True), jmodel, caps,
                          jtopo, g.indptr, g.indices, jcache)
    losses = []
    jtr._jit_train = _recording(jtr._jit_train, losses)
    params0 = r.jax.tree_util.tree_map(np.array, params)   # before donation
    state = r.create_train_state(params, 0.01, 0)
    epoch = 3
    ekey = r.jax.random.fold_in(state.rng, epoch)
    rec = jtr.run_epoch(state, seeds, labels, epoch)
    es, ec, el = _eval_seeds(g)
    f0 = jtr.stats["fetches"]
    acc = jtr.eval_epoch(rec["state"].params, es, ec, el)

    def schedule(base):
        def uniforms(step, hop):
            k = r.jax.random.fold_in(r.jax.random.fold_in(base, step), hop)
            return torch.from_numpy(np.asarray(r.jax.random.uniform(
                k, (caps[hop], fanouts[hop]),
                dtype=r.jnp.float32)).copy())
        return uniforms
    return types.SimpleNamespace(
        params=params0, rec=rec, losses=losses, acc=acc,
        stats=dict(jtr.stats),
        eval_fetches=jtr.stats["fetches"] - f0, epoch=epoch,
        train_u=schedule(ekey), eval_u=schedule(r.jax.random.PRNGKey(4242)))


@pytest.fixture(scope="module", params=[2, 3], ids=["2hops", "3hops"])
def hybrid_ref(request):
    return request.param, _hybrid_ref(request.param)


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
def test_hybrid_epoch_matches_the_reference(hybrid_ref, captured):
    """At 2 hops (fanouts 25, 10) and 3 hops (15, 10, 5) the hybrid's
    static-buffer stages train and evaluate as ``legion_tpu``'s
    ``HybridTrainer`` (tolerances: the module's docstring), its figures
    and fetch counts exactly."""
    hops, ref = hybrid_ref
    g = _graph()
    with _capturing(captured) as captures:
        tr, state = _hybrid(g, hops, pool=graphed.GraphPool("cpu"))
        _flax(tr.model, ref.params)
        seeds, labels = _seeds(g)
        got = tr.run_epoch(state, seeds, labels, ref.epoch,
                           uniforms=ref.train_u)
        acc = tr.eval_epoch(tr.model, *_eval_seeds(g), uniforms=ref.eval_u)
        eval_fetches = trace.epochs("eval")[-1]["counts"]["fetches"]
    np.testing.assert_allclose(got["losses"], ref.losses, rtol=1e-4,
                               atol=1e-5)
    for k in ("steps", "staging_overflow", "fetches", "feat_hit_rate",
              "host_feat_gb", "host_topo_gb", "topo_hot_fraction"):
        assert got[k] == ref.rec[k], k
    assert got["fetches"] == hops * STEPS + 1
    assert eval_fetches == ref.eval_fetches == hops * EVAL_STEPS + 1
    for k in ("hot", "cold", "host_topo_bytes"):
        assert tr.stats[k] == ref.stats[k], k
    assert got["fetches"] + eval_fetches == ref.stats["fetches"]
    assert acc == pytest.approx(ref.acc, abs=1e-6)
    assert 0 < got["topo_hot_fraction"] < 1 and got["staging_overflow"] > 0
    if captured:   # start, hops 1..H-1, finish, train; the same for eval
        assert len(captures) == 2 * (hops + 2)


# -- against the eager loop -------------------------------------------------------

def _eager_cached(tr, state, seeds, labels):
    """The cached pipeline as the port ran it before its stages were
    captured: fresh tensors every step, ``train.pipeline_depth`` samples
    enqueued ahead. Returns (losses, [hit, miss, valid, overflow, edges,
    staged rows])."""
    depth, ns, cap = tr.cfg.train.pipeline_depth, tr.n_stats, tr.cache.miss_cap
    nb = torch.tensor(B, dtype=torch.int32)
    inflight = collections.deque()

    def dispatch(i):
        inflight.append(tr.sample_plan(state.generator,
                                       torch.from_numpy(seeds[i]), nb,
                                       torch.from_numpy(labels[i])))
    for i in range(min(depth, len(seeds))):
        dispatch(i)
    losses, tot = [], np.zeros(ns + 1, np.int64)
    for i in range(len(seeds)):
        batch, plan, packed = inflight.popleft()
        p = packed.numpy()
        staged = tr.cache.stage_to(tr.device, p[ns:ns + min(int(p[1]), cap)])
        losses.append(float(tr.train_from(state, tr.cache.rows, batch, plan,
                                          staged)))
        tot[:ns] += p[:ns]
        tot[ns] += min(int(p[1]), cap)
        if i + depth < len(seeds):
            dispatch(i + depth)
    return losses, tot


def _eager_hybrid(tr, state, seeds, labels, epoch):
    """The hybrid pipeline as the port ran it before its stages were
    captured: fresh tensors every stage. Returns (losses, fetches)."""
    hops, ns, cap = len(tr.fanouts), tr.n_stats, tr.fcache.miss_cap
    nb = torch.tensor(B, dtype=torch.int32)
    gen = state.generator

    def u(hop):
        return torch.rand(tr._uniform_shape(hop), generator=gen)

    def cold(pack, hop, seed):
        return torch.from_numpy(runtime.sample_neighbors(
            tr.host_indptr, tr.host_indices, pack[1:], tr.fanouts[hop],
            seed=seed))
    carry, pack = tr._start(torch.from_numpy(seeds[0]), nb, u(0))
    pack, losses = pack.numpy(), []
    for i in range(len(seeds)):
        base, blocks = epoch * 1_000_003 + i, []
        for k in range(1, hops):
            carry, blk, p = tr._step(k, carry,
                                     cold(pack, k - 1, base * 131 + k - 1),
                                     u(k))
            blocks.append(blk)
            pack = p.numpy()
        nxt = (i + 1) % len(seeds)
        frontier, num, blk, plan, carry, packed = tr._finish(
            carry, cold(pack, hops - 1, base * 131 + hops - 1),
            torch.from_numpy(seeds[nxt]), nb, u(0))
        fused = packed.numpy()
        staged = tr.fcache.stage_to(tr.device,
                                    fused[ns:ns + min(int(fused[1]), cap)])
        batch = SampledBatch(
            seeds=torch.from_numpy(seeds[i]),
            labels=torch.from_numpy(labels[i]), num_seeds=nb,
            frontier=frontier, num_frontier=num, blocks=(*blocks, blk))
        losses.append(float(tr.train_from(state, tr.fcache.rows, batch,
                                          plan, staged)))
        pack = fused[ns + cap:]
    return losses


CASES = [("cached", 1), ("cached", 2), ("cached", 3), ("hybrid", 2),
         ("hybrid", 3)]


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("path,n", CASES,
                         ids=[f"{p}-{n}" for p, n in CASES])
def test_staged_epoch_is_the_eager_loop(path, n, captured):
    """With the generator's own draws and dropout 0.3, an epoch through
    the stages gives bitwise the losses, figures and state of the eager
    loop the port ran before (``n``: the pipeline depth, or the hops):
    the static buffers, the slot rings and the replay order change
    nothing, and the stand-in capture leaves no trace."""
    g = _graph()
    seeds, labels = _seeds(g)
    build = _cached if path == "cached" else _hybrid
    twin, twin_state = build(g, n, dropout=0.3)
    if path == "cached":
        want, tot = _eager_cached(twin, twin_state, seeds, labels)
    else:
        want = _eager_hybrid(twin, twin_state, seeds, labels, 5)
    with _capturing(captured):
        tr, state = build(g, n, dropout=0.3, pool=graphed.GraphPool("cpu"))
        args = () if path == "cached" else (5,)
        got = tr.run_epoch(state, seeds, labels, *args)
    assert got["losses"] == want
    for a, b in zip(state_tensors(state), state_tensors(twin_state)):
        assert torch.equal(a, b)
    assert torch.equal(state.generator.get_state(),
                       twin_state.generator.get_state())
    assert state.step == twin_state.step == STEPS
    if path == "cached":
        assert got["staging_overflow"] == int(tot[3])
        assert got["edges"] == int(tot[4])
        row_bytes = tr.cache.rows.shape[1] * tr.cache.rows.element_size()
        assert got["host_gb"] == int(tot[5]) * row_bytes / 2 ** 30
    else:
        assert got["fetches"] == n * STEPS + 1


# -- no host sync, launches, rebuilds -------------------------------------------

@pytest.mark.parametrize("path,n", [("cached", 2), ("hybrid", 2)])
def test_no_host_sync_in_a_stage(monkeypatch, path, n):
    """Every device stage (sample and plan, train, eval; start, inner
    hop, finish) holds no op that syncs the host, so it can be captured;
    the host legs between them read and copy as they must. Exempt inside
    the stages: the kernels' plain versions (the kernels run on the card)
    and Adam's step, which is not ``capturable`` on the CPU."""
    g = _graph()
    tr, state = (_cached if path == "cached" else _hybrid)(g, n, dropout=0.3)
    mode = _NoHostSync()
    mode.depth = 1                       # the host legs: not recorded
    for module, name in ((identity_agg, "identity_masked_mean_plain"),
                         (identity_agg, "gathered_masked_mean_plain"),
                         (identity_agg, "gathered_masked_mean_backward_plain"),
                         (gather, "gather_rows_plain"),
                         (sample, "sample_neighbors_plain"),
                         (spmm, "grouped_masked_sum_plain")):
        _exempt(monkeypatch, mode, module, name)
    _exempt(monkeypatch, mode, state.optimizer, "step")
    stages = []
    call = graphed.GraphedStep.__call__

    def in_stage(self):
        stages.append(self)
        mode.depth -= 1
        try:
            call(self)
        finally:
            mode.depth += 1
    monkeypatch.setattr(graphed.GraphedStep, "__call__", in_stage)
    seeds, labels = _seeds(g)
    with mode:
        if path == "cached":
            tr.run_epoch(state, seeds, labels)
        else:
            tr.run_epoch(state, seeds, labels, 0)
        tr.eval_epoch(tr.model, *_eval_seeds(g))
    assert len(stages) > 2 * STEPS and mode.ops > 200
    assert mode.found == [], f"host syncs in a {path} stage: {mode.found}"


def _counting(monkeypatch):
    """Shims that count for the wrappers, which count nothing on the
    CPU, where a kernel would launch."""
    from legion_tpu_torch.cache import feature_cache, topo_cache
    from legion_tpu_torch.models import sage

    def count(module, name, wrapper):
        fn = getattr(module, name)

        def shim(*args, **kwargs):
            wrapper.launches += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, shim)
    count(port_sampler, "sample_kernel", sample.sample_neighbors)
    count(port_sampler, "dedup_tail", dedup.dedup_tail)
    count(topo_cache, "sample_neighbors", sample.sample_neighbors)
    count(feature_cache, "gather_rows", gather.gather_rows)
    count(sage, "gathered_masked_mean", identity_agg.gathered_masked_mean)
    count(sage, "gathered_feature_mean", identity_agg.gathered_feature_mean)


@pytest.mark.parametrize("path,n", [("cached", 2), ("hybrid", 3)])
def test_replays_count_the_launches_of_the_steps(monkeypatch, path, n):
    """After an epoch and an eval pass the wrappers' counts are those of
    the eager run, captured or not (a capture counts nothing, a replay
    what its capture recorded): sampling H a step plus one a pass on the
    hybrid, H a step on the cached path, K3 twice a step (the cached and
    the staged rows), the dedup's tail H a step on both."""
    _counting(monkeypatch)
    g = _graph()
    seeds, labels = _seeds(g)
    counts = {}
    for captured in (False, True):
        with _capturing(captured):
            for fn in graphed.COUNTED:
                fn.launches = 0
            tr, state = (_cached if path == "cached" else _hybrid)(
                g, n, pool=graphed.GraphPool("cpu"))
            args = () if path == "cached" else (0,)
            tr.run_epoch(state, seeds, labels, *args)
            train = [fn.launches for fn in graphed.COUNTED]
            tr.eval_epoch(tr.model, *_eval_seeds(g))
            counts[captured] = (train, [fn.launches for fn in graphed.COUNTED])
    for fn in graphed.COUNTED:
        fn.launches = 0
    assert counts[True] == counts[False]
    train, both = counts[True]
    names = [fn.__name__ for fn in graphed.COUNTED]
    at = {k: names.index(k) for k in ("sample_neighbors", "gather_rows",
                                      "gathered_masked_mean", "dedup_tail")}
    hops = len(tr.fanouts)
    extra = 0 if path == "cached" else 1      # the prologue's hop 0
    assert train[at["sample_neighbors"]] == hops * STEPS + extra
    assert both[at["sample_neighbors"]] == hops * (STEPS + EVAL_STEPS) \
        + 2 * extra
    assert train[at["gather_rows"]] == 2 * STEPS
    assert both[at["gather_rows"]] == 2 * (STEPS + EVAL_STEPS)
    # both paths dedup every hop, the prologue's hop 0 none
    assert train[at["dedup_tail"]] == hops * STEPS
    assert both[at["dedup_tail"]] == hops * (STEPS + EVAL_STEPS)
    assert train[at["gathered_masked_mean"]] > 0


@pytest.mark.parametrize("path,n", [("cached", 2), ("hybrid", 2)])
def test_a_widening_layer_0_launches_the_feature_mean_once_a_step(
        monkeypatch, path, n):
    """With layer 0 wider than the features (32 -> 64), its gathered
    block takes ``gathered_feature_mean`` once a train and an eval step,
    captured or not, and layer 1 (64 -> 7) K2 once; with the narrowing
    layer 0 of the other tests (32 -> 16) it launches never."""
    _counting(monkeypatch)
    g = _graph()
    seeds, labels = _seeds(g)
    names = [fn.__name__ for fn in graphed.COUNTED]
    mean = names.index("gathered_feature_mean")
    k2 = names.index("gathered_masked_mean")
    counts = {}
    for hidden, captured in ((64, False), (64, True), (HIDDEN, False)):
        model = build_model("sage", g.features.shape[1], hidden, 7, n, 0.0,
                            generator=torch.Generator().manual_seed(0))
        with _capturing(captured):
            for fn in graphed.COUNTED:
                fn.launches = 0
            tr, state = (_cached if path == "cached" else _hybrid)(
                g, n, pool=graphed.GraphPool("cpu"), model=model)
            tr.run_epoch(state, seeds, labels,
                         *(() if path == "cached" else (0,)))
            train = [fn.launches for fn in graphed.COUNTED]
            tr.eval_epoch(tr.model, *_eval_seeds(g))
            counts[hidden, captured] = (
                train, [fn.launches for fn in graphed.COUNTED])
    for fn in graphed.COUNTED:
        fn.launches = 0
    assert counts[64, True] == counts[64, False]
    train, both = counts[64, True]
    assert (train[mean], both[mean]) == (STEPS, STEPS + EVAL_STEPS)
    assert (train[k2], both[k2]) == (STEPS, STEPS + EVAL_STEPS)
    train, both = counts[HIDDEN, False]
    assert (train[mean], both[mean]) == (0, 0)
    assert train[k2] == 2 * STEPS


def test_a_rebuilt_cache_captures_anew(monkeypatch):
    """The cached driver grows the staging capacity after an epoch that
    overflowed it: the old trainer releases its graphs, and the new one,
    on the new staging buffers, captures its own."""
    made, released = [], []
    init, release = CachedTrainer.__init__, CachedTrainer.release

    def tracking_init(self, *a, **k):
        made.append(self)
        init(self, *a, **k)

    def tracking_release(self):
        released.append((self, len(self.runs)))
        release(self)
    monkeypatch.setattr(CachedTrainer, "__init__", tracking_init)
    monkeypatch.setattr(CachedTrainer, "release", tracking_release)
    calls = iter([128])           # the first capacity: 128 rows, too few
    round128 = feature_cache.round128
    monkeypatch.setattr(feature_cache, "round128",
                        lambda x: next(calls, None) or round128(x))
    g = _graph()
    with faked_capture() as captures:
        res = cached_driver.run_cached_training(
            _cfg(port_config, CACHED_FANOUTS, budget_bytes=32 << 10,
                 presample_steps=2), g, "cpu", log=lambda s: None)
    first, second = res["history"]
    assert first["miss_cap"] == 128 and first["staging_overflow"] > 0
    assert second["miss_cap"] > 128
    # released after its one training epoch: the validation after it
    # runs on the new trainer
    assert len(made) == 2 and released == [(made[0], 1)]
    assert made[0].runs == {}
    assert set(made[1].runs) == {("train", False), ("eval", False)}
    run = made[1].runs[("train", False)]
    assert run.staged.shape[0] == second["miss_cap"]
    assert all(st.graph is not None for st in
               [s.step for s in run.sample] + run.consume)
    assert len(captures) >= 2 * 2 * 2        # 2 slots, train and eval, each


# -- the striped trainers at 2 gloo ranks ---------------------------------------

def _striped_rank(device, d):
    from tests.test_torch_striped import _cached_cfg
    from tests.test_torch_striped_hybrid import _cfg as _hybrid_cfg
    g = _graph()
    out = {}
    for name, run, cfg, module in (
            ("cached", cached_driver.run_cached_training,
             _cached_cfg(port_config, dropout=0.3, group=2), cached_driver),
            ("hybrid", hybrid_driver.run_hybrid_training,
             _hybrid_cfg(port_config, dropout=0.3, group=2),
             hybrid_driver)):
        for captured in (False, True):
            comm.reset_counts()
            if captured:
                with faked_capture() as captures, mock.patch.object(
                        module, "captures_steps", lambda device: True):
                    res = run(cfg, g, device, mesh=mesh.make_mesh(2),
                              log=lambda s: None)
            else:
                captures = []
                res = run(cfg, g, device, mesh=mesh.make_mesh(2),
                          log=lambda s: None)
            out[name, captured] = {
                "losses": [h["losses"] for h in res["history"]],
                "valid": [h["valid"] for h in res["history"]],
                "test": res["test_acc"], "captures": len(captures),
                "comm": (comm.read_calls(), comm.read_counts())}
    torch.save(out, os.path.join(d, f"rank{torch.distributed.get_rank()}.pt"))


@pytest.fixture(scope="module")
def striped_two():
    with tempfile.TemporaryDirectory() as d:
        mesh.spawn(_striped_rank, 2, "cpu", args=(d,), threads=1)
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]


@pytest.mark.parametrize("path", ["cached", "hybrid"])
def test_striped_trainers_capture_at_two_ranks(striped_two, path):
    """``run_cached_training`` and ``run_hybrid_training`` on a mesh of 2
    gloo ranks with dropout, eager and under the stand-in capture (told
    that the group captures): the same losses, validation and test
    figures bitwise, and the same collectives, counted by the
    bookkeeping (a capture runs none and counts none; each replay adds
    its capture's)."""
    for r in striped_two:
        eager, captured = r[path, False], r[path, True]
        assert captured["captures"] > 0 and eager["captures"] == 0
        for k in ("losses", "valid", "test", "comm"):
            assert captured[k] == eager[k], k
        assert sum(eager["comm"][0].values()) > 0


# -- on the card --------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_one_generator_several_graphs(cuda):
    """The design rests on this: three graphs registered with one
    generator, each captured after its warm-up and replayed in an order
    other than the capture's, with an eager draw and a ``set_state``
    between replays, draw bitwise what the same calls draw eagerly."""
    n = 1 << 14

    def bodies(gen, bufs):
        return {"a": lambda: bufs["a"].copy_(torch.rand(
                    (n,), generator=gen, device=cuda)),
                "b": lambda: bufs["b"].copy_(torch.randn(
                    (n // 2, 3), generator=gen, device=cuda)),
                "c": lambda: bufs["c"].copy_(torch.bernoulli(torch.full(
                    (n,), 0.7, device=cuda), generator=gen))}

    def run(captured):
        gen = torch.Generator(device=cuda).manual_seed(7)
        bufs = {"a": torch.empty(n, device=cuda),
                "b": torch.empty((n // 2, 3), device=cuda),
                "c": torch.empty(n, device=cuda)}
        pool = graphed.GraphPool(cuda) if captured else None
        steps = {k: graphed.GraphedStep(f, pool, (gen,))
                 for k, f in bodies(gen, bufs).items()}
        seen = []
        for k in "abcacbbacb":
            steps[k]()
            seen.append(bufs[k].clone())
        seen.append(torch.rand((5,), generator=gen, device=cuda))
        saved = gen.get_state()
        steps["c"]()
        seen.append(bufs["c"].clone())
        gen.set_state(saved)
        steps["c"]()
        seen.append(bufs["c"].clone())
        return seen
    got, want = run(True), run(False)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(got[-1], got[-2])


@pytest.mark.cuda
@pytest.mark.parametrize("path,n", [("cached", 2), ("hybrid", 2)])
def test_cuda_captured_equals_eager(cuda, path, n):
    """On the card, an epoch and an eval pass captured against the same
    run eager (no pool) from the same weights: equal figures and launch
    counts, losses within 1e-3 relative (K2 backward's atomics add in any
    order), equal eval figures within one seed."""
    g = _graph()
    seeds, labels = _seeds(g)
    out = {}
    for captured in (False, True):
        build = _cached if path == "cached" else _hybrid
        tr, _ = build(g, n, dropout=0.3)
        model = tr.model.to(cuda)
        feats = np.asarray(g.features, np.float32)
        caps = tr.caps
        if path == "cached":
            tr = CachedTrainer(
                tr.cfg, model, caps,
                DeviceGraph.from_host(g.indptr, g.indices, cuda),
                FeatureCache.build(feats, _feat_order(g), FEAT_CAP,
                                   _miss_cap(caps), device=cuda),
                pool=graphed.GraphPool(cuda) if captured else None)
        else:
            tr = HybridTrainer(
                tr.cfg, model, caps,
                TopoCache.build(g.indptr, g.indices, _topo_order(g),
                                TOPO_CAP, cuda),
                g.indptr, g.indices,
                FeatureCache.build(feats, _feat_order(g), FEAT_CAP,
                                   _miss_cap(caps), device=cuda),
                pool=graphed.GraphPool(cuda) if captured else None)
        state = create_train_state(model, 0.01, 0, cuda)
        for fn in graphed.COUNTED:
            fn.launches = 0
        args = () if path == "cached" else (0,)
        recs = [tr.run_epoch(state, seeds, labels, *args) for _ in range(2)]
        acc = tr.eval_epoch(model, *_eval_seeds(g))
        out[captured] = (recs, acc, [fn.launches for fn in graphed.COUNTED])
    (er, ea, el), (cr, ca, cl) = out[False], out[True]
    assert cl == el
    for e, c in zip(er, cr):
        np.testing.assert_allclose(c["losses"], e["losses"], rtol=1e-3)
        for k in ("staging_overflow", "host_gb", "cache_hit_rate",
                  "fetches", "host_topo_gb", "host_topo_copied_gb",
                  "topo_hot_fraction", "host_feat_gb"):
            assert c.get(k) == e.get(k), k
    assert ca == pytest.approx(ea, abs=1.0 / (EVAL_STEPS * 20))
    for fn in graphed.COUNTED:
        fn.launches = 0
