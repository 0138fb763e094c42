"""Port parity: one training step of legion_tpu_torch against legion_tpu's
jitted ``train_step`` on the CPU, plus the port's Trainer end to end.

Both sides start from the same flax params, batch and per-hop uniforms
(the port's are rebuilt from the JAX step key, loop.py:154-155), in
float32 with dropout 0. Loss agrees at 1e-5, counts exactly, and the
params after one Adam step at 1e-4 absolute: Adam's first step divides g
by |g| + eps, so entries with |g| near eps magnify float32 summation-order
differences."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legion_tpu import config as jax_config
from legion_tpu.data.format import pad_feature_dim
from legion_tpu.models import build_model as jax_build_model
from legion_tpu.sampling.sampler import DeviceGraph as JaxDeviceGraph
from legion_tpu.sampling.sampler import gather_features as jax_gather_features
from legion_tpu.sampling.sampler import sample_batch as jax_sample_batch
from legion_tpu.train.loop import make_step_fns as jax_make_step_fns
from legion_tpu.train.loop import masked_softmax_ce as jax_masked_softmax_ce
from legion_tpu.train.train_state import create_train_state as jax_create_state
from legion_tpu_torch import config as port_config
from legion_tpu_torch.models import build_model
from legion_tpu_torch.models.convert import params_from_flax
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import DeviceGraph
from legion_tpu_torch.train.loop import (Trainer, make_step_fns,
                                         masked_softmax_ce, sum_edge_counts)
from legion_tpu_torch.train.train_state import create_train_state
from tests.test_torch_sampler import padded_seeds, torch_uniforms

torch.set_num_threads(2)

B, FANOUTS, HIDDEN = 64, (5, 3), 16


def _cfg(num_classes, dedup_last=False, batch=B, dropout=0.0, cm=port_config,
         **sampler):
    """The same configuration from the port's config module (default) or
    the reference's (``cm=jax_config``)."""
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=num_classes),
        sampler=cm.SamplerConfig(fanouts=FANOUTS, batch_size=batch,
                                 dedup_last=dedup_last, **sampler),
        model=cm.ModelConfig(arch="sage", hidden_dim=HIDDEN, num_layers=2,
                             dropout=dropout),
        train=cm.TrainConfig(learning_rate=0.01, epochs=3, seed=0))


class _Both:
    """legion_tpu and port set up on the same graph, params and caps."""

    def __init__(self, g, cfg, caps):
        self.cfg, self.caps = cfg, caps
        feats = pad_feature_dim(np.asarray(g.features, np.float32), 128)
        self.jgraph = JaxDeviceGraph.from_host(g.indptr, g.indices)
        self.jfeats = jnp.asarray(feats)
        self.tgraph = DeviceGraph.from_host(g.indptr, g.indices, "cpu")
        self.tfeats = torch.from_numpy(feats)
        self.jmodel = jax_build_model("sage", HIDDEN, g.num_classes, 2, 0.0)
        s = jnp.arange(B, dtype=jnp.int32)
        jb = jax_sample_batch(jax.random.PRNGKey(9), self.jgraph, s,
                              jnp.int32(B), s, FANOUTS, caps,
                              dedup_last=cfg.sampler.dedup_last)
        self.params = self.jmodel.init(
            jax.random.PRNGKey(0), tuple(reversed(jb.blocks)),
            jax_gather_features(self.jfeats, jb.frontier),
            deterministic=True)["params"]
        self.model = build_model("sage", feats.shape[1], HIDDEN,
                                 g.num_classes, 2, 0.0)
        self.model.load_state_dict(params_from_flax(self.params))


@pytest.mark.parametrize("dedup_last", [False, True])
def test_one_train_step_matches_jax(small_graph, dedup_last):
    g = small_graph
    cfg = _cfg(g.num_classes, dedup_last)
    caps = frontier_caps(B, FANOUTS)
    both = _Both(g, cfg, caps)
    seeds = g.train_ids[:B].astype(np.int32)
    labels = np.asarray(g.labels, np.int32)[seeds]

    state = jax_create_state(both.params, 0.01, seed=0)
    jfns = jax_make_step_fns(_cfg(g.num_classes, dedup_last, cm=jax_config),
                             both.jmodel, caps)
    new_state, jm = jax.jit(jfns.train_step)(
        state, both.jgraph, both.jfeats, jnp.asarray(seeds), jnp.int32(B),
        jnp.asarray(labels))
    skey, _ = jax.random.split(jax.random.fold_in(state.rng, state.step))

    tstate = create_train_state(both.model, 0.01, 0, "cpu")
    tm = make_step_fns(cfg, caps).train_step(
        tstate, both.tgraph, both.tfeats, torch.from_numpy(seeds),
        torch.tensor(B, dtype=torch.int32), torch.from_numpy(labels),
        uniforms=torch_uniforms(skey, caps, FANOUTS))

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    assert int(tm["edges"]) == int(jm["edges"])
    assert int(tm["frontier"]) == int(jm["frontier"])
    assert int(tm["cap_overflow"]) == int(jm["cap_overflow"]) == 0
    assert tstate.step == int(new_state.step) == 1
    want = params_from_flax(new_state.params)
    got = both.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)
    # the step really moved every parameter
    before = params_from_flax(both.params)
    assert all(not torch.equal(got[k], before[k]) for k in want)


def test_eval_step_matches_jax(small_graph):
    g = small_graph
    cfg = _cfg(g.num_classes)
    caps = frontier_caps(B, FANOUTS)
    both = _Both(g, cfg, caps)
    seeds = padded_seeds(g.valid_ids, 50, B)
    labels = np.where(seeds >= 0, np.asarray(g.labels)[seeds], -1).astype(
        np.int32)
    key = jax.random.PRNGKey(4)
    jcfg = _cfg(g.num_classes, cm=jax_config)
    a, b = jax.jit(jax_make_step_fns(jcfg, both.jmodel, caps).eval_step)(
        both.params, both.jgraph, both.jfeats, jnp.asarray(seeds),
        jnp.int32(50), jnp.asarray(labels), key)
    ta, tb = make_step_fns(cfg, caps).eval_step(
        both.model, both.tgraph, both.tfeats, torch.from_numpy(seeds),
        torch.tensor(50, dtype=torch.int32), torch.from_numpy(labels),
        uniforms=torch_uniforms(key, caps, FANOUTS))
    assert (int(ta), int(tb)) == (int(a), int(b))
    assert int(tb) == 50


def test_masked_softmax_ce_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((33, 7)).astype(np.float32) * 3
    labels = rng.integers(-1, 7, 33).astype(np.int32)
    mask = labels >= 0
    want = jax_masked_softmax_ce(jnp.asarray(logits), jnp.asarray(labels),
                                 jnp.asarray(mask))
    got = masked_softmax_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    empty = masked_softmax_ce(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              torch.zeros(33, dtype=torch.bool))
    assert float(empty) == 0.0


def test_sum_edge_counts_past_2_31():
    per_step = torch.full((3,), 2 ** 30 + 7, dtype=torch.int32)
    assert sum_edge_counts(per_step) == 3 * (2 ** 30 + 7)


def test_trainer_fit_learns_on_cpu(small_graph):
    cfg = _cfg(small_graph.num_classes, batch=128, dropout=0.2,
               eval_batch_size=128)
    tr = Trainer(cfg, small_graph, device="cpu")
    res = tr.fit(log=lambda s: None)
    losses = [h["mean_loss"] for h in res["history"]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert all(h["cap_overflow"] == 0 for h in res["history"])
    assert tr.state.epoch == 3 and tr.state.step == 3 * tr.plan.train_steps
    acc = tr.evaluate("valid")
    assert acc > 2.0 / small_graph.num_classes, f"acc {acc} is chance-level"
    assert res["test_acc"] > 2.0 / small_graph.num_classes


def test_trainer_cap_probe(small_graph):
    cfg = _cfg(small_graph.num_classes, probe_caps_min_cap=0)
    tr = Trainer(cfg, small_graph, device="cpu")
    loose = frontier_caps(B, FANOUTS)
    assert tr.caps[0] == B and tr.caps[1] <= loose[1]
    assert tr.caps[-1] == tr.caps[-2] * (1 + FANOUTS[-1])
    assert tr.train_one_epoch(0)["cap_overflow"] == 0


def test_cap_overflow_metric_fires(small_graph):
    """Deliberately undersized hop-1 caps must be reported."""
    g = small_graph
    cfg = _cfg(g.num_classes)
    caps = (B, B + 16, (B + 16) * (1 + FANOUTS[-1]))
    model = build_model("sage", g.features.shape[1], HIDDEN, g.num_classes,
                        2, 0.0)
    state = create_train_state(model, 0.01, 0, "cpu")
    seeds = torch.arange(B, dtype=torch.int32)
    m = make_step_fns(cfg, caps).train_step(
        state, DeviceGraph.from_host(g.indptr, g.indices, "cpu"),
        torch.from_numpy(np.asarray(g.features, np.float32)), seeds,
        torch.tensor(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32))
    assert int(m["cap_overflow"]) > 0


# -- the Trainer's epoch against legion_tpu's, with its key schedule ---------

def _ref_epoch(g, cfg, num_shards=1, shard=0):
    """The reference Trainer's first epoch and validation pass on ``shard``:
    its initial and final params, its epoch record, its valid accuracy,
    and the uniforms its key schedule draws (train: ``fold_in(rng,
    step)`` split into the sampling key; eval: ``split(PRNGKey(12345),
    steps)``), as ``uniforms(step, hop)`` callables for the port."""
    from legion_tpu.train.loop import Trainer as JaxTrainer
    jtr = JaxTrainer(cfg, g, num_shards=num_shards)
    params0 = jax.tree_util.tree_map(np.array, jtr.state.params)
    train_u = []
    for s in range(jtr.plan.train_steps):
        skey, _ = jax.random.split(jax.random.fold_in(jtr.state.rng, s))
        train_u.append(torch_uniforms(skey, jtr.caps, FANOUTS))
    eval_u = [torch_uniforms(k, jtr.eval_caps, FANOUTS) for k in
              jax.random.split(jax.random.PRNGKey(12345),
                               jtr.plan.valid_steps)]
    rec = jtr.train_one_epoch(0, shard)
    return dict(params0=params0, rec=rec,
                params1=params_from_flax(jtr.state.params),
                valid=jtr.evaluate("valid", shard),
                train_u=lambda s, k: train_u[s][k],
                eval_u=lambda t, k: eval_u[t][k])


def _epoch_cfg(num_classes, cm, **dataset):
    return dataclasses.replace(
        _cfg(num_classes, batch=128, cm=cm, eval_batch_size=128),
        dataset=cm.DatasetConfig(num_classes=num_classes, **dataset))


@pytest.fixture(scope="module")
def ref_epoch(small_graph):
    return _ref_epoch(small_graph, _epoch_cfg(small_graph.num_classes,
                                              jax_config))


def _assert_epoch_matches(tr, ref, shard=0):
    """The port's Trainer, from the reference's initial params and with
    its uniforms, against the reference's epoch: last and mean loss within
    rtol 1e-4 / atol 1e-5, every param after the epoch within 1e-4
    absolute (Adam's first steps divide by |g| + eps), valid accuracy
    equal."""
    tr.model.load_state_dict(params_from_flax(ref["params0"]))
    rec = tr.train_one_epoch(0, shard, uniforms=ref["train_u"])
    for k in ("loss", "mean_loss"):
        np.testing.assert_allclose(rec[k], ref["rec"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    got = tr.model.state_dict()
    for k, want in ref["params1"].items():
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
    valid = tr.evaluate("valid", shard, uniforms=ref["eval_u"])
    assert valid == pytest.approx(ref["valid"], abs=1e-6)
    return rec


@pytest.mark.parametrize("what", ["profile_dir", "num_shards"])
def test_trainer_rejects_unported_settings(small_graph, tmp_path, ref_epoch,
                                           what):
    """Both settings now run as in the reference. ``profile_dir``: epoch 0
    under torch.profiler writes its trace into the directory and trains
    as the reference's Trainer does (which the profiler does not change).
    ``num_shards=2``: shard 1's epoch and validation on one device, with
    no collective, against the reference's ``Trainer(num_shards=2)`` on
    shard 1. (The name dates from when both were refused.)"""
    g = small_graph
    if what == "profile_dir":
        prof = tmp_path / "prof"
        cfg = _epoch_cfg(g.num_classes, port_config)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, profile_dir=str(prof)))
        _assert_epoch_matches(Trainer(cfg, g, device="cpu"), ref_epoch)
        assert [p.name for p in prof.iterdir()] == ["epoch_0.pt.trace.json"]
        assert "traceEvents" in json.loads(
            (prof / "epoch_0.pt.trace.json").read_text())
    else:
        ref = _ref_epoch(g, _epoch_cfg(g.num_classes, jax_config),
                         num_shards=2, shard=1)
        tr = Trainer(_epoch_cfg(g.num_classes, port_config), g,
                     device="cpu", num_shards=2)
        assert tr.plan.train_steps == (
            min(len(s) for s in tr.shards_train) - 1) // 128
        _assert_epoch_matches(tr, ref, shard=1)


@pytest.mark.parametrize("placement,enabled", [("host", False),
                                               ("host", True),
                                               ("hbm", True)])
def test_trainer_points_host_features_at_the_cached_driver(
        small_graph, ref_epoch, placement, enabled):
    """With the cache off any placement trains the whole table on the
    device, as the reference's Trainer (which reads neither field) does
    with the same config; the cache on still goes to the cached driver
    (the dispatch never sends it here)."""
    cfg = dataclasses.replace(
        _epoch_cfg(small_graph.num_classes, port_config,
                   feature_placement=placement),
        cache=port_config.CacheConfig(enabled=enabled))
    if enabled:
        with pytest.raises(ValueError, match="run_cached_training"):
            Trainer(cfg, small_graph, device="cpu")
    else:
        _assert_epoch_matches(Trainer(cfg, small_graph, device="cpu"),
                              ref_epoch)


def test_trainer_runs_hbm_sharded_at_one_device(small_graph, ref_epoch):
    """``train.py --features hbm_sharded --devices 1`` runs the reference's
    Trainer on the whole table; so does the port's."""
    cfg = _epoch_cfg(small_graph.num_classes, port_config,
                     feature_placement="hbm_sharded")
    rec = _assert_epoch_matches(Trainer(cfg, small_graph, device="cpu"),
                                ref_epoch)
    assert rec["cap_overflow"] == 0
