"""Port parity: GCN and LP-SAGE of legion_tpu_torch against legion_tpu on
the CPU, from the same numpy-seeded inputs, with the flax params carried
over by ``params_from_flax``.

* block degrees exactly, ``block_sddmm`` at 1e-5;
* GCN forward: float32 within 1e-4 x max|logit| (two float32
  formulations that sum and scale in different orders); bfloat16 at 5e-2,
  a few bf16 ulps of logits of magnitude ~1, since the port's kernels sum
  in float32 and round once where the reference sums in bf16; a dst row
  with no sampled neighbor is exactly the bias in both;
* LP losses at 1e-6, the pair count exactly;
* one train step of each arch in float32 with dropout 0 and the
  reference's uniforms: loss at 1e-5, params after Adam at 1e-4 absolute
  (Adam's first step divides g by |g| + eps, as in
  tests/test_torch_train.py);
* both archs through ``Trainer`` and ``run_cached_training`` on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legion_tpu import config as jax_config
from legion_tpu.models import build_model as jax_build_model
from legion_tpu.ops import segment as jax_segment
from legion_tpu.sampling.block import Block as JaxBlock
from legion_tpu.sampling.sampler import DeviceGraph as JaxDeviceGraph
from legion_tpu.sampling.sampler import gather_features as jax_gather_features
from legion_tpu.sampling.sampler import sample_batch as jax_sample_batch
from legion_tpu.train import loop as jax_loop
from legion_tpu.train.train_state import create_train_state as jax_create_state
from legion_tpu_torch import config as port_config
from legion_tpu_torch.models import build_model
from legion_tpu_torch.models.convert import params_from_flax
from legion_tpu_torch.ops.segment import (block_dst_degree, block_sddmm,
                                          block_src_out_degree)
from legion_tpu_torch.sampling.block import Block, frontier_caps
from legion_tpu_torch.sampling.sampler import DeviceGraph
from legion_tpu_torch.train.cached_driver import run_cached_training
from legion_tpu_torch.train.loop import (Trainer, lp_logsigmoid_loss,
                                         lp_logsigmoid_sum, make_step_fns)
from legion_tpu_torch.train.train_state import create_train_state
from tests.test_torch_sampler import (padded_seeds, to_torch_batch,
                                      torch_uniforms)

torch.set_num_threads(2)

B, FANOUTS, CLASSES = 63, (5, 3), 7          # 63: three thirds of 21 pairs
CAPS = frontier_caps(B, FANOUTS)


# -- block degrees and sddmm --------------------------------------------------

def _blocks(identity, past_rows=True, seed=8, p=40, f=6, s=400):
    rng = np.random.default_rng(seed)
    mask = rng.random((p, f)) > 0.35
    mask[3] = False
    if identity:
        off = s - p * f
        pos = (off + np.arange(p * f).reshape(p, f)).astype(np.int32)
    else:
        off = None
        pos = np.where(mask, rng.integers(0, s, (p, f)), 0).astype(np.int32)
        if past_rows:       # a valid slot past the rows: dropped
            pos[5, 1], mask[5, 1] = s + 9, True
    jblk = JaxBlock(nbr_pos=jnp.asarray(pos), nbr_mask=jnp.asarray(mask),
                    num_src=jnp.int32(s), num_dst=jnp.int32(p),
                    identity_offset=off)
    blk = Block(nbr_pos=torch.from_numpy(pos), nbr_mask=torch.from_numpy(mask),
                num_src=torch.tensor(s, dtype=torch.int32),
                num_dst=torch.tensor(p, dtype=torch.int32),
                identity_offset=off)
    return jblk, blk, s


@pytest.mark.parametrize("identity", [False, True])
def test_block_degrees_match_jax(identity):
    jblk, blk, s = _blocks(identity)
    dst = block_dst_degree(blk)
    src = block_src_out_degree(blk, s)
    assert dst.dtype == src.dtype == torch.int32
    np.testing.assert_array_equal(
        dst.numpy(), np.asarray(jax_segment.block_dst_degree(jblk)))
    np.testing.assert_array_equal(
        src.numpy(), np.asarray(jax_segment.block_src_out_degree(jblk, s)))
    # the slot past the rows counts for its dst and for no src
    assert int(src.sum()) == int(dst.sum()) - (0 if identity else 1)
    if identity:
        with pytest.raises(ValueError, match="src_cap"):
            block_src_out_degree(blk, s + 1)


@pytest.mark.parametrize("identity", [False, True])
def test_block_sddmm_matches_jax(identity):
    jblk, blk, s = _blocks(identity, past_rows=False)
    rng = np.random.default_rng(2)
    h_src = rng.standard_normal((s, 12)).astype(np.float32)
    h_dst = rng.standard_normal((48, 12)).astype(np.float32)
    want = np.asarray(jax_segment.block_sddmm(jnp.asarray(h_dst),
                                              jnp.asarray(h_src), jblk))
    got = block_sddmm(torch.from_numpy(h_dst), torch.from_numpy(h_src), blk)
    assert got.dtype == torch.float32 and got.shape == blk.nbr_mask.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got[~blk.nbr_mask] == 0).all()


# -- models -------------------------------------------------------------------

def _with_random_bias(params, seed=3):
    """flax GCN params with the (zero-initialised) biases made random, so
    that a bias that is dropped or added twice shows."""
    rng = np.random.default_rng(seed)
    return {name: {"dense": {"kernel": np.asarray(layer["dense"]["kernel"])},
                   "bias": rng.standard_normal(
                       np.shape(layer["bias"])).astype(np.float32)}
            for name, layer in params.items()}


def _flax_and_port(g, arch, dedup_last, hidden, dtype, n_valid=60):
    seeds = padded_seeds(g.train_ids, n_valid, B)
    jb = jax_sample_batch(
        jax.random.PRNGKey(0), JaxDeviceGraph.from_host(g.indptr, g.indices),
        jnp.asarray(seeds), jnp.int32(n_valid), jnp.zeros(B, jnp.int32),
        FANOUTS, CAPS, dedup_last=dedup_last)
    feats = np.asarray(g.features, np.float32)
    x = jax_gather_features(jnp.asarray(feats), jb.frontier)
    jblocks = tuple(reversed(jb.blocks))
    jmodel = jax_build_model(arch, hidden, CLASSES, 2, 0.5, dtype=dtype)
    params = jmodel.init(jax.random.PRNGKey(1), jblocks, x,
                         deterministic=True)["params"]
    if arch == "gcn":
        params = _with_random_bias(params)
    want = np.asarray(jmodel.apply({"params": params}, jblocks, x,
                                   deterministic=True).astype(jnp.float32))
    model = build_model(arch, feats.shape[1], hidden, CLASSES, 2, 0.5,
                        dtype=dtype)
    model.load_state_dict(params_from_flax(params))      # strict: same keys
    blocks = tuple(reversed(to_torch_batch(jb).blocks))
    return model, blocks, torch.from_numpy(np.array(x)), want, params


@pytest.mark.parametrize("dedup_last,hidden", [
    (False, 16),   # identity layer 0 (K5), narrowing gathered layer 1 (K2)
    (True, 16),    # narrowing gathered layer 0 on raw features (K2 "sum")
    (True, 64),    # widening gathered layer 0: dense(fanout_gather_sum)
])
def test_gcn_matches_flax_f32(small_graph, dedup_last, hidden):
    model, blocks, x, want, params = _flax_and_port(
        small_graph, "gcn", dedup_last, hidden, "float32")
    got = model(blocks, x, deterministic=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # the padded seeds have no sampled neighbor: exactly the bias
    bias = params["layer_1"]["bias"]
    assert (want[60:B] == bias).all()
    assert (got.detach().numpy()[60:B] == bias).all()


@pytest.mark.parametrize("dedup_last", [False, True])
def test_gcn_matches_flax_bf16(small_graph, dedup_last):
    model, blocks, x, want, params = _flax_and_port(
        small_graph, "gcn", dedup_last, 16, "bfloat16")
    got = model(blocks, x, deterministic=True)
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got.float().detach().numpy(), want,
                               rtol=5e-2, atol=5e-2)
    bias = torch.from_numpy(params["layer_1"]["bias"]).to(torch.bfloat16)
    assert torch.equal(got[60:B], bias.expand(B - 60, -1))


def test_gcn_dropout_comes_before_every_layer_but_the_first(small_graph):
    """Layer 0 sees the features undropped and layer 1 a dropped input:
    with rate 1 the logits are exactly layer 1's bias."""
    model, blocks, x, _, params = _flax_and_port(small_graph, "gcn", False,
                                                 16, "float32")
    with pytest.raises(ValueError, match="generator"):
        model(blocks, x, deterministic=False)
    gen = torch.Generator().manual_seed(3)
    a = model(blocks, x, deterministic=False, generator=gen)
    assert not torch.equal(a, model(blocks, x, deterministic=True))
    model.dropout = 1.0
    out = model(blocks, x, deterministic=False, generator=gen)
    bias = torch.from_numpy(params["layer_1"]["bias"])
    assert torch.equal(out.detach(), bias.expand_as(out))


def test_lp_sage_is_the_sage_encoder(small_graph):
    model, blocks, x, want, _ = _flax_and_port(small_graph, "lp_sage", False,
                                               16, "float32")
    got = model(blocks, x, deterministic=True)
    assert got.shape == want.shape == (CAPS[0], 16)      # hidden, not classes
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_build_model_and_convert_reject_the_unknown():
    with pytest.raises(ValueError, match="unknown arch"):
        build_model("gin", 16, 8, 3, 2, 0.0)
    with pytest.raises(ValueError, match="param group"):
        params_from_flax({"head": {}})
    with pytest.raises(ValueError, match="param groups"):
        params_from_flax({"layer_0": {"attn": {}}})


def test_gcn_params_layout_and_init():
    """flax kernels are (in, out), nn.Linear weights (out, in); the dense
    has no bias of its own; the init is seeded lecun-normal with a zero
    bias."""
    rng = np.random.default_rng(0)
    flax_params = {f"layer_{i}": {"dense": {"kernel": rng.standard_normal(
        (a, o))}, "bias": rng.standard_normal(o)}
        for i, (a, o) in enumerate([(12, 8), (8, 3)])}
    model = build_model("gcn", 12, 8, 3, 2, 0.0)
    model.load_state_dict(params_from_flax(flax_params))
    np.testing.assert_array_equal(
        model.layers[1].dense.weight.detach().numpy(),
        flax_params["layer_1"]["dense"]["kernel"].T.astype(np.float32))
    assert model.layers[0].dense.bias is None
    a, b = (build_model("gcn", 128, 256, 47, 2, 0.5,
                        generator=torch.Generator().manual_seed(0))
            for _ in range(2))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.layers[0].dense.weight.detach()
    assert abs(float(w.std()) - (1 / 128) ** 0.5) < 0.01
    assert (a.layers[0].bias == 0).all()


# -- LP losses ----------------------------------------------------------------

def test_lp_losses_match_jax():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((14, 8)).astype(np.float32) * 2   # 14: ragged
    mask = rng.random(14) > 0.2
    js, jc = jax_loop.lp_logsigmoid_sum(jnp.asarray(emb), jnp.asarray(mask))
    s, c = lp_logsigmoid_sum(torch.from_numpy(emb), torch.from_numpy(mask))
    assert c.dtype == torch.int32 and int(c) == int(jc)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    np.testing.assert_allclose(
        float(lp_logsigmoid_loss(torch.from_numpy(emb),
                                 torch.from_numpy(mask))),
        float(jax_loop.lp_logsigmoid_loss(jnp.asarray(emb),
                                          jnp.asarray(mask))), rtol=1e-6)
    # bf16 embeddings reduce in float32
    eb = torch.from_numpy(emb).to(torch.bfloat16)
    sb, _ = lp_logsigmoid_sum(eb, torch.from_numpy(mask))
    assert sb.dtype == torch.float32
    np.testing.assert_allclose(
        float(sb), float(lp_logsigmoid_sum(eb.float(),
                                           torch.from_numpy(mask))[0]),
        rtol=1e-6)


def test_lp_eval_is_pair_weighted():
    """The port's counterpart of tests/test_train.py's test of this name:
    eval aggregates (pair-loss sum, pair count), so a 1-pair batch weighs
    as one pair and an empty batch as nothing; same values as JAX."""
    rng = np.random.default_rng(0)
    emb_full = rng.normal(size=(12, 8)).astype(np.float32)
    emb_part = rng.normal(size=(12, 8)).astype(np.float32)
    m_full = np.ones(12, bool)
    m_part = np.array(([True] + [False] * 3) * 3)          # 1 valid pair
    t = torch.from_numpy
    s1, c1 = lp_logsigmoid_sum(t(emb_full), t(m_full))
    s2, c2 = lp_logsigmoid_sum(t(emb_part), t(m_part))
    assert int(c1) == 4 and int(c2) == 1
    for (s, c), (e, m) in (((s1, c1), (emb_full, m_full)),
                           ((s2, c2), (emb_part, m_part))):
        js, jc = jax_loop.lp_logsigmoid_sum(jnp.asarray(e), jnp.asarray(m))
        np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
        assert int(c) == int(jc)
    np.testing.assert_allclose(
        float(lp_logsigmoid_loss(t(emb_full), t(m_full))), float(s1) / 4,
        rtol=1e-6)
    agg = (float(s1) + float(s2)) / (int(c1) + int(c2))
    per_step = (float(s1) / 4 + float(s2) / 1) / 2
    assert not np.isclose(agg, per_step)
    s0, c0 = lp_logsigmoid_sum(t(emb_full), torch.zeros(12, dtype=torch.bool))
    assert float(s0) == 0.0 and int(c0) == 0
    assert float(lp_logsigmoid_loss(t(emb_full),
                                    torch.zeros(12, dtype=torch.bool))) == 0.0


# -- one step -----------------------------------------------------------------

def _cfg(arch, cm=port_config, dedup_last=False, hidden=16, **train):
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=CLASSES),
        sampler=cm.SamplerConfig(fanouts=FANOUTS, batch_size=B,
                                 eval_batch_size=B, dedup_last=dedup_last),
        model=cm.ModelConfig(arch=arch, hidden_dim=hidden, num_layers=2,
                             dropout=0.0),
        train=cm.TrainConfig(learning_rate=0.01, seed=0,
                             **{"epochs": 2, **train}))


class _Both:
    """legion_tpu and the port on the same graph, params and caps."""

    def __init__(self, g, arch, dedup_last):
        feats = np.asarray(g.features, np.float32)
        self.jgraph = JaxDeviceGraph.from_host(g.indptr, g.indices)
        self.jfeats = jnp.asarray(feats)
        self.tgraph = DeviceGraph.from_host(g.indptr, g.indices, "cpu")
        self.tfeats = torch.from_numpy(feats)
        self.jmodel = jax_build_model(arch, 16, CLASSES, 2, 0.0)
        s = jnp.arange(B, dtype=jnp.int32)
        jb = jax_sample_batch(jax.random.PRNGKey(9), self.jgraph, s,
                              jnp.int32(B), s, FANOUTS, CAPS,
                              dedup_last=dedup_last)
        self.params = self.jmodel.init(
            jax.random.PRNGKey(0), tuple(reversed(jb.blocks)),
            jax_gather_features(self.jfeats, jb.frontier),
            deterministic=True)["params"]
        self.model = build_model(arch, feats.shape[1], 16, CLASSES, 2, 0.0)
        self.model.load_state_dict(params_from_flax(self.params))


@pytest.mark.parametrize("arch,dedup_last", [("gcn", False), ("gcn", True),
                                             ("lp_sage", False)])
def test_one_train_step_matches_jax(small_graph, arch, dedup_last):
    g = small_graph
    both = _Both(g, arch, dedup_last)
    seeds = g.train_ids[:B].astype(np.int32)
    labels = np.asarray(g.labels, np.int32)[seeds]
    state = jax_create_state(both.params, 0.01, seed=0)
    jfns = jax_loop.make_step_fns(_cfg(arch, jax_config, dedup_last),
                                  both.jmodel, CAPS)
    new_state, jm = jax.jit(jfns.train_step)(
        state, both.jgraph, both.jfeats, jnp.asarray(seeds), jnp.int32(B),
        jnp.asarray(labels))
    skey, _ = jax.random.split(jax.random.fold_in(state.rng, state.step))

    tstate = create_train_state(both.model, 0.01, 0, "cpu")
    tm = make_step_fns(_cfg(arch, dedup_last=dedup_last), CAPS).train_step(
        tstate, both.tgraph, both.tfeats, torch.from_numpy(seeds),
        torch.tensor(B, dtype=torch.int32), torch.from_numpy(labels),
        uniforms=torch_uniforms(skey, CAPS, FANOUTS))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    assert int(tm["edges"]) == int(jm["edges"])
    assert int(tm["cap_overflow"]) == int(jm["cap_overflow"]) == 0
    want = params_from_flax(new_state.params)
    got = both.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
    before = params_from_flax(both.params)
    assert all(not torch.equal(got[k], before[k]) for k in want)


def test_lp_eval_step_matches_jax(small_graph):
    """(LP loss sum, valid pairs) of a padded eval batch: 50 valid seeds
    of 63 leave 8 whole pairs."""
    g = small_graph
    both = _Both(g, "lp_sage", False)
    seeds = padded_seeds(g.valid_ids, 50, B)
    labels = np.zeros(B, np.int32)
    key = jax.random.PRNGKey(4)
    a, b = jax.jit(jax_loop.make_step_fns(
        _cfg("lp_sage", jax_config), both.jmodel, CAPS).eval_step)(
        both.params, both.jgraph, both.jfeats, jnp.asarray(seeds),
        jnp.int32(50), jnp.asarray(labels), key)
    ta, tb = make_step_fns(_cfg("lp_sage"), CAPS).eval_step(
        both.model, both.tgraph, both.tfeats, torch.from_numpy(seeds),
        torch.tensor(50, dtype=torch.int32), torch.from_numpy(labels),
        uniforms=torch_uniforms(key, CAPS, FANOUTS))
    assert int(tb) == int(b) == 8
    np.testing.assert_allclose(float(ta), float(a), rtol=1e-5)


# -- the drivers --------------------------------------------------------------

def _check_lp(history, logs, valid):
    """tests/test_lp_trainers.py's checks: a finite loss that does not
    rise, an eval LP loss on the train loss's scale, and the LP label."""
    loss = [h["loss"] for h in history]
    assert np.isfinite(loss).all() and loss[-1] < loss[0] * 1.2
    assert np.isfinite(valid) and valid > loss[-1] * 0.2
    assert any("Val LP-loss" in s for s in logs), logs[-3:]
    assert not any("Val Acc" in s for s in logs)
    assert any("LP-loss on test data" in s for s in logs)


def _cached(cfg):
    return dataclasses.replace(
        cfg, dataset=dataclasses.replace(cfg.dataset,
                                         feature_placement="host"),
        sampler=dataclasses.replace(cfg.sampler, probe_caps=False),
        cache=port_config.CacheConfig(enabled=True, budget_bytes=64 << 10,
                                      presample_steps=2))


def test_lp_sage_through_the_trainer(small_graph):
    logs = []
    tr = Trainer(_cfg("lp_sage"), small_graph, device="cpu")
    out = tr.fit(log=logs.append)
    _check_lp(out["history"], logs, tr.evaluate("valid"))


def test_lp_sage_through_the_cached_driver(small_graph):
    logs = []
    out = run_cached_training(_cached(_cfg("lp_sage")), small_graph, "cpu",
                              log=logs.append)
    _check_lp(out["history"], logs, out["history"][-1]["valid"])
    assert 0.0 < out["history"][-1]["cache_hit_rate"] < 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_through_the_trainer(small_graph, dtype):
    """GCN has no self-feature path, so this graph's planted labels leave
    it near chance: it is judged by a falling loss."""
    cfg = _cfg("gcn", epochs=3)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=dtype, dropout=0.2))
    logs = []
    res = Trainer(cfg, small_graph, device="cpu").fit(log=logs.append)
    losses = [h["mean_loss"] for h in res["history"]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert all(h["cap_overflow"] == 0 for h in res["history"])
    assert 0.0 <= res["test_acc"] <= 1.0
    assert any("Val Acc" in s for s in logs)
    assert logs[-1].startswith("Accuracy on test data")


def test_gcn_through_the_cached_driver(small_graph):
    cfg = _cached(_cfg("gcn", dedup_last=True, epochs=3))
    res = run_cached_training(cfg, small_graph, "cpu", log=lambda s: None)
    losses = [np.mean(h["losses"]) for h in res["history"]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert 0.0 <= res["test_acc"] <= 1.0
