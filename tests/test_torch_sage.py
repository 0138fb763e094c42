"""Port parity: legion_tpu_torch's SAGE against legion_tpu's flax SAGE on
the same sampled blocks, with the flax params carried over by
``params_from_flax``. float32 agrees at 1e-5 (two float32 formulations
of the same sums and products); bfloat16 at 5e-2, a few bf16 ulps of
logits of magnitude ~1, since the two frameworks round to bf16 at
different points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legion_tpu.models import build_model as jax_build_model
from legion_tpu.sampling.sampler import DeviceGraph as JaxDeviceGraph
from legion_tpu.sampling.sampler import gather_features as jax_gather_features
from legion_tpu.sampling.sampler import sample_batch as jax_sample_batch
from legion_tpu_torch.models import build_model
from legion_tpu_torch.models.convert import params_from_flax
from legion_tpu_torch.ops.act_dropout import dropout
from legion_tpu_torch.sampling.block import frontier_caps
from tests.test_torch_sampler import padded_seeds, to_torch_batch

torch.set_num_threads(2)

NUM_CLASSES = 7


def _flax_and_port(small_graph, dedup_last, hidden, dtype):
    b, fanouts = 64, (5, 3)
    caps = frontier_caps(b, fanouts)
    seeds = padded_seeds(small_graph.train_ids, 60, b)
    jb = jax_sample_batch(
        jax.random.PRNGKey(0),
        JaxDeviceGraph.from_host(small_graph.indptr, small_graph.indices),
        jnp.asarray(seeds), jnp.int32(60), jnp.zeros(b, jnp.int32), fanouts,
        caps, dedup_last=dedup_last)
    feats = np.asarray(small_graph.features, np.float32)
    x = jax_gather_features(jnp.asarray(feats), jb.frontier)
    jblocks = tuple(reversed(jb.blocks))
    jmodel = jax_build_model("sage", hidden, NUM_CLASSES, 2, 0.5, dtype=dtype)
    params = jmodel.init(jax.random.PRNGKey(1), jblocks, x,
                         deterministic=True)["params"]
    want = np.asarray(jmodel.apply({"params": params}, jblocks, x,
                                   deterministic=True).astype(jnp.float32))
    model = build_model("sage", feats.shape[1], hidden, NUM_CLASSES, 2, 0.5,
                        dtype=dtype)
    model.load_state_dict(params_from_flax(params))
    tb = to_torch_batch(jb)
    xt = torch.from_numpy(np.array(x))
    return model, tuple(reversed(tb.blocks)), xt, want


@pytest.mark.parametrize("dedup_last,hidden", [
    (False, 16),   # identity layer 0 (K1), narrowing gathered layer 1 (K2)
    (True, 16),    # narrowing gathered layer 0 on raw features (K2)
    (True, 64),    # widening gathered layer 0: the plain-mean branch
])
def test_sage_matches_flax_f32(small_graph, dedup_last, hidden):
    model, blocks, x, want = _flax_and_port(small_graph, dedup_last, hidden,
                                            "float32")
    got = model(blocks, x, deterministic=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dedup_last", [False, True])
def test_sage_matches_flax_bf16(small_graph, dedup_last):
    model, blocks, x, want = _flax_and_port(small_graph, dedup_last, 16,
                                            "bfloat16")
    got = model(blocks, x, deterministic=True)
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got.float().detach().numpy(), want,
                               rtol=5e-2, atol=5e-2)


def test_params_from_flax_layout():
    """flax kernels are (in, out); nn.Linear weights are (out, in), and
    fc_neigh has no bias."""
    rng = np.random.default_rng(0)
    flax_params = {
        f"layer_{i}": {
            "fc_self": {"kernel": rng.standard_normal((a, o)),
                        "bias": rng.standard_normal(o)},
            "fc_neigh": {"kernel": rng.standard_normal((a, o))}}
        for i, (a, o) in enumerate([(12, 8), (8, 3)])}
    sd = params_from_flax(flax_params)
    model = build_model("sage", 12, 8, 3, 2, 0.0)
    model.load_state_dict(sd)                      # strict: same keys
    np.testing.assert_array_equal(
        model.layers[1].fc_neigh.weight.detach().numpy(),
        flax_params["layer_1"]["fc_neigh"]["kernel"].T.astype(np.float32))
    assert model.layers[0].fc_neigh.bias is None


def test_init_is_seeded_lecun_normal():
    a = build_model("sage", 128, 256, 47, 2, 0.5,
                    generator=torch.Generator().manual_seed(0))
    b = build_model("sage", 128, 256, 47, 2, 0.5,
                    generator=torch.Generator().manual_seed(0))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.layers[0].fc_self.weight.detach()
    assert abs(float(w.std()) - (1 / 128) ** 0.5) < 0.01
    assert float(w.abs().max()) <= 2 * (1 / 128) ** 0.5 / 0.8796 + 1e-6
    assert (a.layers[0].fc_self.bias == 0).all()


def test_dropout_semantics():
    h = torch.ones(200, 100)
    out = dropout(h, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))
    again = dropout(h, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert (dropout(h, 1.0, torch.Generator()) == 0).all()


def test_dropout_needs_a_generator(small_graph):
    model, blocks, x, _ = _flax_and_port(small_graph, False, 16, "float32")
    with pytest.raises(ValueError, match="generator"):
        model(blocks, x, deterministic=False)
    a = model(blocks, x, deterministic=False,
              generator=torch.Generator().manual_seed(3))
    b = model(blocks, x, deterministic=True)
    assert not torch.equal(a, b)


# -- the coo_segment aggregator (the bench's baseline) ------------------------

def _coo_flax_and_port(small_graph, dedup_last, dtype):
    """legion_tpu's SAGE(agg="coo_segment") and the port's on one sampled
    batch, the port's weights carried over from the reference's."""
    from legion_tpu.models.sage import SAGE as JaxSAGE
    from legion_tpu_torch.models.sage import SAGE
    b, fanouts = 64, (5, 3)
    caps = frontier_caps(b, fanouts)
    seeds = padded_seeds(small_graph.train_ids, 60, b)
    jb = jax_sample_batch(
        jax.random.PRNGKey(0),
        JaxDeviceGraph.from_host(small_graph.indptr, small_graph.indices),
        jnp.asarray(seeds), jnp.int32(60), jnp.zeros(b, jnp.int32), fanouts,
        caps, dedup_last=dedup_last)
    feats = np.asarray(small_graph.features, np.float32)
    x = jax_gather_features(jnp.asarray(feats), jb.frontier)
    jblocks = tuple(reversed(jb.blocks))
    jmodel = JaxSAGE(hidden_dim=16, out_dim=NUM_CLASSES, num_layers=2,
                     dropout=0.5, agg="coo_segment", dtype=jnp.dtype(dtype))
    params = jmodel.init(jax.random.PRNGKey(1), jblocks, x,
                         deterministic=True)["params"]
    want = np.asarray(jmodel.apply({"params": params}, jblocks, x,
                                   deterministic=True).astype(jnp.float32))
    model = SAGE(feats.shape[1], 16, NUM_CLASSES, 2, 0.5,
                 dtype=getattr(torch, dtype), agg="coo_segment")
    model.load_state_dict(params_from_flax(params))
    tb = to_torch_batch(jb)
    return model, tuple(reversed(tb.blocks)), torch.from_numpy(np.array(x)), \
        want


def _assert_logits_close(got, want, dtype):
    """float32 within 1e-5; bf16 within 3e-2 x max|logit| (the two sum
    their messages in bf16 in different orders)."""
    got = np.asarray(got, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dedup_last", [False, True])
def test_sage_coo_segment_matches_flax(small_graph, dedup_last, dtype):
    model, blocks, x, want = _coo_flax_and_port(small_graph, dedup_last,
                                                dtype)
    got = model(blocks, x, deterministic=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _assert_logits_close(got.float().detach().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dedup_last", [False, True])
def test_sage_fanout_matches_coo_segment(small_graph, dedup_last, dtype):
    """The cross-check the reference's docstring names: the fanout path
    (K1 and K2's plain versions here) and the scatter baseline give the
    same logits from the same weights."""
    from legion_tpu_torch.models.sage import SAGE
    coo, blocks, x, _ = _coo_flax_and_port(small_graph, dedup_last, dtype)
    fan = SAGE(x.shape[1], 16, NUM_CLASSES, 2, 0.5,
               dtype=getattr(torch, dtype))
    fan.load_state_dict(coo.state_dict())
    want = coo(blocks, x, deterministic=True).float().detach().numpy()
    got = fan(blocks, x, deterministic=True)
    _assert_logits_close(got.float().detach().numpy(), want, dtype)


def test_sage_rejects_an_unknown_aggregator():
    from legion_tpu_torch.models.sage import SAGE
    with pytest.raises(ValueError, match="agg"):
        SAGE(8, 8, 3, agg="segment")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sage_coo_segment_train_step_matches_jax(small_graph, dtype):
    """One train step of SAGE(agg="coo_segment") from the reference's
    weights and uniforms, dropout 0: the loss within 1e-5 (float32) or
    3e-2 relative (bf16), and in float32 the parameters after Adam within
    1e-4 absolute (Adam's first step divides g by |g| + eps)."""
    from legion_tpu import config as jax_config
    from legion_tpu.models.sage import SAGE as JaxSAGE
    from legion_tpu.train import loop as jax_loop
    from legion_tpu.train.train_state import (
        create_train_state as jax_create_state)
    from legion_tpu_torch import config as port_config
    from legion_tpu_torch.models.sage import SAGE
    from legion_tpu_torch.sampling.sampler import DeviceGraph
    from legion_tpu_torch.train.loop import make_step_fns
    from legion_tpu_torch.train.train_state import create_train_state
    from tests.test_torch_sampler import torch_uniforms

    g, b, fanouts = small_graph, 63, (5, 3)
    caps = frontier_caps(b, fanouts)

    def cfg(cm):
        return cm.Config(
            dataset=cm.DatasetConfig(num_classes=NUM_CLASSES),
            sampler=cm.SamplerConfig(fanouts=fanouts, batch_size=b,
                                     eval_batch_size=b),
            model=cm.ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                                 dropout=0.0, dtype=dtype),
            train=cm.TrainConfig(learning_rate=0.01, seed=0))

    feats = np.asarray(g.features, np.float32)
    jgraph = JaxDeviceGraph.from_host(g.indptr, g.indices)
    jfeats = jnp.asarray(feats)
    seeds = g.train_ids[:b].astype(np.int32)
    labels = np.asarray(g.labels, np.int32)[seeds]
    jmodel = JaxSAGE(hidden_dim=16, out_dim=NUM_CLASSES, num_layers=2,
                     dropout=0.0, agg="coo_segment", dtype=jnp.dtype(dtype))
    s = jnp.asarray(seeds)
    jb = jax_sample_batch(jax.random.PRNGKey(9), jgraph, s, jnp.int32(b),
                          s, fanouts, caps, dedup_last=False)
    params = jmodel.init(jax.random.PRNGKey(0), tuple(reversed(jb.blocks)),
                         jax_gather_features(jfeats, jb.frontier),
                         deterministic=True)["params"]
    state = jax_create_state(params, 0.01, seed=0)
    jfns = jax_loop.make_step_fns(cfg(jax_config), jmodel, caps)
    new_state, jm = jax.jit(jfns.train_step)(
        state, jgraph, jfeats, s, jnp.int32(b), jnp.asarray(labels))
    skey, _ = jax.random.split(jax.random.fold_in(state.rng, state.step))

    model = SAGE(feats.shape[1], 16, NUM_CLASSES, 2, 0.0,
                 dtype=getattr(torch, dtype), agg="coo_segment")
    model.load_state_dict(params_from_flax(params))
    tstate = create_train_state(model, 0.01, 0, "cpu")
    tm = make_step_fns(cfg(port_config), caps).train_step(
        tstate, DeviceGraph.from_host(g.indptr, g.indices, "cpu"),
        torch.from_numpy(feats), torch.from_numpy(seeds),
        torch.tensor(b, dtype=torch.int32), torch.from_numpy(labels),
        uniforms=torch_uniforms(skey, caps, fanouts))
    got, want = float(tm["loss"]), float(jm["loss"])
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        new = params_from_flax(new_state.params)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), new[k].numpy(), rtol=0,
                                       atol=1e-4, err_msg=k)
    else:
        assert abs(got - want) <= 3e-2 * abs(want)
    assert int(tm["edges"]) == int(jm["edges"])
