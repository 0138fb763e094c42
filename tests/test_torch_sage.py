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
from legion_tpu_torch.models.sage import _dropout
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
    out = _dropout(h, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))
    again = _dropout(h, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert (_dropout(h, 1.0, torch.Generator()) == 0).all()


def test_dropout_needs_a_generator(small_graph):
    model, blocks, x, _ = _flax_and_port(small_graph, False, 16, "float32")
    with pytest.raises(ValueError, match="generator"):
        model(blocks, x, deterministic=False)
    a = model(blocks, x, deterministic=False,
              generator=torch.Generator().manual_seed(3))
    b = model(blocks, x, deterministic=True)
    assert not torch.equal(a, b)
