"""Port parity: the port's numpy copies of the reference's configuration,
graph container and synthetic generators (``legion_tpu_torch.config``,
``legion_tpu_torch.data``) against the originals. Each ported field keeps
its name and default, and each generator gives the same arrays for the
same arguments, so the port needs nothing of the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

from legion_tpu import config as jax_config
from legion_tpu.data import format as jax_format
from legion_tpu.data import synthetic as jax_synthetic
from legion_tpu_torch import config as port_config
from legion_tpu_torch.data import format as port_format
from legion_tpu_torch.data import synthetic as port_synthetic

torch.set_num_threads(2)

GRAPH_FIELDS = ("indptr", "indices", "features", "labels", "train_ids",
                "valid_ids", "test_ids")


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
        else:
            out[f.name] = f.default
    return out


@pytest.mark.parametrize("name", ["DatasetConfig", "SamplerConfig",
                                  "ModelConfig", "TrainConfig"])
def test_config_sections_match_reference(name):
    port, ref = (_defaults(getattr(port_config, name)),
                  _defaults(getattr(jax_config, name)))
    assert port == {k: ref[k] for k in port}, "a field's default differs"
    assert getattr(port_config, name).__dataclass_params__.frozen


def test_config_holds_the_ported_fields():
    """The fields the port acts on; the rest of the reference's are left
    out, so setting one fails instead of being ignored."""
    cfg = port_config.Config()
    got = {f.name: sorted(_defaults(type(getattr(cfg, f.name))))
           for f in dataclasses.fields(cfg)}
    assert got == {
        "dataset": ["feature_pad_align", "num_classes"],
        "sampler": sorted(_defaults(jax_config.SamplerConfig)),
        "model": sorted(_defaults(jax_config.ModelConfig)),
        "train": ["checkpoint_dir", "epochs", "learning_rate",
                  "profile_dir", "seed"]}
    with pytest.raises(TypeError):
        port_config.TrainConfig(scan_unroll=2)


def _assert_same_graph(got, want):
    for name in GRAPH_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.num_nodes, got.num_edges, got.feature_dim,
            got.num_classes) == (want.num_nodes, want.num_edges,
                                 want.feature_dim, want.num_classes)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_power_law_graph_matches_reference(seed):
    kw = dict(num_nodes=600, avg_degree=7, feature_dim=12, num_classes=5,
              seed=seed)
    _assert_same_graph(port_synthetic.random_power_law_graph(**kw),
                       jax_synthetic.random_power_law_graph(**kw))


@pytest.mark.parametrize("seed", [0, 5])
def test_bench_graph_matches_reference(seed):
    kw = dict(num_nodes=3000, avg_degree=9, feature_dim=10, num_classes=7,
              seed=seed)
    _assert_same_graph(port_synthetic.bench_graph(**kw),
                       jax_synthetic.bench_graph(**kw))


def test_from_coo_and_pad_match_reference():
    rng = np.random.default_rng(2)
    n, e = 50, 300
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    args = (src, dst, n, rng.standard_normal((n, 6)).astype(np.float32),
            rng.integers(0, 3, n), np.arange(20), np.arange(20, 30),
            np.arange(30, 50))
    _assert_same_graph(port_format.from_coo(*args),
                       jax_format.from_coo(*args))
    feats = args[3]
    for align in (1, 4, 128):
        np.testing.assert_array_equal(
            port_format.pad_feature_dim(feats, align),
            jax_format.pad_feature_dim(feats, align))
