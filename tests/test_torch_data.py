"""Port parity: the port's numpy copies of the reference's configuration,
graph container and synthetic generators (``legion_tpu_torch.config``,
``legion_tpu_torch.data``) against the originals. Each ported field keeps
its name and default, and each generator gives the same arrays for the
same arguments, so the port needs nothing of the JAX package."""

import dataclasses
import os

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
                                  "ModelConfig", "TrainConfig",
                                  "CacheConfig", "ParallelConfig"])
def test_config_sections_match_reference(name):
    port, ref = (_defaults(getattr(port_config, name)),
                  _defaults(getattr(jax_config, name)))
    # the port's own fields, at the defaults that keep the reference's
    # behaviour: GAT's heads (the reference has no GAT)
    own = {"ModelConfig": {"num_heads": 1}}.get(name, {})
    assert {k: port[k] for k in port if k not in ref} == own
    assert {k: v for k, v in port.items() if k in ref} == \
        {k: ref[k] for k in port if k in ref}, "a field's default differs"
    assert getattr(port_config, name).__dataclass_params__.frozen


def test_config_holds_the_ported_fields():
    """The reference's fields, less ``TrainConfig.scan_unroll`` (it tunes
    ``lax.scan``; the port's epoch is a Python loop) and with
    ``ModelConfig.num_heads`` (GAT, which the reference lacks): the fields
    left out before the command line and the cost model's group came in
    now construct."""
    cfg = port_config.Config()
    got = {f.name: sorted(_defaults(type(getattr(cfg, f.name))))
           for f in dataclasses.fields(cfg)}
    ref = jax_config.Config()
    want = {f.name: sorted(_defaults(type(getattr(ref, f.name))))
            for f in dataclasses.fields(ref)}
    want["train"].remove("scan_unroll")
    # and one field of the port's own: GAT's heads
    want["model"] = sorted(want["model"] + ["num_heads"])
    assert got == want
    with pytest.raises(TypeError):
        port_config.TrainConfig(scan_unroll=2)
    # the host-topology placement is a field, with the reference's
    # default and values
    assert (port_config.DatasetConfig().topology_placement
            == jax_config.DatasetConfig().topology_placement == "hbm")
    assert port_config.DatasetConfig(
        topology_placement="host").topology_placement == "host"
    assert port_config.DatasetConfig(
        name="ogbn-products").name == "ogbn-products"
    assert port_config.CacheConfig(
        cost_model_granularity=0.1).cost_model_granularity == 0.1
    assert port_config.CacheConfig(group_size=2).group_size == 2


def test_config_rejects_unported_values():
    """Every placement the reference names constructs ("hbm_sharded"
    included: the single-device drivers hold the whole table, and
    ``MeshTrainer`` refuses it only striped over more than one rank);
    a value no driver knows raises."""
    assert port_config.DatasetConfig(feature_placement="host")
    assert port_config.DatasetConfig(
        feature_placement="hbm_sharded").feature_placement == "hbm_sharded"
    with pytest.raises(ValueError, match="feature_placement"):
        port_config.DatasetConfig(feature_placement="disk")
    with pytest.raises(ValueError, match="topology_placement"):
        port_config.DatasetConfig(topology_placement="disk")


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
    got = port_format.from_coo(*args)
    np.testing.assert_array_equal(got.degrees(),
                                  jax_format.from_coo(*args).degrees())


# -- the packed on-disk format -------------------------------------------------

def _files(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("mmap", [True, False])
def test_packed_format_is_read_by_both(tmp_path, writer, mmap):
    """Each package reads the other's dataset directory, and both write
    the same bytes for the same graph."""
    g = port_synthetic.random_power_law_graph(num_nodes=300, avg_degree=5,
                                              feature_dim=6, num_classes=4)
    jg = jax_format.GraphData(**dataclasses.asdict(g))
    a, b = tmp_path / "port", tmp_path / "reference"
    port_format.save_dataset(g, str(a))
    jax_format.save_dataset(jg, str(b))
    assert _files(a) == _files(b)
    path = str(a if writer == "port" else b)
    for got in (port_format.load_dataset(path, mmap=mmap),
                jax_format.load_dataset(path, mmap=mmap)):
        _assert_same_graph(got, g)
        assert isinstance(got.features, np.memmap) == mmap


@pytest.mark.parametrize("seed,chunk_nodes", [(2, 1300), (0, 10 ** 6)])
def test_streaming_power_law_graph_writes_the_reference_files(
        tmp_path, seed, chunk_nodes):
    """Same arguments, same bytes in every file, with chunks that split
    the nodes unevenly and with one chunk."""
    kw = dict(num_nodes=5000, avg_degree=6.5, feature_dim=5, num_classes=9,
              seed=seed, train_num=300, valid_num=40, test_num=50,
              chunk_nodes=chunk_nodes, log=lambda s: None)
    a = port_synthetic.streaming_power_law_graph(str(tmp_path / "p"), **kw)
    b = jax_synthetic.streaming_power_law_graph(str(tmp_path / "r"), **kw)
    assert _files(tmp_path / "p") == _files(tmp_path / "r")
    g = port_format.load_dataset(a)
    assert g.num_nodes == 5000 and g.indices.max() < 5000
    assert len(g.train_ids) == 300 and b.endswith("r")


def test_zipf_sources_split_over_threads_changes_nothing():
    """The threaded search equals one searchsorted over all uniforms."""
    rng = np.random.default_rng(0)
    cdf = np.cumsum(np.arange(1, 1001, dtype=np.float64) ** -0.8)
    cdf /= cdf[-1]
    perm = rng.permutation(1000).astype(np.int32)
    u = rng.random(3 * (1 << 20) + 17)
    got = port_synthetic._zipf_sources(cdf, perm, u)
    np.testing.assert_array_equal(got, perm[np.searchsorted(cdf, u)])
    assert got.dtype == np.int32


@pytest.mark.parametrize("mmap", [True, False])
def test_loaded_arrays_reach_torch_without_a_host_copy(tmp_path, mmap):
    """The device graph's indices and the feature cache's host table wrap
    the loaded arrays (read-only memmaps included) without copying them
    and without a warning."""
    import warnings

    from legion_tpu_torch.cache.feature_cache import FeatureCache
    from legion_tpu_torch.sampling.sampler import DeviceGraph

    g = port_synthetic.random_power_law_graph(num_nodes=300, avg_degree=5,
                                              feature_dim=6, num_classes=4)
    port_format.save_dataset(g, str(tmp_path))
    got = port_format.load_dataset(str(tmp_path), mmap=mmap)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        graph = DeviceGraph.from_host(got.indptr, got.indices, "cpu")
        cache = FeatureCache.build(got.features, np.arange(10), 10, 16,
                                   device="cpu")
        staged = cache.stage(np.array([3, -1, 299], np.int32))
    assert graph.indices.data_ptr() == got.indices.ctypes.data
    assert cache._host.data_ptr() == got.features.ctypes.data
    np.testing.assert_array_equal(graph.indices.numpy(), g.indices)
    np.testing.assert_array_equal(
        staged.numpy(),
        np.stack([g.features[3], np.zeros(6), g.features[299]]))


def test_pa_cell_dataset_is_remade_when_its_arguments_change(tmp_path,
                                                            monkeypatch):
    """The papers100M-class cell's cached graph is reused only for the
    same generator arguments; a leftover without meta.json and a copy made
    with other arguments are removed and the graph is generated anew."""
    from legion_tpu_torch.tools import pa_cell

    cfg = pa_cell.config(epochs=2)
    assert cfg.cache.enabled and cfg.dataset.feature_placement == "host"
    assert cfg.cache.budget_bytes == 171_966_464 and cfg.train.epochs == 2
    small = dict(pa_cell.GRAPH_ARGS, num_nodes=2000, num_classes=7,
                 train_num=100, valid_num=20, test_num=20)
    monkeypatch.setattr(pa_cell, "GRAPH_ARGS", small)
    root = str(tmp_path)
    leftover = tmp_path / ".bench_cache" / "synth_pa_torch_leftover"
    leftover.mkdir(parents=True)
    quiet = dict(log=lambda s: None)

    first, gen_s, _ = pa_cell.dataset(root, **quiet)
    assert gen_s > 0 and not leftover.exists()
    assert first.num_nodes == 2000 and len(first.train_ids) == 100
    again, gen_s, _ = pa_cell.dataset(root, **quiet)
    assert gen_s == 0.0
    np.testing.assert_array_equal(again.indices, first.indices)

    monkeypatch.setattr(pa_cell, "GRAPH_ARGS", dict(small, seed=1))
    other, gen_s, _ = pa_cell.dataset(root, **quiet)
    assert gen_s > 0
    assert sorted(p.name for p in (tmp_path / ".bench_cache").iterdir()) == [
        os.path.basename(pa_cell.dataset_dir(root))]
    assert not np.array_equal(other.indices, first.indices)


# -- what the edge-partitioned path reads -------------------------------------

@pytest.mark.parametrize("seed,communities", [(1, 4), (3, 7)])
def test_streaming_communities_write_the_reference_files(tmp_path, seed,
                                                         communities):
    """Planted communities, chunks that split the nodes unevenly: the same
    bytes in every file as the reference's."""
    kw = dict(num_nodes=4000, avg_degree=6, feature_dim=4, num_classes=5,
              seed=seed, train_num=200, valid_num=30, test_num=30,
              chunk_nodes=1100, communities=communities, intra_frac=0.75,
              log=lambda s: None)
    port_synthetic.streaming_power_law_graph(str(tmp_path / "p"), **kw)
    jax_synthetic.streaming_power_law_graph(str(tmp_path / "r"), **kw)
    assert _files(tmp_path / "p") == _files(tmp_path / "r")


@pytest.mark.parametrize("num_nodes,feature_dim", [(8, 4), (5, 7)])
def test_chain_graph_matches_reference(num_nodes, feature_dim):
    got = port_synthetic.chain_graph(num_nodes, feature_dim)
    _assert_same_graph(got, jax_synthetic.chain_graph(num_nodes,
                                                      feature_dim))
    assert got.indices.tolist() == list(range(1, num_nodes))


def _broken(kind):
    """A graph the reference's validate rejects, and what breaks it."""
    g = port_synthetic.random_power_law_graph(num_nodes=50, avg_degree=4,
                                              feature_dim=3, num_classes=2)
    if kind == "indptr_end":
        g.indptr = g.indptr.copy()
        g.indptr[-1] -= 1
    elif kind == "decreasing":
        g.indptr = g.indptr.copy()
        i = int(np.argmax(np.diff(g.indptr) > 0))
        g.indptr[i + 1] = g.indptr[i] - 1
    elif kind == "neighbor":
        g.indices = g.indices.copy()
        g.indices[3] = 50
    elif kind == "features":
        g.features = g.features[:49]
    return g


@pytest.mark.parametrize("kind", ["indptr_end", "decreasing", "neighbor",
                                  "features"])
def test_validate_rejects_what_the_reference_rejects(kind):
    """The reference asserts, the port raises ValueError, on the same
    graphs; both accept the intact graph."""
    g = _broken(kind)
    with pytest.raises(ValueError):
        g.validate()
    with pytest.raises(AssertionError):
        jax_format.GraphData(**dataclasses.asdict(g)).validate()
    good = _broken("none")
    good.validate()
    jax_format.GraphData(**dataclasses.asdict(good)).validate()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_partition_file_round_trip(tmp_path, writer):
    """``save_dataset`` writes ``partition_<k>_bn`` beside the graph (the
    same bytes in both packages); ``load_dataset(partition_count=k)``
    reads it in both, another k or none reads no partition."""
    g = port_synthetic.random_power_law_graph(num_nodes=300, avg_degree=5,
                                              feature_dim=6, num_classes=4)
    g.partition = (np.arange(300) % 3).astype(np.int32)
    jg = jax_format.GraphData(**dataclasses.asdict(g))
    a, b = tmp_path / "port", tmp_path / "reference"
    port_format.save_dataset(g, str(a))
    jax_format.save_dataset(jg, str(b))
    assert _files(a) == _files(b) and "partition_3_bn" in _files(a)
    path = str(a if writer == "port" else b)
    for load in (port_format.load_dataset, jax_format.load_dataset):
        np.testing.assert_array_equal(load(path, partition_count=3).partition,
                                      g.partition)
        assert load(path, partition_count=2).partition is None
        assert load(path).partition is None
