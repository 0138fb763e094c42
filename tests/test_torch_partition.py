"""The port's partitioner (``legion_tpu_torch/data/partition.py``) against
``legion_tpu.data.partition``: the partition vector bitwise equal in
every mode, at 2 and 4 parts, on the conftest's ``small_graph`` and on a
graph with planted communities; the same edge cut; and the quality and
balance the halo exchange relies on."""

import numpy as np
import pytest
import torch

from legion_tpu.data import partition as jax_partition
from legion_tpu.data import format as jax_format
from legion_tpu_torch.data import format as port_format
from legion_tpu_torch.data import partition as port_partition
from legion_tpu_torch.data.synthetic import streaming_power_law_graph

torch.set_num_threads(2)

MODES = ("hash", "greedy", "greedy_seq")


@pytest.fixture(scope="module")
def community_graph(tmp_path_factory):
    """3000 nodes in 4 planted communities (80 % of edges inside), read
    by both packages."""
    path = str(tmp_path_factory.mktemp("communities") / "g")
    streaming_power_law_graph(path, num_nodes=3000, avg_degree=8,
                              feature_dim=4, num_classes=5, seed=2,
                              train_num=600, valid_num=100, test_num=100,
                              communities=4, log=lambda s: None)
    return port_format.load_dataset(path, mmap=False)


def _graph(name, small_graph, community_graph):
    return small_graph if name == "small" else community_graph


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["small", "communities"])
def test_partition_vector_is_the_reference_bitwise(name, mode, k,
                                                   small_graph,
                                                   community_graph):
    g = _graph(name, small_graph, community_graph)
    got = port_partition.partition_graph(g, k, mode=mode)
    want = jax_partition.partition_graph(g, k, mode=mode)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert port_partition.edge_cut_fraction(g, got) == \
        jax_partition.edge_cut_fraction(g, want)


@pytest.mark.parametrize("chunk_size,refine_sweeps", [(64, 0), (500, 1),
                                                      (65536, 5)])
def test_chunked_greedy_options_are_the_reference(community_graph,
                                                  chunk_size, refine_sweeps):
    """The chunked pass and its refinement at other chunk sizes and sweep
    counts, and a tighter balance slack."""
    kw = dict(mode="greedy", balance_slack=1.02, chunk_size=chunk_size,
              refine_sweeps=refine_sweeps)
    np.testing.assert_array_equal(
        port_partition.partition_graph(community_graph, 3, **kw),
        jax_partition.partition_graph(community_graph, 3, **kw))


def test_one_part_and_unknown_modes(small_graph):
    assert not port_partition.partition_graph(small_graph, 1).any()
    with pytest.raises(ValueError, match="unknown partition mode"):
        port_partition.partition_graph(small_graph, 2, mode="metis")


def test_greedy_beats_hash_and_stays_balanced(community_graph,
                                               small_graph):
    """Greedy cuts fewer edges than hash on both graphs, and no part
    outgrows its quota."""
    for g, k in ((small_graph, 4), (community_graph, 4)):
        cut_hash = port_partition.edge_cut_fraction(
            g, port_partition.partition_graph(g, k, mode="hash"))
        part = port_partition.partition_graph(g, k, mode="greedy")
        assert port_partition.edge_cut_fraction(g, part) < cut_hash
        assert np.bincount(part, minlength=k).max() <= int(
            g.num_nodes / k * 1.05) + 1


def test_edge_cut_of_an_edgeless_graph_is_zero():
    g = port_format.from_coo(np.zeros(0, np.int32), np.zeros(0, np.int32), 4,
                             np.zeros((4, 1), np.float32),
                             np.zeros(4, np.int32), np.arange(4),
                             np.arange(0), np.arange(0))
    part = np.array([0, 1, 0, 1], np.int32)
    assert port_partition.edge_cut_fraction(g, part) == 0.0 == \
        jax_partition.edge_cut_fraction(jax_format.GraphData(
            **{f: getattr(g, f) for f in (
                "indptr", "indices", "features", "labels", "train_ids",
                "valid_ids", "test_ids")}), part)
