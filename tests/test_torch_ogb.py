"""The port's OGB converter (``legion_tpu_torch/data/ogb.py``) against
``legion_tpu.data.ogb`` on one stand-in ``ogb.nodeproppred`` (a small
seeded power-law graph whose labels include NaN rows, put into
``sys.modules``): byte-equal directories with and without reverse edges
and partition files, each package's loader reading the other's directory,
NaN labels as -1, the CSR grouped by destination in the order given, and
a destination outside the nodes refused."""

import filecmp
import os
import sys
import types

import numpy as np
import pytest
import torch

from legion_tpu.data import format as ref_format
from legion_tpu.data.ogb import convert_ogb_node_dataset as ref_convert
from legion_tpu_torch.data import format as port_format
from legion_tpu_torch.data.ogb import convert_ogb_node_dataset

torch.set_num_threads(2)

N, E, F, C = 600, 4000, 12, 5
FIELDS = ("indptr", "indices", "features", "labels", "train_ids",
          "valid_ids", "test_ids", "partition")


def ogb_source(seed=0, num_nodes=N):
    """OGB's arrays for a small graph: ``edge_index`` (2, E) int64 with
    Zipf-popular sources, float32 features, (N, 1) float64 labels with 40
    NaN rows, int64 splits."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, num_nodes + 1, dtype=np.float64) ** -0.8
    src = rng.choice(num_nodes, size=E, p=p / p.sum())
    dst = rng.integers(0, num_nodes, size=E)
    labels = rng.integers(0, C, (num_nodes, 1)).astype(np.float64)
    labels[rng.choice(num_nodes, 40, replace=False)] = np.nan
    perm = rng.permutation(num_nodes)
    return {"num_nodes": num_nodes,
            "edge_index": np.stack([src, dst]).astype(np.int64),
            "node_feat": rng.standard_normal((num_nodes, F),
                                             dtype=np.float32),
            "labels": labels,
            "split": {"train": perm[:300], "valid": perm[300:400],
                      "test": perm[400:]}}


def install(monkeypatch, source):
    """Serve ``source`` as ``ogb.nodeproppred.NodePropPredDataset``."""

    class NodePropPredDataset:
        def __init__(self, name, root):
            self.name, self.root = name, root

        def __getitem__(self, i):
            graph = {k: source[k] for k in ("num_nodes", "edge_index",
                                            "node_feat")}
            return graph, source["labels"]

        def get_idx_split(self):
            return source["split"]

    mod = types.ModuleType("ogb.nodeproppred")
    mod.NodePropPredDataset = NodePropPredDataset
    pkg = types.ModuleType("ogb")
    pkg.nodeproppred = mod
    monkeypatch.setitem(sys.modules, "ogb", pkg)
    monkeypatch.setitem(sys.modules, "ogb.nodeproppred", mod)


@pytest.fixture
def source(monkeypatch):
    src = ogb_source()
    install(monkeypatch, src)
    return src


@pytest.mark.parametrize("partitions", [None, 2, 4])
@pytest.mark.parametrize("add_reverse", [True, False])
def test_both_converters_write_byte_equal_files(source, tmp_path,
                                                add_reverse, partitions):
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    convert_ogb_node_dataset("ogbn-products", "root", a,
                             add_reverse=add_reverse, partitions=partitions)
    ref_convert("ogbn-products", "root", b, add_reverse=add_reverse,
                partitions=partitions)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert "meta.json" in names
    assert (f"partition_{partitions}_bn" in names) == bool(partitions)
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_reads_the_others_directory(source, tmp_path, writer):
    d = str(tmp_path / "packed")
    convert = convert_ogb_node_dataset if writer == "port" else ref_convert
    convert("ogbn-products", "root", d, partitions=2)
    got = port_format.load_dataset(d, partition_count=2)
    want = ref_format.load_dataset(d, partition_count=2)
    for field in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_nan_labels_become_minus_one(source, tmp_path):
    g = convert_ogb_node_dataset("ogbn-products", "root",
                                 str(tmp_path / "packed"))
    raw = source["labels"].reshape(-1)
    nan = np.isnan(raw)
    assert g.labels.dtype == np.int32 and nan.sum() == 40
    assert (g.labels[nan] == -1).all()
    np.testing.assert_array_equal(g.labels[~nan], raw[~nan].astype(np.int32))
    assert g.num_classes == C


def test_the_csr_groups_edges_by_destination_in_the_order_given(
        source, tmp_path):
    """With the reverse edges appended after the originals, row v holds
    first the sources of v's edges, then the destinations of edges out
    of v, each in edge order; what is written is what is returned."""
    d = str(tmp_path / "packed")
    g = convert_ogb_node_dataset("ogbn-products", "root", d)
    src, dst = source["edge_index"]
    assert g.num_edges == 2 * E
    for v in (0, 1, 17, N - 1):
        want = np.concatenate([src[dst == v], dst[src == v]])
        np.testing.assert_array_equal(
            g.indices[g.indptr[v]:g.indptr[v + 1]], want)
    back = port_format.load_dataset(d, mmap=False)
    for field in FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(back, field),
                                      getattr(g, field), err_msg=field)
    assert g.features.dtype == np.float32 and g.train_ids.dtype == np.int32


def test_a_destination_outside_the_nodes_raises(monkeypatch, tmp_path):
    src = ogb_source()
    src["edge_index"][1, 5] = N
    install(monkeypatch, src)
    with pytest.raises(ValueError, match="outside the 600 nodes"):
        convert_ogb_node_dataset("ogbn-products", "root",
                                 str(tmp_path / "packed"), add_reverse=False)
    assert not os.path.exists(tmp_path / "packed")
