"""The port's OGB parity harness (``legion_tpu_torch/tools/parity_ogb.py``)
on the CPU against a stand-in ``ogb.nodeproppred`` serving a small
planted-label graph (convert -> packed dir -> train -> verdict and exit
code), its targets against ``tools/parity_ogb.py``'s, the cached driver
behind ``--cache-budget-gb``, a converted partition file through the
command line, and ``tools/products_cell.py`` (the ogbn-products stand-in)
at a cut shape."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from legion_tpu_torch.data.format import load_dataset
from legion_tpu_torch.data.ogb import convert_ogb_node_dataset
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.tools import parity_ogb, products_cell

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 7
CHANCE = 1.0 / CLASSES


@pytest.fixture(scope="module")
def graph():
    return random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=CLASSES, seed=1)


@pytest.fixture
def fake_ogb(monkeypatch, graph):
    """``ogb.nodeproppred.NodePropPredDataset`` serving ``graph`` as OGB
    does: COO int64 edges, (N, 1) float64 labels, int64 splits."""
    dst = np.repeat(np.arange(graph.num_nodes), np.diff(graph.indptr))
    edge_index = np.stack([graph.indices.astype(np.int64),
                           dst.astype(np.int64)])
    split = {"train": graph.train_ids.astype(np.int64),
             "valid": graph.valid_ids.astype(np.int64),
             "test": graph.test_ids.astype(np.int64)}

    class NodePropPredDataset:
        def __init__(self, name, root):
            assert name == "ogbn-products"

        def __getitem__(self, i):
            return ({"num_nodes": graph.num_nodes, "edge_index": edge_index,
                     "node_feat": graph.features},
                    graph.labels.astype(np.float64)[:, None])

        def get_idx_split(self):
            return split

    mod = types.ModuleType("ogb.nodeproppred")
    mod.NodePropPredDataset = NodePropPredDataset
    pkg = types.ModuleType("ogb")
    pkg.nodeproppred = mod
    monkeypatch.setitem(sys.modules, "ogb", pkg)
    monkeypatch.setitem(sys.modules, "ogb.nodeproppred", mod)
    return NodePropPredDataset


def run(root, extra):
    """The harness at a small size on the CPU; its return code."""
    return parity_ogb.main([
        "--ogb-root", str(root), "--name", "ogbn-products", "--device", "cpu",
        "--batch-size", "64", "--fanouts", "4,3", "--hidden-dim", "16",
        "--dropout", "0.0", "--lr", "0.01", "--epochs", "2", "--dtype",
        "float32"] + extra)


def verdict(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_harness_passes_above_chance_and_leaves_the_packed_dir(
        tmp_path, fake_ogb, capsys):
    rc = run(tmp_path, ["--target", f"{1.5 * CHANCE:.3f}"])
    rec = verdict(capsys)
    assert rc == 0 and rec["parity"] == "PASS"
    assert rec["test_acc"] > 1.5 * CHANCE
    assert np.isfinite(rec["valid_acc"])
    assert set(rec) == {"dataset", "arch", "valid_acc", "test_acc", "target",
                        "gap", "tolerance", "parity"}
    meta = tmp_path / "ogbn_products_packed" / "meta.json"
    assert json.loads(meta.read_text())["num_edges"] == 2 * 16000


def test_harness_fails_loudly_on_a_gap(tmp_path, fake_ogb, capsys):
    rc = run(tmp_path, ["--target", "0.99"])
    rec = verdict(capsys)
    assert rc == 1 and rec["parity"] == "FAIL"
    assert rec["gap"] > rec["tolerance"]


def test_a_second_run_skips_the_conversion(tmp_path, fake_ogb, capsys,
                                           monkeypatch):
    assert run(tmp_path, ["--target", "0.0"]) == 0
    first = verdict(capsys)

    def refuse(*args, **kwargs):
        raise AssertionError("converted again")

    monkeypatch.setattr("legion_tpu_torch.data.ogb.convert_ogb_node_dataset",
                        refuse)
    assert run(tmp_path, ["--target", "0.0"]) == 0
    cap = capsys.readouterr()
    assert "skipping conversion" in cap.err
    assert json.loads(cap.out.strip().splitlines()[-1]) == first


def test_targets_are_the_reference_harness_targets():
    from tools.parity_ogb import TARGETS
    assert parity_ogb.TARGETS == TARGETS
    assert parity_ogb.TARGETS[("ogbn-products", "sage")] == 0.78


def test_flags_and_defaults_are_the_reference_harness_plus_device(
        monkeypatch):
    """Every flag of ``tools/parity_ogb.py`` with its default (read from
    the parser its ``main`` builds), and ``--device`` defaulting to cuda."""
    import argparse

    import tools.parity_ogb as ref
    seen = {}

    def capture(self, argv=None, namespace=None):
        seen.update({a.dest: a.default for a in self._actions})
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        ref.main([])
    port = {a.dest: a.default for a in parity_ogb.build_parser()._actions}
    assert port.pop("device") == "cuda"
    assert port == seen and "ogb_root" in seen


def test_cache_budget_runs_the_cached_driver(tmp_path, fake_ogb, capsys,
                                             monkeypatch):
    from legion_tpu_torch.train import cached_driver
    calls = []
    real = cached_driver.run_cached_training

    def spy(cfg, data, device, **kwargs):
        calls.append((cfg.cache.enabled, cfg.dataset.feature_placement,
                      str(device)))
        return real(cfg, data, device, **kwargs)

    monkeypatch.setattr(cached_driver, "run_cached_training", spy)
    rc = run(tmp_path, ["--target", f"{1.5 * CHANCE:.3f}",
                        "--cache-budget-gb", "0.0001"])
    rec = verdict(capsys)
    assert calls == [(True, "host", "cpu")]
    assert rc == 0 and rec["parity"] == "PASS"


def test_device_cuda_without_a_card_raises(tmp_path, fake_ogb, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        parity_ogb.main(["--ogb-root", str(tmp_path)])
    assert not os.path.exists(tmp_path / "ogbn_products_packed")


def test_a_converted_partition_trains_through_partitioned_devices_2(
        tmp_path, fake_ogb):
    """A directory the converter wrote with ``partitions=2`` carries
    ``partition_2_bn``, which ``--partitioned --devices 2`` loads (two
    gloo ranks; rank 0 logs) instead of partitioning."""
    d = str(tmp_path / "packed")
    convert_ogb_node_dataset("ogbn-products", str(tmp_path), d, partitions=2)
    assert os.path.exists(os.path.join(d, "partition_2_bn"))
    r = subprocess.run(
        [sys.executable, "-m", "legion_tpu_torch.train", "--device", "cpu",
         "--data-dir", d, "--partitioned", "--devices", "2", "--epochs", "1",
         "--batch-size", "32", "--fanouts", "4,3", "--hidden-dim", "16"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "using precomputed 2-way partition" in r.stdout
    assert r.stdout.count("[2-way partitioned]") == 1
    assert "Accuracy on test data" in r.stdout


CUT = dict(num_nodes=3000, num_edges=20000, split=(400, 100, 1200))


def test_products_cell_at_a_cut_shape_converts(tmp_path, monkeypatch):
    root = products_cell.standin(str(tmp_path), log=lambda s: None, **CUT)
    mod = products_cell.ogb_module()
    monkeypatch.setitem(sys.modules, "ogb", mod)
    monkeypatch.setitem(sys.modules, "ogb.nodeproppred", mod)
    ds = mod.NodePropPredDataset("ogbn-products", root)
    graph, labels = ds[0]
    assert graph["edge_index"].shape == (2, 20000)
    assert graph["edge_index"].dtype == np.int64
    assert graph["node_feat"].shape == (3000, 100)
    assert graph["node_feat"].dtype == np.float32
    assert labels.shape == (3000, 1) and labels.dtype == np.float64
    assert [len(v) for v in ds.get_idx_split().values()] == [400, 100, 1200]
    g = convert_ogb_node_dataset("ogbn-products", root,
                                 str(tmp_path / "packed"))
    assert (g.num_nodes, g.num_edges, g.feature_dim, g.num_classes) == (
        3000, 40000, 100, 47)
    assert set(np.unique(g.labels)) == set(range(47))
    back = load_dataset(str(tmp_path / "packed"))
    np.testing.assert_array_equal(back.indices, g.indices)
    with pytest.raises(ValueError, match="serves ogbn-products"):
        mod.NodePropPredDataset("ogbn-arxiv", root)


def test_products_cell_is_generated_once_and_keyed_by_shape(tmp_path,
                                                            monkeypatch):
    quiet = dict(log=lambda s: None)
    first = products_cell.standin(str(tmp_path), **quiet, **CUT)
    monkeypatch.setattr(products_cell, "generate",
                        lambda *a, **k: pytest.fail("generated again"))
    assert products_cell.standin(str(tmp_path), **quiet, **CUT) == first
    other = products_cell.standin_dir(str(tmp_path), seed=1, **CUT)
    assert other != first
    assert products_cell.standin_dir(str(tmp_path)) != first


def test_products_cell_labels_are_planted(tmp_path):
    """A node's label is the argmax of a linear map of its own features
    and its neighbors' mean: a least-squares fit on the raw features alone
    already predicts it far above chance (47 classes)."""
    root = products_cell.standin(str(tmp_path), log=lambda s: None, **CUT)
    ds = products_cell.NodePropPredDataset("ogbn-products", root)
    graph, labels = ds[0]
    x = np.asarray(graph["node_feat"], np.float64)
    y = np.asarray(labels).reshape(-1).astype(np.int64)
    w, *_ = np.linalg.lstsq(x, np.eye(47)[y], rcond=None)
    assert ((x @ w).argmax(1) == y).mean() > 0.5


def test_neighbor_sum_matches_a_scatter_add():
    rng = np.random.default_rng(4)
    n = 500
    deg = rng.integers(0, 6, n)
    deg[rng.choice(n, 60, replace=False)] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    want = np.zeros((n, 3))
    np.add.at(want, np.repeat(np.arange(n), deg), x[indices].astype(np.float64))
    for chunk in (7, 64, 1 << 18):
        np.testing.assert_array_equal(
            products_cell.neighbor_sum(indptr, indices, x, chunk), want)
