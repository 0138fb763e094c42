"""An ogbn-products stand-in for the OGB source: the raw arrays that
``ogb.nodeproppred.NodePropPredDataset("ogbn-products", root)`` serves,
at the published shapes, made from a seed.

* 2,449,029 nodes; ``edge_index`` 2 x 61,859,140 ``int64`` (each
  undirected edge once, so the converter's reverse edges make the
  123,718,280 that ``DATASET_REGISTRY["PR"]`` expects);
* ``node_feat`` 2,449,029 x 100 ``float32``;
* labels (N, 1) ``float64`` in 47 classes;
* the split 196,615 / 39,323 / 2,213,091 (``int64``).

Edges: sources Zipf(0.8)-popular over permuted ids, destinations uniform
(``data/synthetic.py::bench_graph``'s draw). Labels are planted as
``random_power_law_graph`` plants them: the argmax of a random linear map
of a node's own features plus the mean of its neighbors' (both edge
directions, the graph the converter packs), plus noise, so that a GNN
beats chance. The neighbor mean is a float64 segment sum over the CSR.

``standin(root)`` generates the arrays once into
``<root>/.bench_cache/ogbn_products_standin_<hash>/`` (the hash covers
the seed, the shape and this file's and ``data/synthetic.py``'s sources;
other such directories are removed first) and returns that directory;
``ogb_module()`` returns a module whose ``NodePropPredDataset(name, root)``
serves such a directory by mmap. The caller puts the module into
``sys.modules`` as ``ogb`` and ``ogb.nodeproppred`` while it converts::

    root = products_cell.standin(".")
    mod = products_cell.ogb_module()
    sys.modules.update({"ogb": mod, "ogb.nodeproppred": mod})
    convert_ogb_node_dataset("ogbn-products", root, "products_packed")
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import types

import numpy as np
import torch

from legion_tpu_torch import runtime
from legion_tpu_torch.data import synthetic

NAME = "ogbn-products"
SHAPE = dict(num_nodes=2_449_029, num_edges=61_859_140, feature_dim=100,
             num_classes=47, split=(196_615, 39_323, 2_213_091))
_PREFIX = "ogbn_products_standin_"


def neighbor_sum(indptr: np.ndarray, indices: np.ndarray, x: np.ndarray,
                 chunk: int = 1 << 18) -> np.ndarray:
    """``out[v] = sum(x[indices[indptr[v]:indptr[v+1]]])`` in float64: a
    segment sum over the CSR, each row's terms added in CSR order
    (``index_add_`` on the CPU over chunks of ``chunk`` edges; the same
    floats at any thread count or chunk)."""
    n = indptr.shape[0] - 1
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float64))
    out = torch.zeros(xt.shape, dtype=torch.float64)
    rows = torch.repeat_interleave(torch.arange(n),
                                   torch.from_numpy(np.diff(indptr)))
    idx = torch.from_numpy(np.asarray(indices))
    for a in range(0, idx.shape[0], chunk):
        out.index_add_(0, rows[a:a + chunk],
                       xt.index_select(0, idx[a:a + chunk]))
    return out.numpy()


def generate(path: str, num_nodes: int, num_edges: int, feature_dim: int,
             num_classes: int, split, seed: int = 0, alpha: float = 0.8,
             log=print) -> None:
    """Write the stand-in's arrays into ``path`` as ``.npy`` files."""
    n_train, n_valid, n_test = split
    if n_train + n_valid + n_test > num_nodes:
        raise ValueError(f"a split of {sum(split)} ids over {num_nodes} "
                         "nodes")
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-alpha))
    cdf /= cdf[-1]
    perm = rng.permutation(num_nodes).astype(np.int32)
    edges = np.lib.format.open_memmap(os.path.join(path, "edge_index.npy"),
                                      "w+", np.int64, (2, num_edges))
    edges[0] = synthetic._zipf_sources(cdf, perm, rng.random(num_edges))
    edges[1] = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    edges.flush()
    del cdf, perm
    log(f"edges drawn {time.perf_counter() - t0:.1f}s")

    feats = rng.standard_normal((num_nodes, feature_dim), dtype=np.float32)
    np.save(os.path.join(path, "node_feat.npy"), feats)
    w = rng.standard_normal((feature_dim, num_classes)).astype(np.float32)
    fw = feats @ w
    del feats
    # the mean over both edge directions, as the packed (reversed) graph
    # has it
    indptr, indices = runtime.coo_to_csr(
        np.concatenate([edges[0], edges[1]]),
        np.concatenate([edges[1], edges[0]]), num_nodes)
    del edges
    deg = np.diff(indptr).astype(np.float32)[:, None]
    agg = (neighbor_sum(indptr, indices, fw)
           / np.maximum(deg, 1.0)).astype(np.float32)
    del indptr, indices
    noise = rng.standard_normal((num_nodes, num_classes)).astype(np.float32)
    labels = (fw + agg + 0.5 * noise).argmax(axis=1)
    np.save(os.path.join(path, "node_label.npy"),
            labels.astype(np.float64)[:, None])
    log(f"labels planted {time.perf_counter() - t0:.1f}s")

    ids = rng.permutation(num_nodes).astype(np.int64)
    for name, part in (("train", ids[:n_train]),
                       ("valid", ids[n_train:n_train + n_valid]),
                       ("test", ids[n_train + n_valid:
                                    n_train + n_valid + n_test])):
        np.save(os.path.join(path, f"split_{name}.npy"), part)
    with open(os.path.join(path, "shape.json"), "w") as f:
        json.dump({"num_nodes": num_nodes, "num_edges": num_edges,
                   "feature_dim": feature_dim, "num_classes": num_classes,
                   "split": list(split), "seed": seed}, f)


def standin_dir(root: str, seed: int = 0, **shape) -> str:
    """Where ``standin`` keeps the arrays of this seed and shape."""
    args = {**SHAPE, **shape, "seed": seed}
    h = hashlib.sha256(json.dumps(args, sort_keys=True).encode())
    for source in (synthetic.__file__, __file__):
        with open(source, "rb") as f:
            h.update(f.read())
    return os.path.join(root, ".bench_cache",
                        f"{_PREFIX}{args['num_nodes']}_{h.hexdigest()[:12]}")


def standin(root: str, seed: int = 0, log=print, **shape) -> str:
    """The stand-in's directory under ``<root>/.bench_cache``, generated
    unless a complete copy (one with ``shape.json``) is there. ``shape``
    overrides entries of ``SHAPE`` (the tests cut it)."""
    path = standin_dir(root, seed, **shape)
    if not os.path.exists(os.path.join(path, "shape.json")):
        cache = os.path.dirname(path)
        os.makedirs(cache, exist_ok=True)
        for name in os.listdir(cache):
            if name.startswith(_PREFIX):
                shutil.rmtree(os.path.join(cache, name))
        generate(path + ".tmp", seed=seed, log=log, **{**SHAPE, **shape})
        os.replace(path + ".tmp", path)
    return path


class NodePropPredDataset:
    """``ogb.nodeproppred.NodePropPredDataset``'s interface over a
    stand-in directory: ``ds[0]`` is (graph dict, labels (N, 1)),
    ``get_idx_split()`` the train / valid / test ids; arrays are mmaps."""

    def __init__(self, name: str, root: str):
        if name != NAME:
            raise ValueError(f"the stand-in serves {NAME}, not {name!r}")
        self.name, self.root = name, root
        with open(os.path.join(root, "shape.json")) as f:
            self.num_nodes = json.load(f)["num_nodes"]

    def _load(self, name: str) -> np.ndarray:
        return np.load(os.path.join(self.root, name), mmap_mode="r")

    def __getitem__(self, i: int):
        if i != 0:
            raise IndexError(i)
        graph = {"num_nodes": self.num_nodes,
                 "edge_index": self._load("edge_index.npy"),
                 "node_feat": self._load("node_feat.npy")}
        return graph, self._load("node_label.npy")

    def get_idx_split(self):
        return {k: self._load(f"split_{k}.npy")
                for k in ("train", "valid", "test")}


def ogb_module() -> types.ModuleType:
    """A module serving ``NodePropPredDataset``, to stand as both ``ogb``
    and ``ogb.nodeproppred`` in ``sys.modules``."""
    mod = types.ModuleType("ogb.nodeproppred")
    mod.NodePropPredDataset = NodePropPredDataset
    return mod
