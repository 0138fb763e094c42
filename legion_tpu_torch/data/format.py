"""Graph container and packed on-disk format (counterpart of
``legion_tpu/data/format.py``).

``GraphData``, ``from_coo``, ``pad_feature_dim``, ``save_dataset`` and
``load_dataset`` as the reference defines them, in numpy, so the port and
its smoke script need nothing of the JAX package. Each package reads the
other's dataset directories. The packed layout (the reference's
``src/GPUGraphStore.cu:254-340``):

=================  ==========  ==========================================
file               dtype       contents
=================  ==========  ==========================================
``edge_src``       int64       CSR indptr, ``num_nodes + 1`` entries
``edge_dst``       int32       CSR indices (neighbor ids), ``num_edges``
``features``       float32     ``num_nodes x feature_dim`` row-major
``labels``         int32       ``num_nodes``
``trainingset``    int32       train node ids
``validationset``  int32       valid node ids
``testingset``     int32       test node ids
``partition_K_bn`` int32       per-node partition id (optional, K-way)
``meta.json``      json        counts and dims
=================  ==========  ==========================================

``load_dataset(mmap=True)`` leaves every array a ``numpy.memmap``, so a
feature table larger than RAM stays in the page cache; ``host_tensor``
wraps such an array as a CPU tensor without copying it.
``load_dataset(partition_count=K)`` reads a ``partition_K_bn`` when the
directory holds one (the reference's precomputed K-way partition, which
the edge-partitioned driver uses instead of partitioning).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class GraphData:
    """Host-side graph (numpy; arrays may be memmaps).
    ``indptr[v]:indptr[v+1]`` indexes the incoming message neighbors of
    ``v``: the nodes whose features are aggregated into ``v``."""

    indptr: np.ndarray        # (N+1,) int64
    indices: np.ndarray       # (E,) int32
    features: np.ndarray      # (N, F) float32
    labels: np.ndarray        # (N,) int32
    train_ids: np.ndarray     # (T,) int32
    valid_ids: np.ndarray     # (V,) int32
    test_ids: np.ndarray      # (S,) int32
    partition: Optional[np.ndarray] = None  # (N,) int32, optional

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def validate(self) -> None:
        """Raise ValueError unless the arrays form a graph: a
        nondecreasing indptr from 0 to E, one feature row and one label a
        node, every neighbor id in [0, N)."""
        n, e = self.num_nodes, self.num_edges
        if self.indptr[0] != 0 or self.indptr[-1] != e:
            raise ValueError(f"indptr runs from {self.indptr[0]} to "
                             f"{self.indptr[-1]}, not from 0 to {e}")
        if (np.diff(self.indptr) < 0).any():
            raise ValueError("indptr must be nondecreasing")
        if self.features.shape[0] != n or self.labels.shape[0] != n:
            raise ValueError(f"{self.features.shape[0]} feature rows and "
                             f"{self.labels.shape[0]} labels for {n} nodes")
        if e:
            lo, hi = int(self.indices.min()), int(self.indices.max())
            if lo < 0 or hi >= n:
                raise ValueError(f"neighbor ids span [{lo}, {hi}], outside "
                                 f"[0, {n})")


def save_dataset(g: GraphData, path: str) -> None:
    """Write GraphData in the packed binary layout described above."""
    os.makedirs(path, exist_ok=True)

    def w(name, arr, dtype):
        np.ascontiguousarray(arr, dtype=dtype).tofile(os.path.join(path, name))

    w("edge_src", g.indptr, np.int64)
    w("edge_dst", g.indices, np.int32)
    w("features", g.features, np.float32)
    w("labels", g.labels, np.int32)
    w("trainingset", g.train_ids, np.int32)
    w("validationset", g.valid_ids, np.int32)
    w("testingset", g.test_ids, np.int32)
    meta = {
        "num_nodes": g.num_nodes,
        "num_edges": g.num_edges,
        "feature_dim": g.feature_dim,
        "num_classes": g.num_classes,
        "train_num": int(g.train_ids.shape[0]),
        "valid_num": int(g.valid_ids.shape[0]),
        "test_num": int(g.test_ids.shape[0]),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    if g.partition is not None:
        k = int(g.partition.max()) + 1
        w(f"partition_{k}_bn", g.partition, np.int32)


def load_dataset(path: str, mmap: bool = True,
                 partition_count: Optional[int] = None) -> GraphData:
    """Load a packed dataset directory; with ``mmap`` the arrays stay on
    disk and in the page cache. ``partition_count=K`` also loads the
    directory's ``partition_K_bn`` when there is one."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    n, e, fdim = meta["num_nodes"], meta["num_edges"], meta["feature_dim"]

    def r(name, dtype, shape):
        fp = os.path.join(path, name)
        if mmap:
            return np.memmap(fp, dtype=dtype, mode="r", shape=shape)
        return np.fromfile(fp, dtype=dtype).reshape(shape)

    part = None
    if partition_count is not None:
        name = f"partition_{partition_count}_bn"
        if os.path.exists(os.path.join(path, name)):
            part = r(name, np.int32, (n,))

    return GraphData(
        indptr=r("edge_src", np.int64, (n + 1,)),
        indices=r("edge_dst", np.int32, (e,)),
        features=r("features", np.float32, (n, fdim)),
        labels=r("labels", np.int32, (n,)),
        train_ids=r("trainingset", np.int32, (meta["train_num"],)),
        valid_ids=r("validationset", np.int32, (meta["valid_num"],)),
        test_ids=r("testingset", np.int32, (meta["test_num"],)),
        partition=part,
    )


def host_tensor(array: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``array``'s memory, with no copy. A read-only
    memmap is accepted (torch warns that it cannot mark the tensor
    read-only): the caller only reads the tensor or copies it elsewhere."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(array))


def from_coo(src: np.ndarray, dst: np.ndarray, num_nodes: int,
             features: np.ndarray, labels: np.ndarray,
             train_ids: np.ndarray, valid_ids: np.ndarray,
             test_ids: np.ndarray) -> GraphData:
    """CSR GraphData from a COO edge list; edge (src, dst) means src's
    features flow into dst, so CSR rows are message destinations."""
    order = np.argsort(dst, kind="stable")
    dsts = dst[order]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, dsts + 1, 1)
    np.cumsum(indptr, out=indptr)
    return GraphData(
        indptr=indptr,
        indices=src[order].astype(np.int32),
        features=np.asarray(features, dtype=np.float32),
        labels=np.asarray(labels, dtype=np.int32),
        train_ids=np.asarray(train_ids, dtype=np.int32),
        valid_ids=np.asarray(valid_ids, dtype=np.int32),
        test_ids=np.asarray(test_ids, dtype=np.int32),
    )


def pad_feature_dim(features: np.ndarray, align: int = 128) -> np.ndarray:
    """Zero-pad the feature dim to a multiple of ``align`` columns. Zero
    columns are numerically inert: they meet weight rows whose gradients
    stay zero."""
    pad = (-features.shape[1]) % align
    if pad == 0:
        return features
    return np.pad(features, ((0, 0), (0, pad)))
