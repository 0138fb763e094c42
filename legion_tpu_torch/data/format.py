"""In-memory graph container (counterpart of ``legion_tpu/data/format.py``).

``GraphData``, ``from_coo`` and ``pad_feature_dim`` as the reference
defines them, in numpy, so the port and its smoke script need nothing of
the JAX package. The packed on-disk format (``save_dataset`` /
``load_dataset``) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphData:
    """Host-side graph (numpy). ``indptr[v]:indptr[v+1]`` indexes the
    incoming message neighbors of ``v``: the nodes whose features are
    aggregated into ``v``."""

    indptr: np.ndarray        # (N+1,) int64
    indices: np.ndarray       # (E,) int32
    features: np.ndarray      # (N, F) float32
    labels: np.ndarray        # (N,) int32
    train_ids: np.ndarray     # (T,) int32
    valid_ids: np.ndarray     # (V,) int32
    test_ids: np.ndarray      # (S,) int32

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
