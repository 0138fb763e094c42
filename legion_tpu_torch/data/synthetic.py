"""Synthetic graph generators (counterpart of
``legion_tpu/data/synthetic.py``): ``random_power_law_graph`` and
``bench_graph``, which give the same arrays as the reference's for the
same arguments. The on-disk streaming generator and ``chain_graph`` are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from legion_tpu_torch.data.format import GraphData, from_coo


def random_power_law_graph(
    num_nodes: int = 10_000,
    avg_degree: int = 15,
    feature_dim: int = 32,
    num_classes: int = 10,
    alpha: float = 0.8,
    seed: int = 0,
    train_frac: float = 0.6,
    valid_frac: float = 0.2,
) -> GraphData:
    """Directed graph whose neighbor sources follow a Zipf-like skew
    (probability proportional to ``rank^-alpha`` over permuted ids), with
    labels planted by a random linear map of a node's own and 1-hop-mean
    features, so a GNN beats chance."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree

    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    perm = rng.permutation(num_nodes)
    src = perm[rng.choice(num_nodes, size=num_edges, p=probs)]
    dst = rng.integers(0, num_nodes, size=num_edges)

    feats = rng.standard_normal((num_nodes, feature_dim), dtype=np.float32)

    w = rng.standard_normal((feature_dim, num_classes)).astype(np.float32)
    agg = np.zeros_like(feats)
    np.add.at(agg, dst, feats[src])
    deg = np.bincount(dst, minlength=num_nodes).astype(np.float32)[:, None]
    agg = agg / np.maximum(deg, 1.0)
    noise = rng.standard_normal((num_nodes, num_classes)).astype(np.float32)
    labels = ((feats + agg) @ w + 0.5 * noise).argmax(axis=1).astype(np.int32)

    ids = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(num_nodes * train_frac)
    n_valid = int(num_nodes * valid_frac)
    return from_coo(
        src=src.astype(np.int32), dst=dst.astype(np.int32),
        num_nodes=num_nodes, features=feats, labels=labels,
        train_ids=ids[:n_train],
        valid_ids=ids[n_train:n_train + n_valid],
        test_ids=ids[n_train + n_valid:],
    )


def bench_graph(num_nodes: int = 2_449_029, avg_degree: int = 50,
                feature_dim: int = 100, num_classes: int = 47,
                alpha: float = 0.8, seed: int = 0,
                train_frac: float = 0.08) -> GraphData:
    """Products-scale synthetic graph (stand-in for ogbn-products: 2.45M
    nodes, ~122M edges, 100 features, 47 classes) with Zipf sources and
    random labels, built straight into CSR."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree

    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-alpha))
    cdf /= cdf[-1]
    perm = rng.permutation(num_nodes).astype(np.int32)
    src = perm[np.searchsorted(cdf, rng.random(num_edges)).astype(np.int32)]
    dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)

    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=indptr[1:])
    indices = src[order].astype(np.int32)

    feats = rng.standard_normal((num_nodes, feature_dim), dtype=np.float32)
    labels = rng.integers(0, num_classes, size=num_nodes, dtype=np.int32)
    ids = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(num_nodes * train_frac)
    return GraphData(indptr=indptr, indices=indices, features=feats,
                     labels=labels, train_ids=ids[:n_train],
                     valid_ids=ids[n_train:n_train + n_train // 4],
                     test_ids=ids[n_train + n_train // 4:
                                  n_train + n_train // 2])
