"""Synthetic graph generators (counterpart of
``legion_tpu/data/synthetic.py``): ``random_power_law_graph``,
``bench_graph``, the on-disk ``streaming_power_law_graph`` (with its
planted ``communities``) and ``chain_graph``, which give the same arrays
(and files) as the reference's for the same arguments.

The Zipf source draws, a binary search of every edge's uniform in a CDF
of one float64 per node, take most of the generation time at 10^8+
edges; ``_zipf_sources`` splits that search over threads (numpy releases
the GIL in it), which changes no value.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from legion_tpu_torch.data.format import GraphData, from_coo


def _zipf_sources(cdf: np.ndarray, perm: np.ndarray,
                  u: np.ndarray) -> np.ndarray:
    """``perm[searchsorted(cdf, u)]``: the source id of each edge whose
    uniform is ``u``, with the search split over up to 8 threads."""
    k = max(1, min(8, os.cpu_count() or 1, len(u) // (1 << 20)))
    bounds = np.linspace(0, len(u), k + 1).astype(np.int64)
    with ThreadPoolExecutor(k) as ex:
        parts = ex.map(lambda i: np.searchsorted(cdf, u[bounds[i]:
                                                        bounds[i + 1]]),
                       range(k))
        pos = np.concatenate(list(parts))
    return perm[pos]


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
    src = _zipf_sources(cdf, perm, rng.random(num_edges))
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


def _stream_indptr(f, counts: np.ndarray, chunk_nodes: int) -> int:
    """Write the int64 indptr for per-node edge counts in chunks (the
    running offset stays int64). Returns the total edge count."""
    np.zeros(1, np.int64).tofile(f)
    run = np.int64(0)
    for s in range(0, len(counts), chunk_nodes):
        c = counts[s: s + chunk_nodes].astype(np.int64, copy=False)
        out = np.cumsum(c) + run
        run = out[-1]
        out.tofile(f)
    return int(run)


def streaming_power_law_graph(
    path: str,
    num_nodes: int,
    avg_degree: float,
    feature_dim: int = 32,
    num_classes: int = 100,
    alpha: float = 0.8,
    seed: int = 0,
    train_num: int = 800_000,
    valid_num: int = 16_000,
    test_num: int = 16_000,
    chunk_nodes: int = 2_000_000,
    communities: int = 0,
    intra_frac: float = 0.8,
    log=print,
) -> str:
    """Write a packed dataset (``data.format`` layout) straight to disk
    with bounded RAM, the CSR in node order with no sort: the generator
    for graphs of 10^7+ nodes. Peak RAM is ~3 float64 per node for the
    Zipf CDF plus one chunk of draws.

    In-degrees are Poisson(avg_degree) (num_edges is their sum, recorded
    in meta.json); neighbor sources are Zipf(alpha)-popular over a
    permuted id space. Returns path.

    ``communities`` > 1 plants block structure, which a partitioner can
    find: nodes fall into that many random groups, and each edge's source
    is drawn from its destination's own group (Zipf-skewed within it)
    with probability ``intra_frac``, else from the global Zipf. Adds 8
    bytes of RAM a node."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)

    t0 = time.time()
    counts = rng.poisson(avg_degree, num_nodes).astype(np.int64)
    with open(os.path.join(path, "edge_src"), "wb") as f:
        num_edges = _stream_indptr(f, counts, chunk_nodes)
    log(f"indptr written ({num_edges} edges) {time.time()-t0:.0f}s")

    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-alpha))
    cdf /= cdf[-1]
    perm = rng.permutation(num_nodes).astype(np.int32)
    if communities > 1:
        csize = -(-num_nodes // communities)
        cperm = rng.permutation(num_nodes).astype(np.int32)
        cinv = np.empty(num_nodes, np.int32)
        cinv[cperm] = np.arange(num_nodes, dtype=np.int32)
        lcdf = np.cumsum(np.arange(1, csize + 1, dtype=np.float64)
                         ** (-alpha))
        lcdf /= lcdf[-1]

    with open(os.path.join(path, "edge_dst"), "wb") as f:
        done = 0
        for s in range(0, num_nodes, chunk_nodes):
            c = counts[s: s + chunk_nodes]
            e = int(c.sum())
            src = _zipf_sources(cdf, perm, rng.random(e))
            if communities > 1 and e:
                # each edge's destination, its group and the group's base
                dst = np.int64(s) + np.repeat(
                    np.arange(len(c), dtype=np.int64), c)
                base = (cinv[dst] // csize).astype(np.int64) * csize
                lr = np.minimum(
                    np.searchsorted(lcdf, rng.random(e)).astype(np.int64),
                    np.minimum(csize, num_nodes - base) - 1)
                intra = rng.random(e) < intra_frac
                src = np.where(intra, cperm[base + lr], src)
            src.astype(np.int32).tofile(f)
            done += e
            if (s // chunk_nodes) % 8 == 0:
                log(f"  edges {done}/{num_edges} {time.time()-t0:.0f}s")
    del cdf
    log(f"indices written {time.time()-t0:.0f}s")

    with open(os.path.join(path, "features"), "wb") as f:
        for s in range(0, num_nodes, chunk_nodes):
            m = min(chunk_nodes, num_nodes - s)
            rng.standard_normal((m, feature_dim),
                                dtype=np.float32).tofile(f)
    log(f"features written {time.time()-t0:.0f}s")

    rng.integers(0, num_classes, num_nodes,
                 dtype=np.int32).tofile(os.path.join(path, "labels"))
    total = train_num + valid_num + test_num
    ids = rng.choice(num_nodes, size=total, replace=False).astype(np.int32)
    ids[:train_num].tofile(os.path.join(path, "trainingset"))
    ids[train_num:train_num + valid_num].tofile(
        os.path.join(path, "validationset"))
    ids[train_num + valid_num:].tofile(os.path.join(path, "testingset"))

    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({
            "num_nodes": num_nodes, "num_edges": num_edges,
            "feature_dim": feature_dim, "num_classes": num_classes,
            "train_num": train_num, "valid_num": valid_num,
            "test_num": test_num,
        }, f, indent=2)
    log(f"dataset complete {time.time()-t0:.0f}s")
    return path


def chain_graph(num_nodes: int = 8, feature_dim: int = 4) -> GraphData:
    """A deterministic chain 0 <- 1 <- 2 <- ...: node v's one in-neighbor
    is v + 1. One-hot features and alternating labels; every node is a
    train id. For samplers checked by hand."""
    src = np.arange(1, num_nodes, dtype=np.int32)
    dst = np.arange(0, num_nodes - 1, dtype=np.int32)
    feats = np.eye(num_nodes, feature_dim, dtype=np.float32)
    labels = (np.arange(num_nodes) % 2).astype(np.int32)
    ids = np.arange(num_nodes, dtype=np.int32)
    return from_coo(src, dst, num_nodes, feats, labels, ids, ids[:0], ids[:0])
