"""The cell's inputs, made on the device from the run's seed.

A frozen torch copy of the port's synthetic generator
(``legion_tpu_torch/data/synthetic.py::streaming_power_law_graph``, with
``bench_graph``'s Gaussian features and random labels): Poisson in-degrees
around the configuration's average, neighbour sources Zipf(alpha)-popular
over a permuted id space, Gaussian features, labels uniform over the
classes, and disjoint train / valid / test ids of the configuration's
sizes. Every array is drawn by a ``torch.Generator`` on ``device`` in a few
large calls and then copied once to host memory, where the port's drivers
take their ``GraphData``. The same seed gives the same arrays on the same
kind of card.

A configuration with ``node_types`` makes a typed graph (``typed_inputs``):
each type a contiguous id range, each relation's in-edges drawn as above
between its own two types, a dst row's in-edges grouped by relation in the
configuration's order, and each edge's relation id beside its source.
Features are stored in the configuration's ``feature_dtype`` (float32 by
default).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# edges whose sources are drawn in one call (each takes a float64 uniform
# and an int64 rank on the device)
EDGE_CHUNK = 1 << 26
# feature rows drawn in one call before their copy to the host
ROW_CHUNK = 1 << 21


@dataclasses.dataclass
class Inputs:
    """Host arrays of one cell (numpy), in the port's ``GraphData`` layout."""
    indptr: np.ndarray        # (N+1,) int64
    indices: np.ndarray       # (E,) int32
    features: np.ndarray      # (N, F) feature_dtype
    labels: np.ndarray        # (N,) int32
    train_ids: np.ndarray     # (T,) int32
    valid_ids: np.ndarray     # (V,) int32
    test_ids: np.ndarray      # (S,) int32
    # a typed graph's: each edge's relation id, aligned with ``indices``,
    # and the id ranges of the node types (type t is ids
    # ``[node_type_offsets[t], node_type_offsets[t + 1])``)
    edge_rel: Optional[np.ndarray] = None            # (E,) uint8
    node_type_offsets: Optional[np.ndarray] = None   # (T+1,) int64


def feature_dtype(graph: dict) -> np.dtype:
    """The dtype the feature table is stored in."""
    return np.dtype(graph.get("feature_dtype", "float32"))


def _zipf_cdf(n: int, alpha: float, dev) -> torch.Tensor:
    """(n,) float64: the cumulative Zipf(alpha) law over ranks 1..n."""
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks.pow_(-alpha), 0)
    cdf /= cdf[-1].clone()
    return cdf


def make_inputs(graph: dict, seed: int, device) -> Inputs:
    """The graph of a configuration (its ``num_nodes``,
    ``avg_in_degree``, ``zipf_alpha``, ``feature_dim``, ``num_classes``,
    ``train_nodes``, ``valid_nodes``, ``test_nodes``) from ``seed``; with
    ``node_types``, ``typed_inputs``'s graph."""
    if graph.get("node_types"):
        return typed_inputs(graph, seed, device)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = int(graph["num_nodes"])

    rate = torch.full((n,), float(graph["avg_in_degree"]),
                      dtype=torch.float32, device=dev)
    counts = torch.poisson(rate, generator=gen).to(torch.int64)
    del rate
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=indptr[1:])
    del counts
    e = int(indptr[-1])

    cdf = _zipf_cdf(n, float(graph["zipf_alpha"]), dev)
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    indices = np.empty(e, np.int32)
    for s in range(0, e, EDGE_CHUNK):
        m = min(EDGE_CHUNK, e - s)
        u = torch.rand(m, dtype=torch.float64, generator=gen, device=dev)
        pos = torch.searchsorted(cdf, u).clamp_(max=n - 1)
        torch.from_numpy(indices[s:s + m]).copy_(perm[pos])
    del cdf, perm
    return Inputs(indptr=indptr.cpu().numpy(), indices=indices,
                  **_node_arrays(graph, gen, dev, n, n))


def _node_arrays(graph: dict, gen: torch.Generator, dev, n: int,
                 labelled: int) -> dict:
    """Drawn after the edges: the (n, feature_dim) Gaussian features in
    ``feature_dtype`` (drawn in that dtype, ``ROW_CHUNK`` rows a call), the
    labels, and the split ids from a permutation of ids ``[0,
    labelled)``."""
    f = int(graph["feature_dim"])
    dt = feature_dtype(graph)
    features = np.empty((n, f), dt)
    for s in range(0, n, ROW_CHUNK):
        m = min(ROW_CHUNK, n - s)
        torch.from_numpy(features[s:s + m]).copy_(
            torch.randn((m, f), generator=gen, device=dev,
                        dtype=getattr(torch, dt.name)))
    labels = torch.randint(0, int(graph["num_classes"]), (n,),
                           generator=gen, device=dev, dtype=torch.int32)
    t, v, s_ = (int(graph[k]) for k in
                ("train_nodes", "valid_nodes", "test_nodes"))
    ids = torch.randperm(labelled, generator=gen, device=dev)[
        :t + v + s_].to(torch.int32).cpu().numpy()
    return dict(features=features, labels=labels.cpu().numpy(),
                train_ids=ids[:t], valid_ids=ids[t:t + v],
                test_ids=ids[t + v:])


def typed_inputs(graph: dict, seed: int, device) -> Inputs:
    """The typed graph of a configuration: ``node_types`` (``name``,
    ``num_nodes``; in id order), ``relations`` (``name``, ``src``, ``dst``,
    ``avg_in_degree``, ``zipf_alpha``; a relation's id is its index),
    ``feature_dim``, ``feature_dtype``, ``num_classes`` and the splits,
    drawn from type 0's ids. For each relation every node of its dst type
    draws Poisson(``avg_in_degree``) in-edges, whose sources are
    Zipf(``zipf_alpha``)-popular over a permutation of the src type's ids.
    The draws: each relation's in-degrees and permutation in list order,
    then each type's rows in chunks of at most ``EDGE_CHUNK`` edges, the
    relations into it in list order, then the features in chunks of
    ``ROW_CHUNK`` rows, the labels and the splits."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    sizes = [int(t["num_nodes"]) for t in graph["node_types"]]
    type_of = {t["name"]: i for i, t in enumerate(graph["node_types"])}
    rels = graph["relations"]
    offsets = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    n = int(offsets[-1])

    counts, perms = [], []
    for r in rels:
        rate = torch.full((sizes[type_of[r["dst"]]],),
                          float(r["avg_in_degree"]), dtype=torch.float32,
                          device=dev)
        counts.append(torch.poisson(rate, generator=gen).to(torch.int64))
        del rate
        perms.append(torch.randperm(sizes[type_of[r["src"]]], generator=gen,
                                    device=dev).to(torch.int32))
    deg = torch.zeros(n, dtype=torch.int64, device=dev)
    for r, c in zip(rels, counts):
        t = type_of[r["dst"]]
        deg[offsets[t]:offsets[t + 1]] += c
    indptr_d = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg, 0, out=indptr_d[1:])
    del deg
    indptr = indptr_d.cpu().numpy()
    e = int(indptr[-1])

    indices = np.empty(e, np.int32)
    edge_rel = np.empty(e, np.uint8)
    for t in range(len(sizes)):
        into = [k for k, r in enumerate(rels) if type_of[r["dst"]] == t]
        cdfs = {k: _zipf_cdf(sizes[type_of[rels[k]["src"]]],
                             float(rels[k]["zipf_alpha"]), dev)
                for k in into}
        a = int(offsets[t])
        while a < offsets[t + 1]:
            # rows [a, b): at least one, at most EDGE_CHUNK edges if more
            b = int(np.searchsorted(indptr, indptr[a] + EDGE_CHUNK, "right"))
            b = min(max(b - 1, a + 1), int(offsets[t + 1]))
            e0, e1 = int(indptr[a]), int(indptr[b])
            idx = torch.empty(e1 - e0, dtype=torch.int32, device=dev)
            rel = torch.empty(e1 - e0, dtype=torch.uint8, device=dev)
            at = indptr_d[a:b] - e0          # each row's next free slot
            for k in into:
                c = counts[k][a - offsets[t]:b - offsets[t]]
                m = int(c.sum())
                src = int(offsets[type_of[rels[k]["src"]]])
                u = torch.rand(m, dtype=torch.float64, generator=gen,
                               device=dev)
                pos = torch.searchsorted(cdfs[k], u).clamp_(
                    max=perms[k].shape[0] - 1)
                first = torch.repeat_interleave(at, c)
                within = torch.arange(m, device=dev) - torch.repeat_interleave(
                    torch.cumsum(c, 0) - c, c)
                slot = first + within
                idx[slot] = perms[k][pos] + src
                rel[slot] = k
                at = at + c
                del u, pos, first, within, slot
            torch.from_numpy(indices[e0:e1]).copy_(idx)
            torch.from_numpy(edge_rel[e0:e1]).copy_(rel)
            del idx, rel
            a = b
        del cdfs
    del counts, perms, indptr_d
    return Inputs(indptr=indptr, indices=indices, edge_rel=edge_rel,
                  node_type_offsets=offsets,
                  **_node_arrays(graph, gen, dev, n, sizes[0]))
