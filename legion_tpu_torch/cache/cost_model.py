"""Cache cost model: split one device-memory budget between the feature
and topology caches to maximize saved host<->device traffic.

A numpy copy of ``legion_tpu/cache/cost_model.py`` (itself a re-derivation
of the reference's ``GPUCache::CostModel``, ``src/GPUCache.cu:661-767``);
the port may not import ``legion_tpu.cache``, whose ``__init__`` loads
JAX. ``tests/test_torch_cache.py`` holds the two equal.

* candidate orders are hotness-descending (``:578-659``);
* topology bytes per cached node are 8 + 4*degree;
* the budget is one card's, times ``group_size`` cards of a cache group
  (the reference's single-device drivers plan for the group's whole
  budget as well);
* the budget split is swept in ``granularity`` steps; the saved traffic
  of a prefix is the total traffic x the prefix's hotness share; the
  split maximizing feature + topology savings wins (``:744-761``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CachePlanResult:
    feat_order: np.ndarray       # node ids, feature-hotness descending
    topo_order: np.ndarray       # node ids, topology-hotness descending
    feat_capacity: int           # nodes cached
    topo_capacity: int
    alpha: float                 # fraction of budget given to topology
    saved_feat_bytes: float
    saved_topo_bytes: float


def solve_cost_model(node_hot: np.ndarray, edge_hot: np.ndarray,
                     degrees: np.ndarray, budget_bytes: int,
                     feat_row_bytes: int, group_size: int = 1,
                     granularity: float = 0.01,
                     feat_cacheable: bool = True,
                     topo_cacheable: bool = True) -> CachePlanResult:
    """``feat_cacheable`` / ``topo_cacheable`` encode placement: a cache
    saves host<->device bytes only for data that would otherwise cross
    the host boundary, so a side already in device memory gets zero
    budget however hot it is."""
    node_hot = np.asarray(node_hot, np.int64)
    edge_hot = np.asarray(edge_hot, np.int64)
    n = node_hot.shape[0]
    total = int(budget_bytes) * group_size

    # hotness-descending candidate orders (stable so ties are by id)
    feat_order = np.argsort(-node_hot, kind="stable").astype(np.int32)
    topo_order = np.argsort(-edge_hot, kind="stable").astype(np.int32)

    # total moved bytes if nothing were cached
    feat_hot_sorted = node_hot[feat_order].astype(np.float64)
    total_feat_bytes = float(feat_hot_sorted.sum()) * feat_row_bytes
    topo_hot_sorted = edge_hot[topo_order].astype(np.float64)
    row_bytes = (8.0 + 4.0 * np.asarray(degrees, np.float64))
    total_topo_bytes = float((edge_hot * row_bytes).sum())

    feat_prefix = np.concatenate([[0.0], np.cumsum(feat_hot_sorted)])
    topo_prefix = np.concatenate([[0.0], np.cumsum(topo_hot_sorted)])
    topo_mem_prefix = np.concatenate(
        [[0.0], np.cumsum(row_bytes[topo_order])])

    feat_total_hot = max(feat_prefix[-1], 1.0)
    topo_total_hot = max(topo_prefix[-1], 1.0)

    steps = max(int(round(1.0 / granularity)), 1)
    # uncacheable sides save zero bytes and take zero budget
    if not feat_cacheable and not topo_cacheable:
        return CachePlanResult(
            feat_order=feat_order, topo_order=topo_order,
            feat_capacity=0, topo_capacity=0, alpha=0.0,
            saved_feat_bytes=0.0, saved_topo_bytes=0.0)
    if not topo_cacheable:
        total_topo_bytes = 0.0
        alphas = [0]
    elif not feat_cacheable:
        total_feat_bytes = 0.0
        alphas = [steps]
    else:
        alphas = range(steps + 1)
    best = (-1.0, 0, 0, 0.0, 0.0, 0.0)
    for s in alphas:
        alpha = s / steps
        topo_mem = alpha * total
        feat_mem = total - topo_mem
        n_topo = int(np.searchsorted(topo_mem_prefix, topo_mem,
                                     side="right")) - 1
        n_topo = min(max(n_topo, 0), n)
        n_feat = min(int(feat_mem // max(feat_row_bytes, 1)), n)
        saved_t = total_topo_bytes * (topo_prefix[n_topo] / topo_total_hot)
        saved_f = total_feat_bytes * (feat_prefix[n_feat] / feat_total_hot)
        if saved_t + saved_f > best[0]:
            best = (saved_t + saved_f, n_feat, n_topo, alpha, saved_f, saved_t)

    _, n_feat, n_topo, alpha, saved_f, saved_t = best
    return CachePlanResult(
        feat_order=feat_order, topo_order=topo_order,
        feat_capacity=n_feat, topo_capacity=n_topo, alpha=alpha,
        saved_feat_bytes=saved_f, saved_topo_bytes=saved_t)
