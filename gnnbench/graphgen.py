"""The cell's inputs, made on the device from the run's seed.

A frozen torch copy of the port's synthetic generator
(``legion_tpu_torch/data/synthetic.py::streaming_power_law_graph``, with
``bench_graph``'s Gaussian features and random labels): Poisson in-degrees
around the configuration's average, neighbour sources Zipf(alpha)-popular
over a permuted id space, Gaussian float32 features, labels uniform over
the classes, and disjoint train / valid / test ids of the configuration's
sizes. Every array is drawn by a ``torch.Generator`` on ``device`` in a few
large calls and then copied once to host memory, where the port's drivers
take their ``GraphData``. The same seed gives the same arrays on the same
kind of card.
"""

from __future__ import annotations

import dataclasses

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
    features: np.ndarray      # (N, F) float32
    labels: np.ndarray        # (N,) int32
    train_ids: np.ndarray     # (T,) int32
    valid_ids: np.ndarray     # (V,) int32
    test_ids: np.ndarray      # (S,) int32


def make_inputs(graph: dict, seed: int, device) -> Inputs:
    """The graph of a configuration (its ``num_nodes``,
    ``avg_in_degree``, ``zipf_alpha``, ``feature_dim``, ``num_classes``,
    ``train_nodes``, ``valid_nodes``, ``test_nodes``) from ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = int(graph["num_nodes"])
    f = int(graph["feature_dim"])

    rate = torch.full((n,), float(graph["avg_in_degree"]),
                      dtype=torch.float32, device=dev)
    counts = torch.poisson(rate, generator=gen).to(torch.int64)
    del rate
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=indptr[1:])
    del counts
    e = int(indptr[-1])

    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks.pow_(-float(graph["zipf_alpha"])), 0)
    cdf /= cdf[-1].clone()
    del ranks
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    indices = np.empty(e, np.int32)
    for s in range(0, e, EDGE_CHUNK):
        m = min(EDGE_CHUNK, e - s)
        u = torch.rand(m, dtype=torch.float64, generator=gen, device=dev)
        pos = torch.searchsorted(cdf, u).clamp_(max=n - 1)
        torch.from_numpy(indices[s:s + m]).copy_(perm[pos])
    del cdf, perm

    features = np.empty((n, f), np.float32)
    for s in range(0, n, ROW_CHUNK):
        m = min(ROW_CHUNK, n - s)
        torch.from_numpy(features[s:s + m]).copy_(
            torch.randn((m, f), generator=gen, device=dev))
    labels = torch.randint(0, int(graph["num_classes"]), (n,),
                           generator=gen, device=dev, dtype=torch.int32)
    t, v, s_ = (int(graph[k]) for k in
                ("train_nodes", "valid_nodes", "test_nodes"))
    ids = torch.randperm(n, generator=gen, device=dev)[:t + v + s_].to(
        torch.int32).cpu().numpy()
    return Inputs(indptr=indptr.cpu().numpy(), indices=indices,
                  features=features, labels=labels.cpu().numpy(),
                  train_ids=ids[:t], valid_ids=ids[t:t + v],
                  test_ids=ids[t + v:])
