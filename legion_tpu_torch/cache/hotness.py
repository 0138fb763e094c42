"""Presampling hotness measurement (port of
``legion_tpu/cache/hotness.py``): ``presample_hotness``,
``observed_caps`` and ``host_frontier_probe``, and
``probe_frontier_maxima``, the device probe that the ``Trainer`` and the
bench size their caps from.

The reference dedicates a profiling epoch before training: sampling runs
without feature extraction while per-node access counters accumulate
(``src/Kernels.cu:525``, ``src/GPUCache.cu:227-235``), and the realized
frontier sizes size the buffers at 1.2x (``src/Server.cu:273-282``). Here
the epoch is a Python loop of the device sampler; the histograms are
``index_add_`` into (N,) int32 device tensors and the observed counts stay
device tensors, so the loop never waits for the device. The port may not
import ``legion_tpu.cache``, whose ``__init__`` loads JAX;
``tests/test_torch_cache.py`` and ``tests/test_torch_sampler.py`` hold
the two equal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch


class HotnessResult(NamedTuple):
    node_hot: torch.Tensor      # (N,) int32: feature-access counts
    edge_hot: torch.Tensor      # (N,) int32: adjacency-row read counts
    max_frontier: torch.Tensor  # () int32: max unique nodes per batch
    max_per_hop: torch.Tensor   # (hops+1,) int32: max valid count per level


def presample_hotness(graph: DeviceGraph, seeds_epoch: torch.Tensor,
                      num_seeds: torch.Tensor, fanouts: Sequence[int],
                      caps: Sequence[int], num_nodes: int,
                      generator: Optional[torch.Generator] = None,
                      uniforms: Optional[Sequence[Sequence[torch.Tensor]]]
                      = None) -> HotnessResult:
    """Run a presampling epoch and return hotness histograms.

    seeds_epoch: (steps, seed_cap) int32 and num_seeds: (steps,) int32, on
    the graph's device. Randomness: ``uniforms[i]`` (the per-hop uniforms
    of step i, see ``sample_batch``) when given, else ``generator``.

    Feature hotness counts every unique frontier membership (those rows
    would be gathered); topology hotness counts every time a node's
    adjacency row is read by a sampler hop (every level but the
    outermost, whose nodes are never expanded)."""
    fanouts, caps = tuple(fanouts), tuple(caps)
    dev = seeds_epoch.device
    node_hot = torch.zeros((num_nodes,), dtype=torch.int32, device=dev)
    edge_hot = torch.zeros((num_nodes,), dtype=torch.int32, device=dev)
    max_frontier = torch.zeros((), dtype=torch.int32, device=dev)
    max_per_hop = torch.zeros((len(fanouts) + 1,), dtype=torch.int32,
                              device=dev)
    slot = torch.arange(caps[-1], dtype=torch.int32, device=dev)
    for i in range(seeds_epoch.shape[0]):
        seeds = seeds_epoch[i]
        batch = sample_batch(
            graph, seeds, num_seeds[i], torch.zeros_like(seeds), fanouts,
            caps, dedup_last=True,
            generator=None if uniforms is not None else generator,
            uniforms=None if uniforms is None else uniforms[i])
        fvalid = batch.frontier >= 0
        fids = torch.where(fvalid, batch.frontier, 0).long()
        node_hot.index_add_(0, fids, fvalid.to(torch.int32))
        # rows read: every valid node of every level but the last; the
        # level-k node set is the frontier's first num_k entries (prefix
        # numbering), so one masked add per level suffices
        levels = [batch.num_seeds] + [b.num_src for b in batch.blocks]
        for nvalid in levels[:len(fanouts)]:
            edge_hot.index_add_(0, fids,
                                ((slot < nvalid) & fvalid).to(torch.int32))
        max_frontier = torch.maximum(max_frontier, batch.num_frontier)
        max_per_hop = torch.maximum(max_per_hop,
                                    torch.stack(levels).to(torch.int32))
    return HotnessResult(node_hot, edge_hot, max_frontier, max_per_hop)


def observed_caps(max_per_hop, slack: float = 1.2, align: int = 8,
                  last_exact_fanout: int | None = None) -> Tuple[int, ...]:
    """Tightened static frontier caps from presampling observation —
    the reference's 1.2 x MaxIdNum buffer sizing (src/Server.cu:275)
    turned into tighter static shapes.

    last_exact_fanout: set to fanouts[-1] when the consumer samples with
    dedup_last=False — the final cap is then the exact identity-append
    extent caps[-2]*(1+fanout), not an observed (deduped) count.
    """
    if isinstance(max_per_hop, torch.Tensor):
        max_per_hop = max_per_hop.cpu().numpy()
    m = np.asarray(max_per_hop)
    caps = np.ceil(m * slack / align).astype(int) * align
    caps = np.maximum.accumulate(caps)
    if last_exact_fanout is not None:
        caps[-1] = caps[-2] * (1 + last_exact_fanout)
    return tuple(int(c) for c in caps)


def probe_frontier_maxima(graph: DeviceGraph, seed_batches, fanouts,
                          loose: Sequence[int],
                          generator: torch.Generator) -> np.ndarray:
    """Per-level maxima of the realized frontier sizes (the seeds, then
    each hop's ``num_src``) over ``seed_batches``, each sampled at the
    ``loose`` caps with ``generator`` under no_grad: the counts that
    ``observed_caps`` tightens the caps to. ``seed_batches`` yields
    (seeds, num_seeds) int32 device tensors. Reads the counts on the
    host: a set-up sync a batch."""
    fanouts = tuple(fanouts)
    mx = np.zeros(len(fanouts) + 1, np.int64)
    with torch.no_grad():
        for seeds, num in seed_batches:
            batch = sample_batch(graph, seeds, num, torch.zeros_like(seeds),
                                 fanouts, loose, generator=generator)
            counts = torch.stack([batch.num_seeds] + [
                blk.num_src for blk in batch.blocks]).tolist()
            mx = np.maximum(mx, counts)
    return mx


def host_frontier_probe(indptr, indices, seed_batches, fanouts, caps,
                        visit, rng: np.random.Generator,
                        seed_base: int = 0) -> None:
    """Grow multi-hop frontiers with the host sampler for probe statistics
    (numpy and the C++ runtime; nothing on the device): the engine behind
    the host-side owner-cap probe of the striped hybrid driver. Hop h of
    batch bi is seeded ``seed_base + bi * 997 + h``; a grown frontier past
    its hop's cap is cut to a random subset (cutting the sorted unique
    array would favour low ids).

    ``visit(hop, frontier)`` is called with the frontier each hop samples
    from (hop in [0, len(fanouts))) and once more with hop ==
    len(fanouts) for the final, feature-fetch frontier."""
    from legion_tpu_torch import runtime
    indptr = np.ascontiguousarray(np.asarray(indptr), np.int64)
    indices = np.ascontiguousarray(np.asarray(indices), np.int32)
    for bi, seeds in enumerate(seed_batches):
        seeds = np.asarray(seeds)
        frontier = seeds[seeds >= 0].astype(np.int64)
        for hop, f in enumerate(fanouts):
            visit(hop, frontier)
            nbrs = runtime.sample_neighbors(
                indptr, indices, frontier.astype(np.int32), f,
                seed=seed_base + bi * 997 + hop)
            grown = np.unique(np.concatenate(
                [frontier, nbrs[nbrs >= 0].astype(np.int64)]))
            if len(grown) > caps[hop + 1]:
                grown = grown[rng.permutation(len(grown))[: caps[hop + 1]]]
            frontier = grown
        visit(len(fanouts), frontier)
