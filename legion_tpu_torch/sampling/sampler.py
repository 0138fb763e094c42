"""On-device neighbor sampling in PyTorch (main-path port of
``legion_tpu/sampling/sampler.py``).

Static shapes and no host sync: every count stays a 0-d device tensor,
so a later change can capture the whole step as one CUDA graph.

What is carried over, and what is not:

* ``DeviceGraph`` is a plain int32 CSR. The reference's lined, aligned
  and windowed layouts and its lane select (K4) exist to cut TPU DMA
  descriptors; the H100 reads the CSR directly, in the sampling kernel
  (``ops/sample.py``), for node ids of any int32 width.
* Sampling has the semantics of ``sample_neighbors_per_edge``
  (``sampler.py:258``), the bit-identical oracle of every JAX layout:
  given the same uniforms, the port draws the same neighbors.
* ``grow_frontier`` reproduces the reference's stable sort-based dedup,
  so the numbering ``[seeds | hop1-new | hop2-new]`` (new ids appended in
  ascending id order) is the reference's exactly. After the sort, one
  kernel (``ops/dedup.py``) numbers the groups and writes the frontier and
  the block. The reference's position-map dedup
  (``grow_frontier_scatter``, new ids in edge order) has no counterpart:
  no driver of either package uses it.

Randomness comes either from a ``torch.Generator`` or, for parity tests,
from explicit per-hop uniforms of shape ``(caps[k], fanouts[k])``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from legion_tpu_torch.data.format import host_tensor
from legion_tpu_torch.ops.dedup import SENTINEL, dedup_tail
from legion_tpu_torch.ops.gather import gather_rows
from legion_tpu_torch.ops.sample import sample_neighbors as sample_kernel
from legion_tpu_torch.sampling.block import Block, SampledBatch, frontier_caps


class DeviceGraph:
    """CSR topology resident in device memory: ``indptr`` (N+1,) and
    ``indices`` (E,) int32. int32 addressing caps the on-device topology
    below 2^31 edges, as in the reference."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor):
        self.indptr = indptr
        self.indices = indices

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @classmethod
    def from_host(cls, indptr, indices,
                  device: torch.device | str) -> "DeviceGraph":
        if int(indptr[-1]) >= 2 ** 31:
            raise ValueError("on-device CSR needs < 2^31 edges")
        indptr = np.asarray(indptr).astype(np.int32)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        if indices.shape[0] == 0:
            # keep clamped reads in bounds; every slot is masked anyway
            indices = np.zeros(1, np.int32)
        # an int32 memmap goes to the device as it is, without a host copy
        return cls(torch.from_numpy(indptr).to(device),
                   host_tensor(indices).to(device))


def sample_neighbors(graph: DeviceGraph, frontier: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """One hop of uniform-with-replacement sampling, through the sampling
    kernel (``ops/sample.py``).

    frontier: (P,) int32 global ids, -1 padded; u: (P, fanout) float32
    uniforms in [0, 1). Returns (P, fanout) int32 neighbor ids, -1 where
    the slot is invalid (padded source, or slot >= degree)."""
    return sample_kernel(graph.indptr, graph.indices, frontier, u)


def grow_frontier(frontier_prev: torch.Tensor, num_prev: torch.Tensor,
                  neighbors: torch.Tensor, cap_new: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, Block]:
    """Dedup the sampled hop and extend the frontier, keeping the prefix.

    One stable sort of ``[prev | neighbors]`` by id: each id's prev
    occurrence (if any) leads its group and its origin index is its
    existing position; other group leaders are new ids, appended in
    ascending id order. The rest, numbering every group and writing the
    frontier and the block, is the dedup's tail (``ops/dedup.py``): one
    kernel on a card, its plain version on the CPU.

    Returns (frontier_new (cap_new,), num_new (), block)."""
    cat = torch.cat([
        torch.where(frontier_prev >= 0, frontier_prev, SENTINEL),
        torch.where(neighbors >= 0, neighbors, SENTINEL).reshape(-1)])
    s, sorig = torch.sort(cat, stable=True)
    num_dst = num_prev.to(torch.int32)
    frontier_new, num_new, nbr_pos = dedup_tail(
        s, sorig, frontier_prev, num_dst.to(s.device), cap_new)
    block = Block(nbr_pos=nbr_pos.reshape(neighbors.shape),
                  nbr_mask=neighbors >= 0, num_src=num_new, num_dst=num_dst)
    return frontier_new, num_new, block


def append_frontier(frontier_prev: torch.Tensor, num_prev: torch.Tensor,
                    neighbors: torch.Tensor, cap_new: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, Block]:
    """Grow the frontier without dedup: every sampled (dst, slot) edge gets
    its own appended src row (invalid slots leave -1 holes). cap_new must
    equal prev_cap + dst_cap * fanout. Returns (frontier_new, extent,
    block with identity_offset)."""
    p, fanout = neighbors.shape
    prev_cap = frontier_prev.shape[0]
    if cap_new != prev_cap + p * fanout:
        raise ValueError(f"append cap {cap_new} != {prev_cap} + {p}*{fanout}")
    dev = neighbors.device
    nbr_mask = neighbors >= 0
    appended = torch.where(nbr_mask, neighbors, -1).reshape(-1)
    frontier_new = torch.cat([frontier_prev, appended])
    extent = torch.full((), cap_new, dtype=torch.int32, device=dev)
    nbr_pos = (prev_cap + torch.arange(p * fanout, dtype=torch.int32,
                                       device=dev)).reshape(p, fanout)
    block = Block(nbr_pos=nbr_pos, nbr_mask=nbr_mask, num_src=extent,
                  num_dst=num_prev.to(torch.int32), identity_offset=prev_cap)
    return frontier_new, extent, block


def sample_batch(graph: DeviceGraph, seeds: torch.Tensor,
                 num_seeds: torch.Tensor, labels: torch.Tensor,
                 fanouts: Sequence[int],
                 caps: Sequence[int] | None = None,
                 dedup_last: bool = True,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Sequence[torch.Tensor]] = None
                 ) -> SampledBatch:
    """Full multi-hop sampling of one mini-batch.

    seeds: (seed_cap,) int32 padded with -1, unique within the batch.
    Randomness: ``uniforms[k]`` of shape (caps[k], fanouts[k]) when given,
    else drawn from ``generator`` (which must live on seeds' device).
    dedup_last=False identity-appends the final hop (append_frontier);
    it needs caps[-1] == caps[-2] * (1 + fanouts[-1]).
    """
    if caps is None:
        caps = frontier_caps(seeds.shape[0], fanouts)
    if caps[0] < seeds.shape[0]:
        raise ValueError(f"caps[0]={caps[0]} < seed cap {seeds.shape[0]}")
    if (uniforms is None) == (generator is None):
        raise ValueError("pass exactly one of generator and uniforms")
    dev = seeds.device
    frontier = torch.full((caps[0],), -1, dtype=torch.int32, device=dev)
    frontier[: seeds.shape[0]] = seeds
    num = num_seeds.to(torch.int32)
    blocks = []
    for k, fanout in enumerate(fanouts):
        if uniforms is not None:
            u = uniforms[k]
            if tuple(u.shape) != (caps[k], fanout):
                raise ValueError(f"uniforms[{k}] shape {tuple(u.shape)} != "
                                 f"{(caps[k], fanout)}")
        else:
            u = torch.rand((caps[k], fanout), generator=generator,
                           device=dev, dtype=torch.float32)
        nbrs = sample_neighbors(graph, frontier, u)
        grow = (append_frontier if k == len(fanouts) - 1 and not dedup_last
                else grow_frontier)
        frontier, num, blk = grow(frontier, num, nbrs, caps[k + 1])
        blocks.append(blk)
    return SampledBatch(seeds=seeds, labels=labels,
                        num_seeds=num_seeds.to(torch.int32),
                        frontier=frontier, num_frontier=num,
                        blocks=tuple(blocks))


def gather_features(features: torch.Tensor,
                    frontier: torch.Tensor) -> torch.Tensor:
    """Feature rows of a (padded) frontier from a device-resident table,
    through the gather kernel (K3). Padded slots give zero rows: the
    kernel zeroes them at no extra cost, so the reference's
    ``mask_invalid`` option has no counterpart here."""
    return gather_rows(features, frontier)
