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
  ascending id order) is the reference's exactly.
* ``grow_frontier_scatter`` / ``sample_batch_scatter`` are the
  position-map dedup (new ids appended in edge order). No driver uses it,
  in either package; it stands beside the sort dedup to be measured.

Randomness comes either from a ``torch.Generator`` or, for parity tests,
from explicit per-hop uniforms of shape ``(caps[k], fanouts[k])``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from legion_tpu_torch.data.format import host_tensor
from legion_tpu_torch.ops.gather import gather_rows
from legion_tpu_torch.ops.sample import sample_neighbors as sample_kernel
from legion_tpu_torch.sampling.block import Block, SampledBatch, frontier_caps

# Padding sentinel that sorts after every real node id (externally the
# padding is -1).
SENTINEL = torch.iinfo(torch.int32).max


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
    existing position; other group leaders are new ids, ranked by a
    cumsum (so appended in ascending id order). Positions reach the rest
    of each group by a "last leader wins" broadcast (a cummax over leader
    indices) and return to edge order through the sort permutation.

    Returns (frontier_new (cap_new,), num_new (), block)."""
    p, fanout = neighbors.shape
    prev_cap = frontier_prev.shape[0]
    dev = neighbors.device
    cat = torch.cat([
        torch.where(frontier_prev >= 0, frontier_prev, SENTINEL),
        torch.where(neighbors >= 0, neighbors, SENTINEL).reshape(-1)])
    total = cat.shape[0]
    s, sorig = torch.sort(cat, stable=True)

    first = s != SENTINEL
    first[1:] &= s[1:] != s[:-1]
    old_first = first & (sorig < prev_cap)
    new_first = first & (sorig >= prev_cap)
    new_rank = torch.cumsum(new_first, 0, dtype=torch.int32) - 1
    num_new = (num_prev + new_first.sum(dtype=torch.int32)).to(torch.int32)
    pos_at_first = torch.where(old_first, sorig.to(torch.int32),
                               num_prev + new_rank).to(torch.int32)

    # segmented broadcast leader -> group members
    idx = torch.arange(total, device=dev)
    leader = torch.cummax(torch.where(first, idx, 0), 0).values
    pos_sorted = torch.where(first, pos_at_first, 0)[leader]
    pos_orig = torch.empty_like(pos_sorted)
    pos_orig[sorig] = pos_sorted
    nbr_pos = pos_orig[prev_cap:].reshape(p, fanout)

    # frontier: first occurrences carry distinct in-range targets (old:
    # their prev index; new: num_prev + rank); everything else sorts to
    # the tail as cap_new and yields -1 padding
    target = torch.where(first & (pos_at_first < cap_new), pos_at_first,
                         cap_new)
    fval = torch.where(target < cap_new, s, -1)
    if total < cap_new:
        target = torch.cat([target, torch.full(
            (cap_new - total,), cap_new, dtype=torch.int32, device=dev)])
        fval = torch.cat([fval, torch.full(
            (cap_new - total,), -1, dtype=torch.int32, device=dev)])
    order = torch.sort(target, stable=True).indices[:cap_new]
    frontier_new = fval[order]

    nbr_mask = neighbors >= 0
    block = Block(nbr_pos=torch.where(nbr_mask, nbr_pos, 0),
                  nbr_mask=nbr_mask, num_src=num_new,
                  num_dst=num_prev.to(torch.int32))
    return frontier_new, num_new, block


def _scatter_drop(dest: torch.Tensor, index: torch.Tensor,
                  value: torch.Tensor, keep: torch.Tensor) -> None:
    """``dest[index[j]] = value[j]`` where ``keep[j]``, in place, the rest
    dropped (JAX's ``.at[].set(mode="drop")``), without a host sync. The
    kept indices must be distinct. A dropped entry rewrites slot 0 with
    the value that slot ends up with anyway, so whichever write lands
    last, the result is the same."""
    at0 = keep & (index == 0)
    # (a 0-d tensor used as an index would be read back by the host)
    v0 = torch.where(at0.any(),
                     value.gather(0, at0.to(torch.uint8).argmax().reshape(1)),
                     dest[:1])
    dest.scatter_(0, torch.where(keep, index, 0),
                  torch.where(keep, value, v0))


def stamp_frontier(frontier: torch.Tensor, pos_map: torch.Tensor,
                   stamp: torch.Tensor, stamp_val: torch.Tensor) -> None:
    """Enter a frontier of distinct ids (-1 padded) into the position map,
    in place: ``frontier[j]`` sits at position j under ``stamp_val``."""
    valid = frontier >= 0
    idx = torch.where(valid, frontier, 0).long()
    m = frontier.shape[0]
    _scatter_drop(pos_map, idx, torch.arange(m, dtype=torch.int32,
                                             device=frontier.device), valid)
    _scatter_drop(stamp, idx, stamp_val.to(torch.int32).expand(m), valid)


def grow_frontier_scatter(frontier_prev: torch.Tensor, num_prev: torch.Tensor,
                          neighbors: torch.Tensor, cap_new: int,
                          pos_map: torch.Tensor, stamp: torch.Tensor,
                          stamp_val: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, Block,
                                     torch.Tensor, torch.Tensor]:
    """Sort-free dedup through a dense position map, the reference's own
    structure (``position_map[N]``, ``src/Server.cu:222``,
    ``src/Kernels.cu:434-438``): an id is already in the frontier iff
    ``stamp[id] == stamp_val`` (so nothing is cleared between batches) and
    then sits at ``pos_map[id]``; among the edges that bring a new id the
    lowest edge index wins (a scatter-min into a scratch of N + 1, whose
    last slot takes the dropped entries) and new ids are appended in edge
    order, not in ascending id order. Otherwise ``grow_frontier``'s
    contract.

    ``pos_map`` and ``stamp`` are (N,) int32 carried across hops and
    batches and updated in place; before hop 1 the seeds must be stamped
    (``sample_batch_scatter`` does). Past ``cap_new`` the frontier's last
    slot holds the last overflowed id in edge order.

    Returns (frontier_new, num_new, block, pos_map, stamp)."""
    p, fanout = neighbors.shape
    n = pos_map.shape[0]
    e = p * fanout
    prev_cap = frontier_prev.shape[0]
    dev = neighbors.device
    ids = neighbors.reshape(-1)
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()

    is_old = valid & (stamp[safe] == stamp_val)
    cand = valid & ~is_old

    # winner election: the lowest edge index of each new id
    eidx = torch.arange(e, dtype=torch.int32, device=dev)
    scratch = torch.full((n + 1,), SENTINEL, dtype=torch.int32, device=dev)
    scratch.scatter_reduce_(0, torch.where(cand, safe, n), eidx, "amin")
    winner = cand & (scratch[safe] == eidx)

    new_rank = torch.cumsum(winner, 0, dtype=torch.int32) - 1
    newpos = (num_prev + new_rank).to(torch.int32)
    num_new = (num_prev + winner.sum(dtype=torch.int32)).to(torch.int32)

    _scatter_drop(pos_map, safe, newpos, winner)
    _scatter_drop(stamp, safe, stamp_val.to(torch.int32).expand(e), winner)

    # winners below the last slot land on distinct targets; the last slot
    # takes the last winner at or past it (duplicate writes there would
    # land in any order), everything else goes to a sink slot
    frontier_new = torch.full((cap_new + 1,), -1, dtype=torch.int32,
                              device=dev)
    frontier_new[:prev_cap] = frontier_prev
    frontier_new.scatter_(
        0, torch.where(winner & (newpos < cap_new - 1), newpos,
                       cap_new).long(), ids)
    tail = torch.where(winner & (newpos >= cap_new - 1), eidx, -1).max()
    frontier_new = frontier_new[:cap_new]
    frontier_new[cap_new - 1:] = torch.where(
        tail >= 0, ids.gather(0, tail.clamp(min=0).long().reshape(1)),
        frontier_new[cap_new - 1:])

    nbr_pos = pos_map[safe].reshape(p, fanout)
    nbr_mask = neighbors >= 0
    block = Block(nbr_pos=torch.where(nbr_mask, nbr_pos, 0),
                  nbr_mask=nbr_mask, num_src=num_new,
                  num_dst=num_prev.to(torch.int32))
    return frontier_new, num_new, block, pos_map, stamp


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


def sample_batch_scatter(graph: DeviceGraph, seeds: torch.Tensor,
                         num_seeds: torch.Tensor, labels: torch.Tensor,
                         fanouts: Sequence[int], caps: Sequence[int],
                         pos_map: torch.Tensor, stamp: torch.Tensor,
                         stamp_val: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         uniforms: Optional[Sequence[torch.Tensor]] = None):
    """``sample_batch`` with the position-map dedup
    (``grow_frontier_scatter``) on every hop. ``pos_map`` and ``stamp`` are
    (num_nodes,) int32, carried across batches and updated in place;
    ``stamp_val`` (a 0-d int32 tensor) must be new for every batch (e.g.
    step + 1; 0 is the value of a fresh ``stamp``). Randomness as in
    ``sample_batch``.

    Returns (SampledBatch, pos_map, stamp)."""
    caps = tuple(caps)
    if (uniforms is None) == (generator is None):
        raise ValueError("pass exactly one of generator and uniforms")
    dev = seeds.device
    stamp_frontier(seeds, pos_map, stamp, stamp_val)

    frontier = torch.full((caps[0],), -1, dtype=torch.int32, device=dev)
    frontier[: seeds.shape[0]] = seeds
    num = num_seeds.to(torch.int32)
    blocks = []
    for k, fanout in enumerate(fanouts):
        u = (uniforms[k] if uniforms is not None else
             torch.rand((caps[k], fanout), generator=generator, device=dev,
                        dtype=torch.float32))
        nbrs = sample_neighbors(graph, frontier, u)
        frontier, num, blk, pos_map, stamp = grow_frontier_scatter(
            frontier, num, nbrs, caps[k + 1], pos_map, stamp, stamp_val)
        blocks.append(blk)
    batch = SampledBatch(seeds=seeds, labels=labels,
                         num_seeds=num_seeds.to(torch.int32),
                         frontier=frontier, num_frontier=num,
                         blocks=tuple(blocks))
    return batch, pos_map, stamp


def gather_features(features: torch.Tensor,
                    frontier: torch.Tensor) -> torch.Tensor:
    """Feature rows of a (padded) frontier from a device-resident table,
    through the gather kernel (K3). Padded slots give zero rows: the
    kernel zeroes them at no extra cost, so the reference's
    ``mask_invalid`` option has no counterpart here."""
    return gather_rows(features, frontier)
