"""Edge-partitioned sampling and the halo feature exchange (port of
``legion_tpu/parallel/halo.py``).

The graph is k-way partitioned (``data/partition.py``) and rank p of the
process group holds partition p only: its owned node ids sorted, the CSR
rows of those nodes (``sub_indptr`` over ``sub_indices``, which hold
global neighbor ids) and their feature rows (``HostShard``). A global id
finds its local row by ``searchsorted`` over the owned ids, so no rank
keeps an (N,) map of another's rows. The two cross-rank needs of a
sampled step become collectives over the group:

* **remote neighbor expansion**: a hop's frontier holds nodes other ranks
  own; their owner draws their neighbors;
* **the halo feature fetch**: rows of nodes other ranks own come from
  their owner.

Each has two exchanges:

* **exact** (``partitioned_sample_hop_exact``,
  ``partitioned_row_fetch_exact``): requests are grouped by ring distance
  r = (owner - me) % k; for each r = 1..k-1 the requests go one
  ``comm.ppermute`` forward to their owner and the answers come one back,
  in buffers of the static per-distance cap ``dist_caps[r - 1]``, so a
  request crosses the links once. Self-requests are served here and never
  enter a collective. Requests past a cap come back as zero rows or -1
  draws and are counted (the driver meters them as ``halo_overflow``).
* **psum** (``partitioned_sample_hop``, ``partitioned_row_fetch``): an
  all-gather of every rank's requests, a local answer to those this rank
  owns (zero elsewhere; draws encoded as id + 1) and a reduce-scatter that
  sums them back to their requesters: k times the bytes, free of caps; the
  oracle.

The reference groups by distance with a one-hot cumsum and a stable sort
(``_dist_grouping``, ``_round_send``); here the send buffers of every
distance are one scatter at (distance, position within it), which gives
the same buffers, positions and overflow (``route_by_distance``).

Every draw is the sampling kernel (``ops/sample.py``) on the shard's
compact CSR, the frontier given as ``where(mine, local_row, -1)``: the
reference's draw ``sub_indices[start + min(int(u * deg), deg - 1)]``,
-1 where not owned, where ``slot >= deg`` or ``deg == 0``. Owned feature
rows are served by the gather kernel K3 (``ops/gather.py``, -1 for a zero
row), which also puts the answers back in request order. The draw grid
is the reference's: each rank draws one (k * M, fanout) float32 grid a hop,
and requester c's slot j is drawn by its owner from the owner's grid at
row c * M + j, so the exact and the psum exchange draw bitwise the same
neighbors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from legion_tpu_torch.ops.gather import gather_rows
from legion_tpu_torch.ops.sample import sample_neighbors
from legion_tpu_torch.parallel.feature_exchange import group_positions
from legion_tpu_torch.utils import comm

INT32_MAX = int(np.iinfo(np.int32).max)


class HostShard(NamedTuple):
    """One rank's partition of the graph, on its device."""

    owned_ids: torch.Tensor    # (C,) int32 global ids ascending, INT32_MAX pad
    sub_indptr: torch.Tensor   # (C+1,) int32 CSR over the owned rows
    sub_indices: torch.Tensor  # (E_local,) int32 global neighbor ids, -1 pad
    feat_rows: torch.Tensor    # (C, D) float32 features of the owned nodes

    @staticmethod
    def part_shapes(indptr, partition: np.ndarray, num_parts: int):
        """Each part's (row count, edge count) from the partition vector
        and the degrees alone, with no adjacency read: every rank agrees
        on the padded shapes without seeing another's part."""
        deg = np.diff(np.asarray(indptr)).astype(np.int64)
        rows = np.bincount(partition, minlength=num_parts).astype(np.int64)
        edges = np.bincount(partition, weights=deg,
                            minlength=num_parts).astype(np.int64)
        return rows, edges

    @staticmethod
    def build_one(indptr, indices, features, partition: np.ndarray, p: int,
                  pad_rows: int, pad_edges: int):
        """Part p's padded arrays (numpy ``owned_ids``, ``sub_indptr``,
        ``sub_indices``, ``feat_rows``); reads no other part's adjacency
        or feature rows. Node ids must stay below 2^31 - 1, the padding of
        ``owned_ids``."""
        indptr = np.asarray(indptr)
        n = indptr.shape[0] - 1
        if n >= INT32_MAX:
            raise ValueError(f"{n} nodes: ids must stay below 2^31 - 1, the "
                             "padding of owned_ids")
        owned = np.flatnonzero(np.asarray(partition) == p).astype(np.int32)
        degs = (indptr[owned + 1] - indptr[owned]).astype(np.int64)
        c, total = len(owned), int(degs.sum())
        sp_p = np.full(pad_rows + 1, total, np.int64)
        sp_p[0] = 0
        np.cumsum(degs, out=sp_p[1:c + 1])
        # each edge's address in the whole CSR: its row's start plus its
        # place in the row
        src = np.repeat(indptr[owned].astype(np.int64) - sp_p[:c], degs)
        src += np.arange(total, dtype=np.int64)
        si_p = np.full(pad_edges, -1, np.int32)
        si_p[:total] = np.asarray(indices)[src]
        del src
        owned_p = np.full(pad_rows, INT32_MAX, np.int32)
        owned_p[:c] = owned
        features = np.asarray(features)
        fr_p = np.zeros((pad_rows, features.shape[1]), np.float32)
        np.take(features, owned, axis=0, out=fr_p[:c])
        return owned_p, sp_p.astype(np.int32), si_p, fr_p

    @staticmethod
    def build(indptr, indices, features, partition: np.ndarray,
              num_parts: int, pad_to: Tuple[int, int] | None = None):
        """Every part's arrays (``build_one``), padded to the largest part's
        (row, edge) counts, or ``pad_to`` where larger."""
        rows, edges = HostShard.part_shapes(indptr, partition, num_parts)
        max_c, max_e = int(rows.max()), max(int(edges.max()), 1)
        if pad_to:
            max_c, max_e = max(max_c, pad_to[0]), max(max_e, pad_to[1])
        return [HostShard.build_one(indptr, indices, features, partition,
                                    p, max_c, max_e)
                for p in range(num_parts)]

    @classmethod
    def to_device(cls, arrays, device: torch.device | str) -> "HostShard":
        """A shard on ``device`` from ``build_one``'s numpy arrays."""
        return cls(*(torch.from_numpy(a).to(device) for a in arrays))


def _local_lookup(owned_ids: torch.Tensor, ids: torch.Tensor):
    """(mine (M,) bool, local row (M,) int32) of global int32 ids; padding
    (< 0) is never mine. ``searchsorted`` runs left-sided on the int32
    owned ids, whose INT32_MAX padding keeps every result in range."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0)
    pos = torch.searchsorted(owned_ids, safe, out_int32=True).clamp(
        0, owned_ids.shape[0] - 1)
    return valid & (owned_ids.index_select(0, pos) == safe), pos


def _draw(shard: HostShard, ids: torch.Tensor,
          u: torch.Tensor) -> torch.Tensor:
    """(M, fanout) draws for the ids this shard owns (-1 elsewhere), one
    row of uniforms each: the sampling kernel on the compact CSR."""
    mine, row = _local_lookup(shard.owned_ids, ids)
    return sample_neighbors(shard.sub_indptr, shard.sub_indices,
                            torch.where(mine, row, -1), u)


def _serve_rows(shard: HostShard, ids: torch.Tensor) -> torch.Tensor:
    """(M, D) feature rows of the ids this shard owns, zero elsewhere
    (K3)."""
    mine, row = _local_lookup(shard.owned_ids, ids)
    return gather_rows(shard.feat_rows, torch.where(mine, row, -1))


def partitioned_sample_hop(shard: HostShard, u: torch.Tensor,
                           frontier: torch.Tensor, group=None) -> torch.Tensor:
    """One sampling hop over the partitioned graph, the psum exchange.
    frontier: (M,) int32 global ids, -1 padded; u: (k * M, fanout) float32,
    this rank's grid. Returns (M, fanout) int32 neighbor ids with the -1
    rules of the single-device sampler. The owner's draw travels as id + 1
    (0 elsewhere), summed in int32."""
    all_ids = comm.all_gather(frontier, group)                 # (k * M,)
    contrib = _draw(shard, all_ids, u) + 1
    return comm.reduce_scatter(contrib, group) - 1


def partitioned_row_fetch(shard: HostShard, ids: torch.Tensor,
                          group=None) -> torch.Tensor:
    """Rows of the global ``ids`` (zero for -1), the psum exchange: every
    rank's requests ride the all-gather and the reduce-scatter."""
    return comm.reduce_scatter(
        _serve_rows(shard, comm.all_gather(ids, group)), group)


def ring_distance(owner_of: torch.Tensor, ids: torch.Tensor, me: int,
                  k: int) -> torch.Tensor:
    """(M,) int32 ring distance (owner - me) % k of each id's owner, k for
    padding. owner_of: (N,) int8 partition ids."""
    valid = ids >= 0
    owner = owner_of.index_select(0, torch.where(valid, ids, 0)).to(
        torch.int32)
    return torch.where(valid, (owner - me) % k, k)


def route_by_distance(ids: torch.Tensor, dist_: torch.Tensor, k: int,
                      dist_caps: Sequence[int],
                      payload: Optional[torch.Tensor] = None):
    """Group the remote requests by ring distance into one flat send buffer
    of sum(dist_caps) slots: distance r's first ``dist_caps[r - 1]``
    requests in request order at [off_r, off_r + cap_r), -1 on empty
    slots. Returns (send, slot (M,) int32: a request's place in the buffer,
    -1 where it is not sent (self, padding, past its cap), overflow ()
    int32 requests past the caps[, the payload routed the same way, 0 on
    empty slots]). No host sync: the caps are Python ints."""
    pos, counts = group_positions(dist_, k)
    off = cap = torch.zeros_like(pos)
    overflow = torch.zeros((), dtype=torch.int32, device=ids.device)
    for r, start, c in _rounds(dist_caps):
        at = dist_ == r
        off = torch.where(at, start, off)
        cap = torch.where(at, c, cap)
        overflow = overflow + (counts[r] - c).clamp(min=0)
    total = int(sum(dist_caps))
    sent = (dist_ > 0) & (dist_ < k) & (pos < cap)
    slot = torch.where(sent, off + pos, -1).to(torch.int32)
    dest = torch.where(sent, slot, total).long()
    send = torch.full((total + 1,), -1, dtype=torch.int32, device=ids.device)
    send.scatter_(0, dest, ids.to(torch.int32))
    if payload is None:
        return send[:total], slot, overflow
    pay = torch.zeros((total + 1,), dtype=torch.int32, device=ids.device)
    pay.scatter_(0, dest, payload.to(torch.int32))
    return send[:total], slot, overflow, pay[:total]


def _rounds(dist_caps: Sequence[int]):
    """(r, start, cap) of each ring distance r's slice [start, start +
    cap) of the send buffer."""
    start = 0
    for r, c in enumerate(dist_caps, start=1):
        yield r, start, int(c)
        start += int(c)


def partitioned_row_fetch_exact(shard: HostShard, owner_of: torch.Tensor,
                                ids: torch.Tensor, dist_caps: Sequence[int],
                                group=None):
    """Rows of the global ``ids`` through the exact exchange. owner_of:
    (N,) int8 partition id of every node (replicated); dist_caps: k - 1
    static caps, ``dist_caps[r - 1]`` for ring distance r. Returns ((M, D)
    rows, zero for padding and for requests past a cap; () int32 count of
    those capped requests). K3 serves the self-requests, each distance's
    requests at their owner, and puts the answers in request order."""
    k = dist.get_world_size(group)
    me = dist.get_rank(group)
    dist_ = ring_distance(owner_of, ids, me, k)
    out = _serve_rows(shard, torch.where(dist_ == 0, ids, -1))
    if k == 1:
        return out, torch.zeros((), dtype=torch.int32, device=ids.device)
    send, slot, overflow = route_by_distance(ids, dist_, k, dist_caps)
    resp = []
    for r, start, cap in _rounds(dist_caps):
        req = comm.ppermute(send[start:start + cap], r, group)
        resp.append(comm.ppermute(_serve_rows(shard, req), -r, group))
    remote = gather_rows(torch.cat(resp), slot)
    return torch.where((slot >= 0)[:, None], remote, out), overflow


def partitioned_sample_hop_exact(shard: HostShard, owner_of: torch.Tensor,
                                 u: torch.Tensor, frontier: torch.Tensor,
                                 dist_caps: Sequence[int], group=None):
    """One sampling hop through the exact exchange; the draws are bitwise
    the psum hop's (each request's row of the requester-major grid rides
    along, so its owner draws it from the same row). u: (k * M, fanout)
    float32, this rank's grid. Returns ((M, fanout) int32 neighbor ids,
    -1 for requests past a cap too; () int32 count of those)."""
    k = dist.get_world_size(group)
    me = dist.get_rank(group)
    m = frontier.shape[0]
    dist_ = ring_distance(owner_of, frontier, me, k)
    # my own requests' grid rows are the contiguous block me * m + j
    out = _draw(shard, torch.where(dist_ == 0, frontier, -1),
                u[me * m:(me + 1) * m])
    if k == 1:
        return out, torch.zeros((), dtype=torch.int32, device=u.device)
    gidx = torch.arange(me * m, (me + 1) * m, dtype=torch.int32,
                        device=frontier.device)
    send, slot, overflow, send_g = route_by_distance(
        frontier, dist_, k, dist_caps, payload=gidx)
    resp = []
    for r, start, cap in _rounds(dist_caps):
        req = comm.ppermute(torch.stack(
            [send[start:start + cap], send_g[start:start + cap]], 1), r, group)
        rows = u.index_select(0, req[:, 1].clamp(0, k * m - 1))
        resp.append(comm.ppermute(_draw(shard, req[:, 0], rows), -r, group))
    got = torch.cat(resp).index_select(0, slot.clamp(min=0))
    return torch.where((slot >= 0)[:, None], got, out), overflow
