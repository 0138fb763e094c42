"""Striped feature storage and the row exchange over a cache group (port
of ``legion_tpu/parallel/feature_exchange.py``).

The reference (Legion) interleaves hot rows round-robin over the ``Kg``
GPUs of an NVLink clique (``InitPair`` value ``(idx % Kg) * cap + idx /
Kg``, ``src/GPUCache.cu:103-108``) and reads remote rows through peer
pointers (``src/Kernels.cu:695-699``). The JAX package serves the same
striping with collectives over the mesh's ``cache`` axis; here the
collectives run over a cache group's ``dist`` group
(``parallel.mesh.Mesh.group``), through the counting wrappers of
``utils.comm``. Row r lives on rank r % k of the group, at slot r // k.

Two exchanges:

* **exact** (``sharded_row_fetch_stats``): the requests are grouped by
  owner into a (k, cap) send buffer, sent to their owners by one
  all-to-all, served there by the gather kernel K3 (``ops/gather.py``),
  and the rows come straight back by a second all-to-all, where K3 puts
  them back in request order. Requests past an owner's cap read zero rows
  and are counted.
* **psum** (``sharded_row_fetch_psum``): an all-gather of every rank's
  ids, a local K3 gather of the rows this rank owns, and a reduce-scatter
  of the one-hot responses: k times the exact exchange's bytes but free
  of caps; the oracle.

The reference groups by owner with a sort because TPU scatters are slow;
here the send buffer is one scatter at (owner, position within owner),
which gives the same buffer, positions, in-cap mask and overflow.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from legion_tpu_torch.ops.gather import gather_rows
from legion_tpu_torch.utils import comm

# The probe-free per-owner cap: twice the uniform share ceil(M/k).
OWNER_CAP_SLACK = 2.0

# Slack over an observed per-owner maximum when a driver probes the cap;
# requests past it demote to the host path (a burst costs hit rate, never
# correctness).
PROBED_OWNER_SLACK = 1.05


def owner_cap(m: int, k: int, slack: float = OWNER_CAP_SLACK) -> int:
    """Per-owner send-buffer rows for m requests over k owners, 8-aligned,
    never below 8 or above m."""
    c = int(-(-m // k) * slack)
    return max(8, min((c + 7) // 8 * 8, m))


def probed_cap(observed_max: int, hi: int,
               slack: float = PROBED_OWNER_SLACK) -> int:
    """A cap from an observed request maximum: slack x observed plus 32,
    8-aligned, within [8, hi]."""
    c = int(observed_max * slack) + 32
    return max(8, min((c + 7) // 8 * 8, int(hi)))


def probed_owner_cap(observed_max: int, m: int, k: int,
                     slack: float = PROBED_OWNER_SLACK) -> int:
    """The owner cap from an observed per-owner maximum, never above the
    probe-free ``owner_cap(m, k)``."""
    return probed_cap(observed_max, owner_cap(m, k), slack)


def owner_counts(ids: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) int32 requests per owner (id % k) of the valid (>= 0) ids."""
    valid = ids >= 0
    owner = torch.where(valid, ids, 0) % k
    return torch.zeros(k, dtype=torch.int32, device=ids.device).index_add_(
        0, owner.long(), valid.to(torch.int32))


def stripe_rows(table: np.ndarray, k: int, j: int) -> np.ndarray:
    """Stripe j of ``table`` striped k ways: rows j, j + k, ... at slots
    0, 1, ..., zero-padded to ceil(N/k) rows. Reads only those rows (a
    memmap stays on disk but for them)."""
    n = table.shape[0]
    cap = -(-n // k)
    rows = np.ascontiguousarray(table[j::k])
    out = np.zeros((cap,) + table.shape[1:], dtype=table.dtype)
    out[: rows.shape[0]] = rows
    return out


def shard_rows(table: np.ndarray, k: int) -> np.ndarray:
    """Every stripe: (k, ceil(N/k), D), row r at [r % k, r // k]."""
    return np.stack([stripe_rows(table, k, j) for j in range(k)])


def group_positions(group: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos (M,) int32: each request's exclusive rank within its group,
    request order kept; counts (k,) int32 requests per group) for group
    ids in [0, k], where k marks padding, which counts in no group (its
    pos reads group k - 1's, as the reference's clamped take does; no
    caller uses it). No host sync."""
    oh = (group[:, None] == torch.arange(k, dtype=group.dtype,
                                         device=group.device)).to(torch.int32)
    csum = torch.cumsum(oh, 0, dtype=torch.int32)
    pos = (csum - oh).gather(1, group.clamp(max=k - 1).long()[:, None])[:, 0]
    return pos, oh.sum(0, dtype=torch.int32)


def route_by_owner(ids: torch.Tensor, k: int, cap: int,
                   payload: Optional[torch.Tensor] = None):
    """Group requests by owner (id % k) into a (k, cap) send buffer, -1
    padded, request order kept within each owner. Returns (send (k, cap)
    int32, pos (M,) int32 position within its owner, in_cap (M,) bool:
    False past the owner's cap and for padding, overflow () int32 count
    past the caps[, the payload (M,) routed the same way, 0 on empty
    slots]). No host sync."""
    valid = ids >= 0
    owner = torch.where(valid, ids % k, k)
    pos, counts = group_positions(owner, k)
    overflow = (counts - cap).clamp(min=0).sum(dtype=torch.int32)
    in_cap = valid & (pos < cap)
    # kept requests land on distinct slots; the rest on one dropped slot
    dest = torch.where(in_cap, owner * cap + pos, k * cap).long()
    send = torch.full((k * cap + 1,), -1, dtype=torch.int32,
                      device=ids.device)
    send.scatter_(0, dest, ids.to(torch.int32))
    send = send[: k * cap].reshape(k, cap)
    if payload is None:
        return send, pos, in_cap, overflow
    pay = torch.zeros((k * cap + 1,), dtype=torch.int32, device=ids.device)
    pay.scatter_(0, dest, payload.to(torch.int32))
    return send, pos, in_cap, overflow, pay[: k * cap].reshape(k, cap)


def owner_overflow(ids: torch.Tensor, k: int,
                   cap: Optional[int] = None) -> torch.Tensor:
    """Requests the exact exchange would cap: sum over owners of
    max(count - cap, 0), computable before any exchange runs."""
    if cap is None:
        cap = owner_cap(ids.shape[0], k)
    return (owner_counts(ids, k) - cap).clamp(min=0).sum(dtype=torch.int32)


def response_index(ids: torch.Tensor, pos: torch.Tensor, in_cap: torch.Tensor,
                   k: int, cap: int) -> torch.Tensor:
    """Where each request's answer sits in the (k * cap) response: owner
    * cap + pos, -1 where it was not sent."""
    owner = torch.where(ids >= 0, ids, 0) % k
    return torch.where(in_cap, owner * cap + pos, -1).to(torch.int32)


def sharded_row_fetch_stats(table_local: torch.Tensor, ids: torch.Tensor,
                            group, cap: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact exchange: rows ``ids`` of a table striped over the ranks
    of ``group`` (this rank holds ``table_local``, its stripe). ids: (M,)
    int32 global row ids, -1 padding. Returns ((M, D) rows, zero for
    padding and for requests past the per-owner cap; () int32 count of
    those capped requests)."""
    k = dist.get_world_size(group)
    m = ids.shape[0]
    if cap is None:
        cap = owner_cap(m, k)
    send, pos, in_cap, overflow = route_by_owner(ids, k, cap)
    # recv[p] = the ids rank p asks this rank for
    recv = comm.all_to_all(send.reshape(-1), group)
    slot = torch.where(recv >= 0, recv // k, -1).to(torch.int32)
    rows = gather_rows(table_local, slot)                   # K3: serve
    resp = comm.all_to_all(rows, group)      # resp[o * cap + p]: my request
    out = gather_rows(resp, response_index(ids, pos, in_cap, k, cap))  # K3
    return out, overflow


def sharded_row_fetch(table_local: torch.Tensor, ids: torch.Tensor, group,
                      cap: Optional[int] = None) -> torch.Tensor:
    """``sharded_row_fetch_stats`` without the overflow count."""
    return sharded_row_fetch_stats(table_local, ids, group, cap)[0]


def sharded_row_fetch_psum(table_local: torch.Tensor, ids: torch.Tensor,
                           group) -> torch.Tensor:
    """The psum exchange: all-gather every rank's ids, gather the rows
    this rank owns (K3; zero rows elsewhere), and reduce-scatter the
    one-hot responses so that each rank receives the rows it asked for.
    Correct under any owner skew."""
    k = dist.get_world_size(group)
    me = dist.get_rank(group)
    all_ids = comm.all_gather(ids, group)                   # (k * M,)
    mine = (all_ids >= 0) & (torch.where(all_ids >= 0, all_ids, 0) % k == me)
    rows = gather_rows(table_local,
                       torch.where(mine, all_ids // k, -1).to(torch.int32))
    return comm.reduce_scatter(rows, group)
