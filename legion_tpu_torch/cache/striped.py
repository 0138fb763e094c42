"""Caches striped over a cache group (port of ``legion_tpu/cache/striped.py``).

The reference (Legion) interleaves the hot feature rows and the hot
adjacency round-robin over the ``Kg`` GPUs of an NVLink clique: hot rank
``idx`` lives on GPU ``idx % Kg`` at slot ``idx / Kg`` (``InitPair``,
``src/GPUCache.cu:88-141``), and a GPU reads a peer's stripe through peer
pointers (``src/Kernels.cu:662-702``). Here a cache group is
``parallel.mesh.Mesh.group`` (``group_size`` ranks), each rank holds its
own stripe of the hot set in device memory, the small sorted hot-id array
is held by every rank, and a peer's rows or draws come over the group by
the exact exchange of ``parallel.feature_exchange``.

* ``StripedFeatureCache``: the hot feature rows. A hit is fetched from
  its owner (``sharded_row_fetch_stats``, the gather kernel K3 serving
  and reassembling); hits past an owner's request cap are demoted to
  misses and staged from host memory like any miss, so a burst costs hit
  rate, never a wrong row.
* ``StripedTopoCache``: the hot sub-CSR. The owner of a hit draws its
  neighbors with the sampling kernel (``ops/sample.py``) on its stripe and
  sends the draws straight back; requests past the cap are left to the
  host sampler.

Each rank reads only its own stripe's rows from host memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from legion_tpu_torch.cache.feature_cache import CachePlan, FeatureCache
from legion_tpu_torch.ops.gather import gather_rows
from legion_tpu_torch.ops.sample import sample_neighbors
from legion_tpu_torch.parallel.feature_exchange import (
    owner_cap, response_index, route_by_owner, sharded_row_fetch_stats)
from legion_tpu_torch.parallel.mesh import Mesh
from legion_tpu_torch.utils import comm


def _stripe_ids(hot: np.ndarray, k: int, j: int) -> np.ndarray:
    """The hot ids of stripe j (hot ranks j, j + k, ...)."""
    return hot[j::k]


class StripedFeatureCache(FeatureCache):
    """The hot rows striped over a cache group of k ranks. ``hot_ids``:
    the sorted (C,) int32 hot ids, on every rank; ``rows``: this rank's
    stripe, (ceil(C/k), D) in the cache dtype, row i holding hot rank
    ``i * k + cache_rank`` (zero rows past C). ``plan.slot`` is the hot
    rank, not a node id. ``owner_cap_rows`` is the per-owner request cap
    of the exchange (None: the probe-free ``owner_cap``); the plan's
    demotion and the fetch use the same one. Staging (``stage``,
    ``stage_to``) is the single-device cache's."""

    def __init__(self, hot_ids: torch.Tensor, rows: torch.Tensor,
                 host_features: np.ndarray, miss_cap: int, group,
                 owner_cap_rows: Optional[int] = None):
        super().__init__(hot_ids, rows, host_features, miss_cap)
        self.group = group
        self.group_size = dist.get_world_size(group)
        if owner_cap_rows is not None and owner_cap_rows <= 0:
            raise ValueError(f"owner_cap_rows must be > 0, got "
                             f"{owner_cap_rows}")
        # a one-rank group never demotes (plan_ids is the single-device
        # plan there), so its fetch must not cap either: the demotion mask
        # and the fetch routing must agree
        self.owner_cap_rows = (None if self.group_size <= 1
                               or owner_cap_rows is None
                               else int(owner_cap_rows))

    @classmethod
    def build(cls, host_features: np.ndarray, hot_order: np.ndarray,
              capacity: int, miss_cap: int, mesh: Mesh,
              dtype=torch.float32, *, device: torch.device | str,
              owner_cap_rows: Optional[int] = None
              ) -> "StripedFeatureCache":
        """The first ``capacity`` ids of ``hot_order`` (the cost model's
        whole-group capacity), sorted, with this rank's stripe of their
        rows in ``dtype`` on ``device``."""
        k, j = mesh.cache, mesh.cache_rank
        capacity = int(min(capacity, len(hot_order)))
        hot = np.sort(np.asarray(hot_order[:capacity], np.int32))
        mine = _stripe_ids(hot, k, j)
        rows = np.zeros((-(-capacity // k),) + host_features.shape[1:],
                        dtype=np.asarray(host_features[:0]).dtype)
        rows[: len(mine)] = host_features[mine]
        return cls(torch.from_numpy(hot).to(device),
                   torch.from_numpy(rows).to(dtype).to(device),
                   host_features, miss_cap, mesh.group, owner_cap_rows)

    @staticmethod
    def demote_overflow(plan: CachePlan, frontier: torch.Tensor,
                        miss_cap: int, k: int,
                        cap: Optional[int] = None) -> CachePlan:
        """The plan with the hits past their owner's cap turned into
        misses and the miss ids compacted again (``plan.num_hit`` minus
        the result's is the demoted count). No host sync."""
        m = frontier.shape[0]
        req = torch.where(plan.hit, plan.slot, -1)
        _, _, in_cap, _ = route_by_owner(
            req, k, cap if cap is not None else owner_cap(m, k))
        hit = plan.hit & in_cap
        miss = (frontier >= 0) & ~hit
        midx = torch.cumsum(miss, 0, dtype=torch.int32) - 1
        # the reference's dropped scatter: miss r to slot r, the rest to a
        # slot past the end that is cut off
        dest = torch.where(miss & (midx < miss_cap), midx, miss_cap).long()
        miss_ids = torch.full((miss_cap + 1,), -1, dtype=torch.int32,
                              device=frontier.device)
        miss_ids.scatter_(0, dest, torch.where(miss, frontier, -1))
        return CachePlan(
            slot=plan.slot, hit=hit, miss_idx=midx,
            miss_ids=miss_ids[:miss_cap],
            num_miss=miss.sum(dtype=torch.int32),
            num_hit=hit.sum(dtype=torch.int32), num_valid=plan.num_valid)

    def plan_demoted(self, frontier: torch.Tensor
                     ) -> Tuple[CachePlan, torch.Tensor]:
        """(the single-device plan with over-cap hits demoted on a group
        of more than one rank, () int32 count of the demoted hits)."""
        base = self.plan_ids(self.hot_ids, frontier, self.miss_cap)
        if self.group_size <= 1:
            return base, torch.zeros_like(base.num_hit)
        plan = self.demote_overflow(base, frontier, self.miss_cap,
                                    self.group_size, self.owner_cap_rows)
        return plan, base.num_hit - plan.num_hit

    def plan(self, frontier: torch.Tensor) -> CachePlan:
        return self.plan_demoted(frontier)[0]

    def combine(self, plan: CachePlan, staged: torch.Tensor,
                frontier: torch.Tensor) -> torch.Tensor:
        """The frontier's feature matrix: hits through the exchange, misses
        from the staged rows (K3 for both), zero for padding and for
        misses past the staging capacity; the same matrix as
        ``FeatureCache.combine`` over the same hot set. A collective of
        the cache group: every rank of it calls it once a step."""
        miss = (frontier >= 0) & ~plan.hit
        missed = gather_rows(staged, torch.where(
            miss & (plan.miss_idx < staged.shape[0]), plan.miss_idx, -1))
        if self.hot_ids.shape[0] == 0:      # the same on every rank
            return missed
        hit_rows, _ = sharded_row_fetch_stats(
            self.rows, torch.where(plan.hit, plan.slot, -1), self.group,
            cap=self.owner_cap_rows)
        return torch.where(plan.hit[:, None], hit_rows.to(missed.dtype),
                           missed)


class StripedTopoCache:
    """The hot sub-CSR striped over a cache group of k ranks: ``hot_ids``
    (C,) sorted int32 on every rank; this rank's stripe ``sub_indptr``
    (ceil(C/k) + 1,) and ``sub_indices`` (its edges, at least one entry),
    whose row i is the adjacency of hot rank ``i * k + cache_rank``
    (degree 0 past C)."""

    def __init__(self, hot_ids: torch.Tensor, sub_indptr: torch.Tensor,
                 sub_indices: torch.Tensor, group):
        self.hot_ids = hot_ids
        self.sub_indptr = sub_indptr
        self.sub_indices = sub_indices
        self.group = group
        self.group_size = dist.get_world_size(group)
        self.cache_rank = dist.get_rank(group)

    @classmethod
    def build(cls, indptr: np.ndarray, indices: np.ndarray,
              hot_order: np.ndarray, capacity: int, mesh: Mesh,
              device: torch.device | str) -> "StripedTopoCache":
        """Cache the adjacency of this rank's stripe of the first
        ``capacity`` ids of ``hot_order`` (the cost model's topo_order);
        only those rows of the host CSR are read."""
        k, j = mesh.cache, mesh.cache_rank
        capacity = int(min(capacity, len(hot_order)))
        indptr = np.asarray(indptr)
        hot = np.sort(np.asarray(hot_order[:capacity], np.int64))
        own = _stripe_ids(hot, k, j)
        starts = indptr[own].astype(np.int64)
        degs = indptr[own + 1].astype(np.int64) - starts
        sp = np.zeros(-(-capacity // k) + 1, np.int64)
        np.cumsum(degs, out=sp[1: len(own) + 1])
        sp[len(own) + 1:] = sp[len(own)]               # padded rows: degree 0
        total = int(sp[-1])
        if total >= 2 ** 31:
            raise ValueError(f"the hot sub-CSR stripe holds {total} edges; "
                             "int32 addressing needs < 2^31")
        within = np.arange(total, dtype=np.int64) - np.repeat(
            sp[: len(own)], degs)
        si = np.asarray(indices)[np.repeat(starts, degs) + within].astype(
            np.int32)
        if total == 0:
            si = np.zeros(1, np.int32)     # a real allocation; never read
        return cls(torch.from_numpy(hot.astype(np.int32)).to(device),
                   torch.from_numpy(sp.astype(np.int32)).to(device),
                   torch.from_numpy(si).to(device), mesh.group)

    def lookup(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hit mask, hot rank) for global ids, -1 padded; the rank is
        meaningful only where hit. No host sync."""
        c = self.hot_ids.shape[0]
        valid = ids >= 0
        if c == 0:
            return torch.zeros_like(valid), torch.zeros_like(ids)
        safe = torch.where(valid, ids, 0)
        pos = torch.searchsorted(self.hot_ids, safe, out_int32=True).clamp(
            0, c - 1)
        return valid & (self.hot_ids[pos] == safe), pos

    def sample_hot(self, frontier: torch.Tensor, u: torch.Tensor,
                   cap: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One hop for the frontier's cache hits, over the group: (draws
        (M, fanout) int32, -1 for a miss, padding, an over-cap request or a
        slot past the degree; hit mask (M,), False for over-cap requests,
        which fall to the host sampler). ``u`` is the group's (k*M, fanout)
        uniform grid, the same on every rank of the group: rank c's
        request j draws with row ``c*M + j``, whoever owns it, so the
        draws do not depend on the group size. The owner draws with the
        sampling kernel on its stripe. A collective of the cache group."""
        k, me = self.group_size, self.cache_rank
        m, fanout = frontier.shape[0], u.shape[1]
        if u.shape[0] != k * m:
            raise ValueError(f"sample_hot wants a ({k}*{m}, f) uniform grid, "
                             f"got {tuple(u.shape)}")
        hit, rank = self.lookup(frontier)
        if self.hot_ids.shape[0] == 0:       # the same on every rank
            return torch.full((m, fanout), -1, dtype=torch.int32,
                              device=frontier.device), hit
        cap = cap if cap is not None else owner_cap(m, k)
        req = torch.where(hit, rank, -1)
        gidx = me * m + torch.arange(m, dtype=torch.int32,
                                     device=frontier.device)
        send, pos, in_cap, _, send_g = route_by_owner(req, k, cap,
                                                      payload=gidx)
        # ids and grid rows ride together: recv[p] = what rank p asks me
        recv = comm.all_to_all(torch.stack([send.reshape(-1),
                                            send_g.reshape(-1)], 1),
                               self.group)
        row = torch.where(recv[:, 0] >= 0, recv[:, 0] // k, -1)
        ur = u.index_select(0, recv[:, 1].clamp(0, k * m - 1).long())
        draws = sample_neighbors(self.sub_indptr, self.sub_indices, row, ur)
        resp = comm.all_to_all(draws, self.group)   # resp[o*cap+p]: mine
        at = response_index(req, pos, in_cap, k, cap)
        out = resp.index_select(0, at.clamp(min=0).long())
        hit = hit & in_cap
        return torch.where(hit[:, None], out, -1), hit
