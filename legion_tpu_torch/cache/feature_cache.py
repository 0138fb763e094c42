"""Hotness-ordered feature cache: hot rows in device memory, misses
staged from host RAM (port of ``legion_tpu/cache/feature_cache.py``).

The cache is static after presampling, so a sorted hot-id array and
``torch.searchsorted`` serve as its hash: no buckets and no atomics (the
reference used a cuckoo hash, ``src/GPUCache.cu:387-432``). Misses are
compacted on the device, their ids read by the host once per step, their
rows gathered from host memory into a pinned buffer and copied to the
device, so the host->device bytes are exactly the misses' rows.

``combine_rows`` merges cached and staged rows with two calls of the
gather kernel K3 (``ops/gather.py``) and one ``torch.where``. The
staging policy of the drivers closes the module: the probe of two fresh
batches, the probed capacity, its growth after an overflow and the
hybrid path's fixed capacity.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from legion_tpu_torch.data.format import host_tensor
from legion_tpu_torch.ops.gather import gather_rows
from legion_tpu_torch.parallel.feature_exchange import owner_counts
from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
from legion_tpu_torch.utils import trace


def cache_dtype_for(model_dtype: str, feature_dim: int):
    """(storage dtype, bytes per cached row) for a model compute dtype:
    bf16 training stores cache rows and staged misses in bf16 (twice the
    rows per budget, half the host->device bytes; the model computes in
    bf16 anyway)."""
    if model_dtype == "bfloat16":
        return torch.bfloat16, feature_dim * 2
    return torch.float32, feature_dim * 4


class CachePlan(NamedTuple):
    slot: torch.Tensor       # (M,) int32 cache slot (valid where hit)
    hit: torch.Tensor        # (M,) bool
    miss_idx: torch.Tensor   # (M,) int32 unclamped miss rank (valid where
    #                          miss; ranks >= miss_cap overflowed staging
    #                          and combine_rows zeroes those rows)
    miss_ids: torch.Tensor   # (miss_cap,) int32 global ids to stage, -1 pad
    num_miss: torch.Tensor   # () int32 total misses (may exceed miss_cap)
    num_hit: torch.Tensor    # () int32
    num_valid: torch.Tensor  # () int32

    def overflow(self) -> torch.Tensor:
        """Misses beyond staging capacity (their rows read as zeros)."""
        return (self.num_miss - self.miss_ids.shape[0]).clamp(min=0)


class FeatureCache:
    """Host features plus a device hot-row cache. ``hot_ids`` is sorted
    ascending (``build`` sorts it) and ``rows[i]`` is the feature row of
    ``hot_ids[i]`` in the cache dtype."""

    def __init__(self, hot_ids: torch.Tensor, rows: torch.Tensor,
                 host_features: np.ndarray, miss_cap: int):
        self.hot_ids = hot_ids
        self.rows = rows
        self.host_features = host_features
        self.miss_cap = int(miss_cap)
        self._host = host_tensor(host_features)     # only ever read

    @classmethod
    def build(cls, host_features: np.ndarray, hot_order: np.ndarray,
              capacity: int, miss_cap: int, dtype=torch.float32, *,
              device: torch.device | str) -> "FeatureCache":
        """Cache the first ``capacity`` ids of ``hot_order`` (the cost
        model's hotness-descending feat_order; the reference's FillUp,
        src/GPUCache.cu:769-826) in ``dtype`` on ``device``."""
        capacity = int(min(capacity, len(hot_order)))
        hot = np.sort(np.asarray(hot_order[:capacity], np.int32))
        rows = torch.from_numpy(np.ascontiguousarray(host_features[hot]))
        return cls(torch.from_numpy(hot).to(device),
                   rows.to(dtype).to(device), host_features, miss_cap)

    @staticmethod
    def plan_ids(hot_ids: torch.Tensor, frontier: torch.Tensor,
                 miss_cap: int) -> CachePlan:
        """Classify each frontier id as a cache hit or miss and compact
        the miss ids for host staging, on the device with no host sync;
        hot_ids sorted ascending."""
        c = hot_ids.shape[0]
        valid = frontier >= 0
        ids = torch.where(valid, frontier, 0)
        if c > 0:
            slot = torch.searchsorted(hot_ids, ids, out_int32=True).clamp(
                0, c - 1)
            hit = valid & (hot_ids[slot] == ids)
        else:
            slot = torch.zeros_like(ids)
            hit = torch.zeros_like(valid)
        miss = valid & ~hit
        midx = torch.cumsum(miss, 0, dtype=torch.int32) - 1
        # compaction: miss k goes to slot k; the rest to a dropped slot
        dest = torch.where(miss & (midx < miss_cap), midx, miss_cap).long()
        miss_ids = torch.full((miss_cap + 1,), -1, dtype=torch.int32,
                              device=frontier.device)
        miss_ids.scatter_(0, dest, torch.where(miss, frontier, -1))
        return CachePlan(
            slot=slot, hit=hit, miss_idx=midx, miss_ids=miss_ids[:miss_cap],
            num_miss=miss.sum(dtype=torch.int32),
            num_hit=hit.sum(dtype=torch.int32),
            num_valid=valid.sum(dtype=torch.int32))

    @staticmethod
    def combine_rows(rows: torch.Tensor, plan: CachePlan,
                     staged: torch.Tensor,
                     frontier: torch.Tensor) -> torch.Tensor:
        """The frontier's feature matrix from cached rows and the staged
        miss rows (``staged``: (miss_cap, D) rows of ``plan.miss_ids``).
        Padded slots (-1) and overflowed misses (rank beyond staging
        capacity, see ``CachePlan.overflow``) come out zero."""
        miss = (frontier >= 0) & ~plan.hit
        missed = gather_rows(staged, torch.where(
            miss & (plan.miss_idx < staged.shape[0]), plan.miss_idx, -1))
        if rows.shape[0] == 0:
            return missed
        cached = gather_rows(rows, torch.where(plan.hit, plan.slot, -1))
        return torch.where(plan.hit[:, None], cached, missed)

    def plan(self, frontier: torch.Tensor) -> CachePlan:
        return self.plan_ids(self.hot_ids, frontier, self.miss_cap)

    def combine(self, plan: CachePlan, staged: torch.Tensor,
                frontier: torch.Tensor) -> torch.Tensor:
        return self.combine_rows(self.rows, plan, staged, frontier)

    def stage(self, miss_ids: np.ndarray,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Host gather of the rows of ``miss_ids`` in the cache dtype (a
        zero row for -1), into ``out`` (e.g. a pinned buffer) when given,
        so the bytes staged match the cache dtype."""
        ids = torch.from_numpy(np.asarray(miss_ids, np.int64))
        rows = self._host.index_select(0, ids.clamp(min=0))
        if out is None:
            out = torch.empty(rows.shape, dtype=self.rows.dtype)
        out.copy_(rows)
        invalid = ids < 0
        if bool(invalid.any()):
            out[invalid] = 0
        return out

    def stage_to(self, device: torch.device, miss_ids: np.ndarray,
                 out: Optional[torch.Tensor] = None,
                 host: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Gather the rows of ``miss_ids`` on the host and start their copy
        to ``device``: (miss_cap, D) staged rows, of which the first
        len(miss_ids) are written (a plan reads no other). On CUDA the
        rows are gathered into pinned memory and copied without blocking,
        so exactly the misses' bytes cross. ``host`` and ``out`` (a staged
        pipeline's static buffers, (miss_cap, D) each, ``host`` pinned on
        CUDA) take the gather and the copy; fresh ones otherwise, and on
        the CPU without ``out`` the host buffer is the result. The rows'
        bytes count in ``h2d_bytes`` (``utils/trace.py``)."""
        shape = (self.miss_cap, self.rows.shape[1])
        dtype = self.rows.dtype
        n = len(miss_ids)
        on_cuda = device.type == "cuda"
        if host is None:
            host = torch.empty(shape, dtype=dtype, pin_memory=on_cuda)
        self.stage(miss_ids, out=host[:n])
        if out is None:
            if not on_cuda:
                return host
            out = torch.empty(shape, dtype=dtype, device=device)
        out[:n].copy_(host[:n], non_blocking=on_cuda)
        trace.count("h2d_bytes", n * host.shape[1] * host.element_size())
        return out


# ---- staging policy ---------------------------------------------------------

def round128(x) -> int:
    return (int(x) + 127) // 128 * 128


def probe_staging(graph: DeviceGraph, shards: List[np.ndarray], batch: int,
                  fanouts: Sequence[int], caps: Sequence[int],
                  hot_ids: torch.Tensor, seed: int,
                  group: int = 1) -> Tuple[int, int]:
    """An unbiased probe of two fresh batches (batch i of shard
    ``i % len(shards)``) sampled at ``caps`` and planned against the built
    hot set ``hot_ids`` (sorted). Returns (the most misses of a batch, and
    on a cache group of ``group`` ranks the most hits of one owner, id %
    ``group``, in a batch; 0 for ``group`` 1)."""
    device = hot_ids.device
    prng = np.random.default_rng(seed * 31 + 7)
    miss = owner = 0
    with torch.no_grad():
        for i in range(2):
            sb = prng.permutation(shards[i % len(shards)])[:batch]
            sb = sb.astype(np.int32)
            if len(sb) < batch:
                sb = np.pad(sb, (0, batch - len(sb)), constant_values=-1)
            out = sample_batch(
                graph, torch.from_numpy(sb).to(device),
                torch.tensor(batch, dtype=torch.int32, device=device),
                torch.zeros((batch,), dtype=torch.int32, device=device),
                fanouts, caps, dedup_last=True,
                generator=torch.Generator(device=device).manual_seed(
                    9000 + i))
            pl = FeatureCache.plan_ids(hot_ids, out.frontier, 128)
            miss = max(miss, int(pl.num_miss))
            if group > 1:
                owner = max(owner, int(owner_counts(
                    torch.where(pl.hit, pl.slot, -1), group).max()))
    return miss, owner


def probed_miss_cap(expected, frontier_cap: int) -> int:
    """Staging rows for ``expected`` misses a step: 1.5x them plus 1/16 of
    the frontier cap and 1024, in 128s, at most the frontier cap."""
    return int(min(frontier_cap,
                   round128(expected * 1.5 + frontier_cap / 16 + 1024)))


def grown_miss_cap(miss_cap: int, overflow: int, steps: int,
                   frontier_cap: int) -> int:
    """Staging rows after an epoch of ``steps`` steps that overflowed
    ``miss_cap`` by ``overflow`` rows: twice the worst observed per-step
    need, in 128s, at most the frontier cap."""
    need = miss_cap + overflow / max(steps, 1)
    return int(min(frontier_cap, round128(need * 2.0)))


def fixed_miss_cap(frontier_cap: int) -> int:
    """The reference hybrid driver's staging rows, neither probed nor
    grown: 1/16 of the frontier cap plus 1024, in 128s, at most the
    frontier cap."""
    return int(min(frontier_cap, round128(frontier_cap // 16 + 1024)))
