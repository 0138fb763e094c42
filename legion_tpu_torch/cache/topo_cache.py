"""Topology cache: the compacted sub-CSR of the hot nodes in device memory
(port of ``legion_tpu/cache/topo_cache.py``).

The reference's GraphCache (``GPUMemoryGraphStorage::GraphCache``,
``src/GPU_Memory_Graph_Storage.cu:98-133``) prefix-scans the hot set's
neighbor counts into a sub-index and copies their adjacency to the device;
a per-node lookup then decides between the cached CSR and the host CSR
(``kernel_random_sampler_2``'s ``part_id`` branch,
``src/Kernels.cu:387-397``). Here the id -> row map is a sorted hot-id
array and ``torch.searchsorted``, as in the feature cache.

Used with the topology in host memory (``topology_placement="host"``):
``sample_hot`` draws for the frontier's cache hits through the port's
sampling kernel (``ops/sample.py``) on the sub-CSR, with the sub-row in
place of the node id and -1 for a miss; the misses are sampled on the
host (``legion_tpu_torch.runtime``) and merged by ``cache/hybrid.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from legion_tpu_torch.ops.sample import sample_neighbors


class TopoCache(NamedTuple):
    hot_ids: torch.Tensor      # (C,) int32 sorted ascending
    sub_indptr: torch.Tensor   # (C+1,) int32
    sub_indices: torch.Tensor  # (E_hot,) int32; one 0 when E_hot == 0

    @classmethod
    def build(cls, indptr: np.ndarray, indices: np.ndarray,
              hot_order: np.ndarray, capacity: int,
              device: torch.device | str) -> "TopoCache":
        """Cache the adjacency of the first ``capacity`` ids of
        ``hot_order`` (the cost model's topo_order). ``indptr`` is the
        host CSR's int64 index and ``indices`` may be a memmap: only the
        hot rows are read."""
        capacity = int(min(capacity, len(hot_order)))
        indptr = np.asarray(indptr)
        hot = np.sort(np.asarray(hot_order[:capacity], np.int64))
        starts = indptr[hot].astype(np.int64)
        degs = indptr[hot + 1].astype(np.int64) - starts
        sub_indptr = np.zeros(capacity + 1, np.int64)
        np.cumsum(degs, out=sub_indptr[1:])
        total = int(sub_indptr[-1])
        if total >= 2 ** 31:
            raise ValueError(f"the hot sub-CSR holds {total} edges; int32 "
                             "addressing needs < 2^31")
        # vectorised adjacency copy: src[j] walks each hot run in order
        within = np.arange(total, dtype=np.int64) - np.repeat(
            sub_indptr[:-1], degs)
        src = np.repeat(starts, degs) + within
        sub_indices = np.asarray(indices)[src].astype(np.int32)
        if total == 0:
            # keeps the kernel's argument a real allocation; with every
            # degree 0 no slot is ever read
            sub_indices = np.zeros(1, np.int32)
        return cls(
            hot_ids=torch.from_numpy(hot.astype(np.int32)).to(device),
            sub_indptr=torch.from_numpy(sub_indptr.astype(np.int32)).to(
                device),
            sub_indices=torch.from_numpy(sub_indices).to(device))

    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)

    def lookup(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hit mask, sub-CSR row) for global ids, -1 padded; the row is
        meaningful only where hit. No host sync."""
        c = self.hot_ids.shape[0]
        valid = ids >= 0
        if c == 0:
            return torch.zeros_like(valid), torch.zeros_like(ids)
        safe = torch.where(valid, ids, 0)
        pos = torch.searchsorted(self.hot_ids, safe, out_int32=True).clamp(
            0, c - 1)
        return valid & (self.hot_ids[pos] == safe), pos

    def sample_hot(self, frontier: torch.Tensor,
                   u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One hop for the frontier's cache hits: (neighbors (P, fanout)
        with -1 for an invalid slot or a miss, hit mask (P,)); u (P,
        fanout) float32 uniforms. The misses are left to the host
        sampler."""
        hit, row = self.lookup(frontier)
        if self.hot_ids.shape[0] == 0:
            return torch.full(u.shape, -1, dtype=torch.int32,
                              device=frontier.device), hit
        return sample_neighbors(self.sub_indptr, self.sub_indices,
                                torch.where(hit, row, -1), u), hit


def host_sample_cold(indptr: np.ndarray, indices: np.ndarray,
                     ids: np.ndarray, fanout: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Host-side uniform-with-replacement sampling for cache-miss nodes in
    numpy, with the device sampler's arithmetic on ``rng``'s float64
    uniforms. The drivers sample misses through
    ``legion_tpu_torch.runtime.sample_neighbors``, whose draws differ.
    ids: (M,) global ids with -1 for entries to skip."""
    m = ids.shape[0]
    out = np.full((m, fanout), -1, np.int32)
    valid = ids >= 0
    vids = ids[valid].astype(np.int64)
    indptr = np.asarray(indptr)
    starts = indptr[vids].astype(np.int64)
    deg = indptr[vids + 1].astype(np.int64) - starts
    u = rng.random((vids.shape[0], fanout))
    off = np.minimum((u * deg[:, None]).astype(np.int64),
                     np.maximum(deg[:, None] - 1, 0))
    addr = starts[:, None] + off
    nbr = np.asarray(indices)[np.clip(addr, 0, len(indices) - 1)]
    slot = np.arange(fanout)[None, :]
    ok = (slot < deg[:, None]) & (deg[:, None] > 0)
    out[valid] = np.where(ok, nbr, -1).astype(np.int32)
    return out
