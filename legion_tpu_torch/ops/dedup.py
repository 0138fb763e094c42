"""The dedup's tail: what ``grow_frontier`` (``sampling/sampler.py``) does
after its stable sort of ``[prev | neighbors]`` by id.

Given the sorted ids ``s`` (padding as ``SENTINEL``) and each entry's
index before the sort ``sorig``, it numbers the groups of equal ids: the
first entry of a group leads it; a leader from the previous frontier
(``sorig < prev_cap``) keeps its position there, the other leaders are new
ids, appended from ``num_prev`` in ascending id order. Out come the new
frontier (``-1`` padded), the new count (not clamped at ``cap_new``, so an
overflow reads as a count past the cap) and each neighbor slot's position
in edge order (0 at a padding slot). These are the reference's semantics
(``legion_tpu/sampling/sampler.py``, ``grow_frontier``) bit for bit.

The CUDA kernel (``csrc/legion_kernels.cu``, ``dedup_tail_kernel``) does
it in one pass and one launch; see the source note there. It replaces no
TPU kernel: the JAX dedup is ``jnp`` operations. A CPU tensor takes the
plain version, the chain of PyTorch passes the kernel replaces; a CUDA
tensor takes the kernel or raises. Both want the frontier's valid ids
distinct and in front of its padding, as every frontier ``grow_frontier``
makes and every seed vector is. ``dedup_traffic`` counts the bytes the
kernel must move, for its bound.
"""

from __future__ import annotations

from typing import Tuple

import torch

from legion_tpu_torch.ops import _build

# Padding sentinel that sorts after every real node id (externally the
# padding is -1).
SENTINEL = torch.iinfo(torch.int32).max
# sorted entries a block of the kernel takes (kDedupTile)
TILE = 1024


def dedup_tail_plain(s: torch.Tensor, sorig: torch.Tensor,
                     frontier_prev: torch.Tensor, num_prev: torch.Tensor,
                     cap_new: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: positions reach each group's
    members by a "last leader wins" broadcast (a cummax over leader
    indices) and return to edge order through the sort permutation; the
    frontier is the leaders sorted by their target position."""
    prev_cap = frontier_prev.shape[0]
    total = s.shape[0]
    dev = s.device
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
    pos_orig[sorig] = torch.where(s != SENTINEL, pos_sorted, 0)
    nbr_pos = pos_orig[prev_cap:]

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
    return fval[order], num_new, nbr_pos


def dedup_traffic(total: int, prev_cap: int, cap_new: int) -> int:
    """Bytes the kernel must move: ``s`` (4 B) and ``sorig`` (8 B) read once,
    ``nbr_pos`` (4 B a neighbor slot) and the frontier written once."""
    return 12 * total + 4 * (total - prev_cap) + 4 * cap_new


def dedup_tail(s: torch.Tensor, sorig: torch.Tensor,
               frontier_prev: torch.Tensor, num_prev: torch.Tensor,
               cap_new: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(frontier_new (cap_new,) int32, num_new () int32, nbr_pos
    (total - prev_cap,) int32) from the stable sort of ``[frontier_prev |
    neighbors]`` with padding as ``SENTINEL``: ``s`` (total,) int32 and
    ``sorig`` (total,) int64; ``num_prev`` a 0-d int32 tensor."""
    if (s.dtype != torch.int32 or sorig.dtype != torch.int64
            or frontier_prev.dtype != torch.int32
            or num_prev.dtype != torch.int32):
        raise ValueError("dedup_tail wants int32 s, frontier_prev and "
                         f"num_prev and int64 sorig; got {s.dtype}, "
                         f"{frontier_prev.dtype}, {num_prev.dtype} and "
                         f"{sorig.dtype}")
    total, prev_cap = s.shape[0], frontier_prev.shape[0]
    if (s.dim() != 1 or sorig.shape != s.shape or frontier_prev.dim() != 1
            or num_prev.dim() != 0 or total < prev_cap):
        raise ValueError(f"dedup_tail wants s and sorig of one shape (T,), "
                         f"T >= P for a (P,) frontier and a 0-d num_prev; "
                         f"got {tuple(s.shape)}, {tuple(sorig.shape)}, "
                         f"{tuple(frontier_prev.shape)} and "
                         f"{tuple(num_prev.shape)}")
    tensors = (s, sorig, frontier_prev, num_prev)
    if all(t.device.type == "cpu" for t in tensors):
        return dedup_tail_plain(s, sorig, frontier_prev, num_prev, cap_new)
    _build.require_cuda(*tensors)
    dev = s.device
    frontier = torch.full((cap_new,), -1, dtype=torch.int32, device=dev)
    nbr_pos = torch.empty((total - prev_cap,), dtype=torch.int32, device=dev)
    if total == 0:
        return frontier, num_prev.clone(), nbr_pos
    num_new = torch.empty((), dtype=torch.int32, device=dev)
    tiles = (total + TILE - 1) // TILE
    state = torch.empty((tiles + 1,), dtype=torch.int64, device=dev)
    lib = _build.load_library()
    _build.check(lib.legion_dedup_tail(
        s.data_ptr(), sorig.data_ptr(), frontier_prev.data_ptr(),
        num_prev.data_ptr(), frontier.data_ptr(), num_new.data_ptr(),
        nbr_pos.data_ptr(), state.data_ptr(), total, prev_cap, cap_new,
        _build.stream_of(s)), "dedup_tail")
    dedup_tail.launches += 1
    return frontier, num_new, nbr_pos


dedup_tail.launches = 0
