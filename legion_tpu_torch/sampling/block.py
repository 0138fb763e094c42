"""Static-shape message-flow-graph blocks (port of
``legion_tpu/sampling/block.py``).

Same contract as the reference: fixed-capacity tensors plus valid
counts held as 0-d device tensors, the ``[seeds | hop1-new | ...]``
prefix numbering (the dst nodes of a block are the first ``dst_cap``
src nodes), and a dense ``(dst_cap, fanout)`` grid of src positions
with a validity mask instead of a COO edge list.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def frontier_caps(batch_size: int, fanouts: Sequence[int],
                  align: int = 8) -> Tuple[int, ...]:
    """Static frontier capacities per hop: cap_0 = batch, cap_k =
    cap_{k-1} * (1 + fanouts[k-1]), each rounded up to ``align``."""
    caps = [_round_up(batch_size, align)]
    for f in fanouts:
        caps.append(_round_up(caps[-1] * (1 + f), align))
    return tuple(caps)


@dataclasses.dataclass(frozen=True)
class Block:
    """One bipartite message-flow block (hop k): src = frontier after the
    hop, dst = frontier before it (a prefix of src)."""

    # (dst_cap, fanout) int32: position of each sampled neighbor in the
    # src frontier; 0 where invalid.
    nbr_pos: torch.Tensor
    # (dst_cap, fanout) bool: slot holds a real sampled edge.
    nbr_mask: torch.Tensor
    num_src: torch.Tensor      # () int32 valid src extent
    num_dst: torch.Tensor      # () int32 valid dst nodes
    # Static layout promise for un-deduped hops (sampler.append_frontier):
    # nbr_pos[d, j] == identity_offset + d*fanout + j, so aggregation
    # reads contiguous rows. num_src is then the occupied extent.
    identity_offset: Optional[int] = None

    @property
    def dst_cap(self) -> int:
        return self.nbr_pos.shape[0]

    @property
    def fanout(self) -> int:
        return self.nbr_pos.shape[1]

    def num_edges(self) -> torch.Tensor:
        """Valid edge count, a 0-d int32 device tensor."""
        return self.nbr_mask.sum(dtype=torch.int32)

    def coo(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Flatten to (src_pos, dst_pos, mask) COO."""
        dst = torch.arange(self.dst_cap, dtype=torch.int32,
                           device=self.nbr_pos.device)[:, None]
        dst = dst.expand(self.nbr_pos.shape)
        return (self.nbr_pos.reshape(-1), dst.reshape(-1),
                self.nbr_mask.reshape(-1))


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    """Everything the train step needs for one mini-batch. ``blocks`` are
    in sampling order (hop 1 from the seeds first); models consume
    ``reversed(blocks)``."""

    seeds: torch.Tensor          # (seed_cap,) int32 global ids, -1 padded
    labels: torch.Tensor         # (seed_cap,) int32, -1 padded
    num_seeds: torch.Tensor      # () int32
    frontier: torch.Tensor       # (final_cap,) int32 global ids, -1 padded
    num_frontier: torch.Tensor   # () int32
    blocks: Tuple[Block, ...]

    @property
    def seed_cap(self) -> int:
        return self.seeds.shape[0]

    @property
    def frontier_cap(self) -> int:
        return self.frontier.shape[0]

    def seed_mask(self) -> torch.Tensor:
        return (torch.arange(self.seed_cap, dtype=torch.int32,
                             device=self.seeds.device) < self.num_seeds)
