"""Plain neighborhood aggregators (port of ``legion_tpu/ops/segment.py``).

``fanout_gather_*`` are the gather + masked-reduce formulation over a
block's dense ``(dst_cap, fanout)`` grid, in the input's dtype;
``segment_mean_coo`` is the scatter-based (DGL-style SpMM) baseline over
the flattened COO edge list, kept as a cross-check. Both gather with
``jnp.take``'s fill semantics (``take_rows``): a position past the src
rows gives a NaN row, and its gradient is dropped.
"""

from __future__ import annotations

import torch

from legion_tpu_torch.ops.identity_agg import take_rows
from legion_tpu_torch.sampling.block import Block


def fanout_gather_sum(h_src: torch.Tensor, block: Block) -> torch.Tensor:
    """(S, D), Block -> (dst_cap, D) sum of sampled-neighbor rows.
    Identity-layout blocks read a contiguous slice instead of gathering."""
    p, f = block.nbr_pos.shape
    if block.identity_offset is not None:
        off = block.identity_offset
        rows = h_src[off:off + p * f].reshape(p, f, -1)
    else:
        rows = take_rows(h_src, block.nbr_pos)
    m = block.nbr_mask[..., None].to(h_src.dtype)
    return (rows * m).sum(1)


def fanout_gather_mean(h_src: torch.Tensor, block: Block) -> torch.Tensor:
    """Mean aggregation; zero-in-degree dst rows yield 0."""
    s = fanout_gather_sum(h_src, block)
    cnt = block.nbr_mask.sum(1, keepdim=True).to(h_src.dtype)
    return s / cnt.clamp(min=1.0)


def segment_mean_coo(h_src: torch.Tensor, block: Block) -> torch.Tensor:
    """Scatter-based mean over the COO edge list (the reference client's
    SpMM formulation): index_add_ of masked messages per dst."""
    src, dst, mask = block.coo()
    msgs = take_rows(h_src, src) * mask[:, None].to(h_src.dtype)
    dst = dst.long()
    summ = torch.zeros((block.dst_cap, h_src.shape[1]), dtype=h_src.dtype,
                       device=h_src.device).index_add_(0, dst, msgs)
    cnt = torch.zeros((block.dst_cap,), dtype=h_src.dtype,
                      device=h_src.device).index_add_(0, dst,
                                                      mask.to(h_src.dtype))
    return summ / cnt.clamp(min=1.0)[:, None]
