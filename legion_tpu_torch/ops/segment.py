"""Plain neighborhood aggregators (port of ``legion_tpu/ops/segment.py``).

``fanout_gather_*`` are the gather + masked-reduce formulation over a
block's dense ``(dst_cap, fanout)`` grid, in the input's dtype; on an
identity-layout block the sum is K5 (``ops.spmm.grouped_masked_sum``), the
kernel the reference wrote for that contract;
``segment_mean_coo`` is the scatter-based (DGL-style SpMM) baseline over
the flattened COO edge list, kept as a cross-check. Both gather with
``jnp.take``'s fill semantics (``take_rows``): a position past the src
rows gives a NaN row, and its gradient is dropped.
"""

from __future__ import annotations

import torch

from legion_tpu_torch.ops.identity_agg import in_rows, take_rows
from legion_tpu_torch.ops.spmm import grouped_masked_sum
from legion_tpu_torch.sampling.block import Block


def fanout_gather_sum(h_src: torch.Tensor, block: Block) -> torch.Tensor:
    """(S, D), Block -> (dst_cap, D) sum of sampled-neighbor rows.
    Identity-layout blocks read a contiguous slice instead of gathering:
    K5, which sums in f32 and casts once."""
    p, f = block.nbr_pos.shape
    if block.identity_offset is not None:
        off = block.identity_offset
        return grouped_masked_sum(h_src[off:off + p * f], block.nbr_mask, f)
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


def block_dst_degree(block: Block) -> torch.Tensor:
    """(dst_cap,) int32 in-degree of each dst within the block."""
    return block.nbr_mask.sum(1, dtype=torch.int32)


def block_src_out_degree(block: Block, src_cap: int) -> torch.Tensor:
    """(src_cap,) int32 out-degree of each src within the block (the GCN
    'both' norm). Identity-layout blocks need no scatter: each appended
    row has exactly one edge (its own slot) and rows before the offset
    have none. Otherwise one ``index_add_`` of the valid slots; a position
    past ``src_cap`` (after a cap overflow) is dropped."""
    flat = block.nbr_mask.reshape(-1)
    if block.identity_offset is not None:
        off = block.identity_offset
        if off + flat.shape[0] != src_cap:
            raise ValueError(f"identity block of offset {off} and "
                             f"{flat.shape[0]} slots does not end at "
                             f"src_cap {src_cap}")
        return torch.cat([torch.zeros((off,), dtype=torch.int32,
                                      device=flat.device),
                          flat.to(torch.int32)])
    pos = block.nbr_pos.reshape(-1)
    keep = flat & in_rows(pos, src_cap)
    deg = torch.zeros((src_cap,), dtype=torch.int32, device=flat.device)
    return deg.index_add_(0, pos.clamp(0, src_cap - 1).long(),
                          keep.to(torch.int32))


def block_sddmm(h_dst: torch.Tensor, h_src: torch.Tensor,
                block: Block) -> torch.Tensor:
    """Sampled dense-dense product over a block's edges:
    out[d, j] = <h_dst[d], h_src[nbr_pos[d, j]]> in f32, 0 where masked
    (the edge-score primitive of attention and link models). Identity
    blocks read their contiguous slice instead of gathering."""
    p, f = block.nbr_pos.shape
    if block.identity_offset is not None:
        off = block.identity_offset
        rows = h_src[off:off + p * f].reshape(p, f, -1)
    else:
        rows = take_rows(h_src, block.nbr_pos)
    scores = torch.einsum("pd,pfd->pf", h_dst[:p].float(), rows.float())
    return torch.where(block.nbr_mask, scores,
                       torch.zeros((), dtype=scores.dtype,
                                   device=scores.device))
