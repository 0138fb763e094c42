"""GCN over sampled blocks (port of ``legion_tpu/models/gcn.py``).

A DGL ``GraphConv`` stack with ``allow_zero_in_degree=True``: symmetric
'both' normalization computed on the block,
``h' = D_dst^{-1/2} A (D_src^{-1/2} h) W + b``, with ReLU after every
layer but the last and dropout before every layer but the first. The
dense has no bias; the bias is a float32 parameter of its own, added
after the norm, so a dst row with no sampled neighbor is exactly the
bias. Parameters stay float32 and are cast to the compute dtype at each
product; aggregation sums in float32 inside the kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from legion_tpu_torch.models.sage import _lecun_normal_
from legion_tpu_torch.ops.act_dropout import act_dropout
from legion_tpu_torch.ops.identity_agg import (gathered_masked_mean,
                                               identity_masked_mean)
from legion_tpu_torch.ops.segment import (block_dst_degree,
                                          block_src_out_degree,
                                          fanout_gather_sum)
from legion_tpu_torch.sampling.block import Block


def _inv_sqrt_degree(deg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(n,) int degrees -> (n, 1) factors 1 / sqrt(max(deg, 1)) in dtype
    (1 for a node with no edge, which keeps its zero sum)."""
    return (1.0 / torch.sqrt(deg.to(dtype).clamp(min=1.0)))[:, None]


class GraphConvLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_dim = out_dim
        self.dtype = dtype
        self.dense = nn.Linear(in_dim, out_dim, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _lecun_normal_(self.dense.weight, generator)
        nn.init.zeros_(self.bias)

    def _dense(self, h: torch.Tensor) -> torch.Tensor:
        return F.linear(h.to(self.dtype), self.dense.weight.to(self.dtype))

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if block.identity_offset is not None:
            # Every appended src row carries at most one edge, so the src
            # factor is exactly 1 and the 'both' norm is sum / sqrt(in-deg).
            if dt == torch.bfloat16:
                # K1 in one pass over the raw features: mask, f32 sum,
                # rsqrt and the bf16 cast
                agg = identity_masked_mean(h_src, block.nbr_mask,
                                           block.identity_offset,
                                           norm="sqrt", out_dtype=dt)
            else:
                # K5, then the dst factor
                agg = fanout_gather_sum(h_src.to(dt), block) * torch.rsqrt(
                    block_dst_degree(block).to(dt).clamp(min=1.0))[:, None]
            return self._dense(agg) + self.bias.to(dt)
        src_deg = block_src_out_degree(block, h_src.shape[0])
        h = h_src * _inv_sqrt_degree(src_deg, dt)
        if self.out_dim < h_src.shape[-1]:
            # The bias-free dense commutes with the masked sum and the dst
            # scaling, so a narrowing layer transforms first and K2
            # gathers and scatters the narrower rows (as SAGEConv does).
            agg = gathered_masked_mean(self._dense(h), block.nbr_pos,
                                       block.nbr_mask, norm="sum")
        else:
            agg = self._dense(fanout_gather_sum(h, block))
        agg = agg * _inv_sqrt_degree(block_dst_degree(block), dt)
        return agg + self.bias.to(dt)


class GCN(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = dtype
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            GraphConvLayer(dims[i], dims[i + 1], dtype)
            for i in range(num_layers))
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, blocks: Sequence[Block], x: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if len(blocks) != self.num_layers:
            raise ValueError(f"{len(blocks)} blocks for {self.num_layers} "
                             "layers")
        use_dropout = not deterministic and self.dropout > 0.0
        if use_dropout and generator is None:
            raise ValueError("dropout needs a generator")
        # An identity first block hands the raw features to K1 or K5: no
        # whole-array cast of the largest tensor.
        h = x if blocks[0].identity_offset is not None else x.to(self.dtype)
        # layer i's ReLU and layer i + 1's dropout follow each other: one
        # act_dropout call in a train step
        for i, (layer, block) in enumerate(zip(self.layers, blocks)):
            h = layer(block, h)
            if i != self.num_layers - 1:
                h = (act_dropout(h, "relu", self.dropout, generator)
                     if use_dropout else F.relu(h))
        return h
