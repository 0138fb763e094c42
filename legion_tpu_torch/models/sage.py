"""GraphSAGE (mean aggregator) over sampled blocks (port of
``legion_tpu/models/sage.py``).

Per layer ``h' = W_self h_dst + W_neigh mean_{u in sampled N(dst)} h_u +
b``, with the bias on the self path only, ReLU and dropout between
layers and none after the last (one ``ops/act_dropout.py`` call in a
train step, ``F.relu`` alone in an eval step). Blocks arrive in model
order (outermost hop first); the dst nodes of a block are the first
``dst_cap`` src rows.

Mixed precision as in the reference: parameters stay float32 and are cast
to the compute dtype at each ``F.linear``; aggregation sums in float32
inside the kernels. The dense products stay ``F.linear``, as the JAX
package leaves them to XLA.

``agg`` picks the aggregator, as in the reference's ``AGGREGATORS``:
``"fanout"`` (default) runs K1 on an identity block and, on a gathered
one, K2 where the layer narrows or its input carries gradient, and
``gathered_feature_mean`` on rows without gradient that it does not
narrow; ``"coo_segment"`` is the scatter-based SpMM over the COO edge list
(``ops/segment.py::segment_mean_coo``, ``index_add_`` in the compute
dtype) on every block, with no transform-first and the features cast to
the compute dtype before layer 0. It is the benchmark's baseline and a
cross-check of the fanout path; the parameters are the same either way.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from legion_tpu_torch.ops.act_dropout import act_dropout
from legion_tpu_torch.ops.identity_agg import (gathered_feature_mean,
                                               gathered_masked_mean,
                                               identity_masked_mean)
from legion_tpu_torch.ops.segment import segment_mean_coo
from legion_tpu_torch.sampling.block import Block

AGGREGATORS = ("fanout", "coo_segment")


def _lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]):
    """flax's default Dense kernel init: truncated normal (2 std) with
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _check_agg(agg: str) -> None:
    if agg not in AGGREGATORS:
        raise ValueError(f"agg must be one of {AGGREGATORS}, got {agg!r}")


class SAGEConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, agg: str = "fanout"):
        super().__init__()
        _check_agg(agg)
        self.out_dim = out_dim
        self.dtype = dtype
        self.agg = agg
        self.fc_self = nn.Linear(in_dim, out_dim, bias=True)
        self.fc_neigh = nn.Linear(in_dim, out_dim, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _lecun_normal_(self.fc_self.weight, generator)
        _lecun_normal_(self.fc_neigh.weight, generator)
        nn.init.zeros_(self.fc_self.bias)

    def _dense(self, fc: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if fc.bias is None else fc.bias.to(dt)
        return F.linear(h.to(dt), fc.weight.to(dt), bias)

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        h_dst = h_src[: block.dst_cap]
        if self.agg == "coo_segment":
            h_neigh = self._dense(self.fc_neigh,
                                  segment_mean_coo(h_src, block))
        elif block.identity_offset is not None:
            # K1: contiguous slot rows, summed in f32, emitted in the
            # compute dtype in the same pass
            agg = identity_masked_mean(h_src, block.nbr_mask,
                                       block.identity_offset,
                                       out_dtype=self.dtype)
            h_neigh = self._dense(self.fc_neigh, agg)
        elif self.out_dim < h_src.shape[-1]:
            # fc_neigh has no bias and the mean is linear, so transforming
            # first is exact and narrows what K2 gathers and scatters
            h_t = self._dense(self.fc_neigh, h_src)
            h_neigh = gathered_masked_mean(h_t, block.nbr_pos,
                                           block.nbr_mask)
        elif h_src.requires_grad:
            # a layer that does not narrow aggregates first; a deeper
            # model's activations carry gradient, so K2 takes their mean
            agg = gathered_masked_mean(h_src, block.nbr_pos, block.nbr_mask)
            h_neigh = self._dense(self.fc_neigh, agg)
        else:
            # raw features (or an eval step's activations) carry no
            # gradient: one pass, summed in f32, emitted in the compute dtype
            agg = gathered_feature_mean(h_src, block.nbr_pos, block.nbr_mask,
                                        out_dtype=self.dtype)
            h_neigh = self._dense(self.fc_neigh, agg)
        return self._dense(self.fc_self, h_dst) + h_neigh


class SAGE(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 agg: str = "fanout"):
        super().__init__()
        _check_agg(agg)
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = dtype
        self.agg = agg
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], dtype, agg)
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
        # An identity first block feeds K1 the raw features, which casts
        # only what it emits: no whole-array cast of the largest tensor.
        # The baseline casts them all, as the reference does.
        h = (x if self.agg == "fanout"
             and blocks[0].identity_offset is not None else x.to(self.dtype))
        for i, (layer, block) in enumerate(zip(self.layers, blocks)):
            h = layer(block, h)
            if i != self.num_layers - 1:
                h = (act_dropout(h, "relu", self.dropout, generator)
                     if use_dropout else F.relu(h))
        return h
