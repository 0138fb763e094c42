"""GAT over sampled blocks: PyTorch Geometric's ``GATConv`` as its
``examples/ogbn_products_gat.py`` stacks it (Velickovic et al., "Graph
Attention Networks", ICLR 2018).

Per layer, for a block whose dst rows are the first ``dst_cap`` rows of
``h_src``:

* ``z = lin(h_src)``, shaped (S, H, C): one ``lin`` for sources and
  destinations, without bias;
* ``a_src = (z * att_src).sum(-1)``, ``a_dst = (z[:D] * att_dst).sum(-1)``;
* for each dst row ``d`` and head ``h``, over its valid slots whose
  position is not ``d`` plus one self slot ``d``:
  ``alpha = softmax(leaky_relu(a_src[j] + a_dst[d], 0.2))`` and
  ``out[d, h] = sum alpha z[j, h]`` (``ops/gat_attention.py``);
* the heads concatenated (the last layer: their mean), plus ``bias``,
  plus ``skip(h_dst)``, a linear with bias.

ELU and dropout between layers (one ``ops/act_dropout.py`` call in a
train step), none after the last. Dropping a sampled
slot that points at the dst's own row, then adding one self slot, is
``GATConv``'s ``remove_self_loops`` followed by ``add_self_loops`` in the
deduplicated numbering. So GAT needs every hop deduplicated
(``SamplerConfig(dedup_last=True)``): an identity-appended hop numbers a
dst's own id as a new row, where no slot can name it.

Mixed precision as in ``SAGEConv``: parameters stay float32 and are cast
to the compute dtype at each product; the attention scores, normalises
and sums in float32 inside the kernel. ``att_src`` and ``att_dst`` are
(H, C) matrices. The scores are computed as ``h_src @ (att * W)``, the
attention vectors folded into ``lin``'s weight per head (a (2H, K)
product beside ``lin``'s), which equals ``(z * att).sum(-1)`` and reads
no z row.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from legion_tpu_torch.models.sage import _lecun_normal_
from legion_tpu_torch.ops.act_dropout import act_dropout
from legion_tpu_torch.ops.gat_attention import (edge_softmax_aggregate,
                                               scored_slots)
from legion_tpu_torch.sampling.block import Block


class GATLayer(nn.Module):
    def __init__(self, in_dim: int, head_dim: int, heads: int, concat: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head_dim, self.heads, self.concat = head_dim, heads, concat
        self.dtype = dtype
        out = heads * head_dim if concat else head_dim
        self.lin = nn.Linear(in_dim, heads * head_dim, bias=False)
        self.att_src = nn.Parameter(torch.empty(heads, head_dim))
        self.att_dst = nn.Parameter(torch.empty(heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(out))
        self.skip = nn.Linear(in_dim, out, bias=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for w in (self.lin.weight, self.att_src, self.att_dst,
                  self.skip.weight):
            _lecun_normal_(w, generator)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.skip.bias)

    def project(self, h_src: torch.Tensor):
        """(h, z, a): ``h_src`` in the compute dtype, ``z = lin(h)`` as (S,
        H, C) and the scores ``a`` (S, 2H), ``a_src`` then ``a_dst`` of
        every row."""
        dt, heads, c = self.dtype, self.heads, self.head_dim
        h = h_src.to(dt)
        w = self.lin.weight
        z = F.linear(h, w.to(dt)).view(-1, heads, c)
        per_head = w.view(heads, c, -1)
        fold = torch.cat([torch.einsum("hck,hc->hk", per_head, self.att_src),
                          torch.einsum("hck,hc->hk", per_head,
                                       self.att_dst)])
        return h, z, F.linear(h, fold.to(dt))

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        if block.identity_offset is not None:
            raise ValueError(
                "GAT needs every hop deduplicated (SamplerConfig("
                "dedup_last=True)): an identity-appended block cannot show "
                "a slot that names its own dst row")
        dt, heads, c = self.dtype, self.heads, self.head_dim
        dn = block.dst_cap
        h, z, a = self.project(h_src)
        out = edge_softmax_aggregate(z, a[:, :heads], a[:dn, heads:],
                                     block.nbr_pos, block.nbr_mask,
                                     block.num_dst)
        out = out.reshape(dn, heads * c) if self.concat else out.mean(1)
        return out + self.bias.to(dt) + F.linear(
            h[:dn], self.skip.weight.to(dt), self.skip.bias.to(dt))


class GAT(nn.Module):
    """``num_layers`` GAT layers of ``heads`` heads of ``hidden_dim``
    (concatenated), the last averaging its heads of ``out_dim``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 3, heads: int = 4, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = dtype
        dims = [in_dim] + [heads * hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            GATLayer(dims[i], hidden_dim if i < num_layers - 1 else out_dim,
                     heads, i < num_layers - 1, dtype)
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
        h = x
        for i, (layer, block) in enumerate(zip(self.layers, blocks)):
            h = layer(block, h)
            if i != self.num_layers - 1:
                h = (act_dropout(h, "elu", self.dropout, generator)
                     if use_dropout else F.elu(h))
        return h

    def step_counts(self, blocks: Sequence[Block], rows: Sequence[int]
                    ) -> Dict[str, torch.Tensor]:
        """The step's counters (``train/graphed.py::METRICS``), each a 0-d
        int32 device tensor: ``attn_slots``, the slots the attention
        scores, self slots included, summed over the blocks in sampling
        order (``rows[k]``: the src rows block k's layer takes)."""
        total = torch.zeros((), dtype=torch.int32,
                            device=blocks[0].nbr_pos.device)
        for blk, n in zip(blocks, rows):
            total = total + scored_slots(blk.nbr_pos, blk.nbr_mask, n,
                                         blk.num_dst)
        return {"attn_slots": total}
