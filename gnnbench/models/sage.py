"""GraphSAGE (mean aggregator), as the port's ``sage`` and ``lp_sage``
build it: per layer ``h' = W_self h_dst + b + W_neigh mean(h_src[nbr])``,
ReLU and dropout between layers, parameters ``layers.<i>.fc_self.weight``,
``layers.<i>.fc_self.bias`` and ``layers.<i>.fc_neigh.weight``."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from gnnbench.counting import sage_flops
from gnnbench.reference import quantize


def logits(weights: Dict[str, torch.Tensor], x: torch.Tensor,
           blocks: Sequence, drop: Sequence[Optional[torch.Tensor]],
           keep: float, lowp: bool = False) -> torch.Tensor:
    """The float32 forward (``models/__init__.py`` gives the contract);
    the model takes the blocks outermost first."""
    q = quantize if lowp else (lambda t: t)
    h = x
    n = len(blocks)
    for i in range(n):
        pos, mask = blocks[n - 1 - i][0], blocks[n - 1 - i][1]
        p = pos.shape[0]
        m = mask.to(h.dtype)
        rows = h[pos.reshape(-1)].reshape(pos.shape[0], pos.shape[1], -1)
        agg = (rows * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp(
            min=1.0)
        ws, bs, wn = (weights[f"layers.{i}.fc_self.weight"],
                      weights[f"layers.{i}.fc_self.bias"],
                      weights[f"layers.{i}.fc_neigh.weight"])
        h = (q(h[:p]) @ q(ws).T + bs) + q(agg) @ q(wn).T
        if i != n - 1:
            h = F.relu(h)
            if drop[i] is not None:
                h = torch.where(drop[i], h / keep, torch.zeros_like(h))
    return h


def in_width(weights: Dict[str, torch.Tensor]) -> int:
    return weights["layers.0.fc_self.weight"].shape[1]


def flops(sizes: Dict, model: Dict) -> Optional[int]:
    """``counting.sage_flops`` at the realized seeds and hop-1 frontier: a
    2-layer count, so None for any other depth."""
    if model["num_layers"] != 2:
        return None
    return sage_flops(round(sizes["seeds"]), round(sizes["hop1_rows"]),
                      sizes["hidden_dim"], sizes["feature_dim"],
                      sizes["num_classes"])
