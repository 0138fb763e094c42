"""GAT, as the port's ``gat`` builds it: PyTorch Geometric's ``GATConv``
stacked as in its ``examples/ogbn_products_gat.py``. Per layer ``z =
lin(h)`` (H heads of C), ``a_src = (z * att_src).sum(-1)``, ``a_dst =
(z[:D] * att_dst).sum(-1)``; for each dst row d and head, over its valid
slots whose position is not d plus one self slot d, ``alpha =
softmax(leaky_relu(a_src[j] + a_dst[d], 0.2))`` and ``out[d] = sum alpha
z[j]``; the heads concatenated (the last layer: their mean), plus
``bias``, plus ``skip(h[:D])``; ELU and dropout between layers.
Parameters ``layers.<i>.lin.weight``, ``.att_src``, ``.att_dst`` ((H, C)
each), ``.bias``, ``.skip.weight``, ``.skip.bias``.

The attention runs over chunks of dst rows, each recomputed in the
backward (``torch.utils.checkpoint``), so that the reference fits on the
card beside what the run keeps: layer 0's messages of the products cell
alone are 9.4 GB in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gnnbench.reference import quantize

NEGATIVE_SLOPE = 0.2
# dst rows whose messages are held at once
CHUNK = 1 << 15


def _attend(z: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
            pos: torch.Tensor, mask: torch.Tensor, first: int) -> torch.Tensor:
    """The attention of dst rows ``first .. first + len(pos)``: (rows, H,
    C) from z (S, H, C), a_src (S, H), their a_dst and slots."""
    s = z.shape[0]
    rows = torch.arange(first, first + pos.shape[0], device=pos.device)
    ok = mask & (pos != rows[:, None]) & (pos >= 0) & (pos < s)
    at = torch.cat([pos.clamp(0, s - 1), rows[:, None]], 1)
    ok = torch.cat([ok, torch.ones_like(ok[:, :1])], 1)
    e = F.leaky_relu(a_src[at] + a_dst[:, None, :], NEGATIVE_SLOPE)
    alpha = torch.softmax(e.masked_fill(~ok[..., None], float("-inf")), 1)
    return (alpha[..., None] * z[at]).sum(1)


def _layer(w: Dict[str, torch.Tensor], i: int, h: torch.Tensor,
           pos: torch.Tensor, mask: torch.Tensor, concat: bool,
           q) -> torch.Tensor:
    p = f"layers.{i}."
    att_src, att_dst = w[p + "att_src"], w[p + "att_dst"]
    heads, c = att_src.shape
    dn = pos.shape[0]
    z = (q(h) @ q(w[p + "lin.weight"]).T).view(-1, heads, c)
    a_src = (z * att_src).sum(-1)
    a_dst = (z[:dn] * att_dst).sum(-1)
    out = torch.cat([
        checkpoint(_attend, z, a_src, a_dst[r:r + CHUNK], pos[r:r + CHUNK],
                   mask[r:r + CHUNK], r, use_reentrant=False)
        for r in range(0, dn, CHUNK)])
    out = out.reshape(dn, heads * c) if concat else out.mean(1)
    return (out + w[p + "bias"] + q(h[:dn]) @ q(w[p + "skip.weight"]).T
            + w[p + "skip.bias"])


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
        h = _layer(weights, i, h, pos, mask, i != n - 1, q)
        if i != n - 1:
            h = F.elu(h)
            if drop[i] is not None:
                h = torch.where(drop[i], h / keep, torch.zeros_like(h))
    return h


def in_width(weights: Dict[str, torch.Tensor]) -> int:
    return weights["layers.0.lin.weight"].shape[1]


def flops(sizes: Dict, model: Dict) -> Optional[int]:
    """The step's matrix-product operations at the realized sizes: at each
    layer ``lin`` over its src rows and ``skip`` over its dst rows; layer
    0's inputs are features, so its backward is the weight gradients
    alone (2x forward), every other layer's has both gradients (3x). The
    attention's scores and weighted sums are not matrix products."""
    blocks = sizes["blocks"]
    n = len(blocks)
    wide = model["num_heads"] * model["hidden_dim"]
    total = 0
    for i in range(n):
        b = blocks[n - 1 - i]
        k = sizes["feature_dim"] if i == 0 else wide
        last = i == n - 1
        lin = model["num_heads"] * (sizes["num_classes"] if last
                                    else model["hidden_dim"])
        skip = sizes["num_classes"] if last else wide
        fwd = (2 * round(b["num_src"]) * k * lin
               + 2 * round(b["num_dst"]) * k * skip)
        total += fwd * (2 if i == 0 else 3)
    return total
