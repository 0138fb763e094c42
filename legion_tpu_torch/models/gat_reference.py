"""A plain reference of the GAT that ``models/gat.py`` runs: PyTorch
Geometric's ``GATConv`` written out over an edge list, as PyG computes
it, in float32 plain PyTorch. It imports no kernel of the port and
nothing of JAX, and ``logits`` sets TF32 off (``no_tf32``), so its
products are float32 on any device.

A layer takes the src rows ``x`` (S, K), the number of dst rows ``D``
(the first D rows of ``x``, PyG's ``x_target``) and an edge list
``(src, dst)`` over them; as ``GATConv`` does, it removes the edges
``src == dst`` and adds one self loop ``(d, d)`` for every ``d < D``
(``remove_self_loops``, ``add_self_loops``), scores each edge and head
``leaky_relu(a_src[src] + a_dst[dst], 0.2)``, takes the softmax over each
dst's edges by a scatter (the max and the sum through ``index_reduce`` and
``index_add``, PyG's ``softmax``), and sums the messages ``alpha *
z[src]`` into their dst by ``index_add``. Then the heads concatenated (the
last layer: their mean), ``bias``, and ``skip(x[:D])``; ELU and dropout
between layers (PyG's ``examples/ogbn_products_gat.py``).

Departures from PyG's example, each the port's:

* the sampler: the port's sampled blocks (Legion's fanout sampler, every
  hop deduplicated) stand in for PyG's ``NeighborSampler``; the edge
  list of a block is ``blocks_to_edges`` of its valid slots;
* the products: the port runs them in bf16 (``ModelConfig.dtype``) with
  float32 parameters; this reference is float32 throughout;
* dropout: masks are given (``drop``), so that a comparison follows the
  program's draws.

``logits`` is the forward and ``loss`` the masked cross-entropy;
gradients come through autograd. Parameters are a dict under the port's
names: ``layers.<i>.lin.weight``, ``.att_src``, ``.att_dst``, ``.bias``,
``.skip.weight``, ``.skip.bias``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

NEGATIVE_SLOPE = 0.2


def no_tf32() -> None:
    """Float32 products in float32 (TF32 would be a lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def blocks_to_edges(nbr_pos: torch.Tensor, nbr_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) int64 of a block's valid slots: slot (d, j) is the edge
    ``nbr_pos[d, j] -> d``."""
    d, j = torch.nonzero(nbr_mask, as_tuple=True)
    return nbr_pos[d, j].long(), d.long()


def self_loops(src: torch.Tensor, dst: torch.Tensor, num_dst: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyG's ``remove_self_loops`` then ``add_self_loops`` for a
    bipartite block whose first ``num_dst`` src rows are its dst rows."""
    keep = src != dst
    loops = torch.arange(num_dst, device=src.device)
    return (torch.cat([src[keep], loops]), torch.cat([dst[keep], loops]))


def scatter_softmax(e: torch.Tensor, index: torch.Tensor,
                    num: int) -> torch.Tensor:
    """Softmax of ``e`` (E, H) over the entries of each ``index`` value,
    as PyG's ``utils.softmax``: the max subtracted per group."""
    top = torch.full((num, e.shape[1]), float("-inf"), dtype=e.dtype,
                     device=e.device)
    top = top.index_reduce(0, index, e.detach(), "amax", include_self=True)
    p = torch.exp(e - top[index])
    den = torch.zeros((num, e.shape[1]), dtype=e.dtype,
                      device=e.device).index_add(0, index, p)
    return p / den[index]


def gat_conv(w: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
             num_dst: int, src: torch.Tensor, dst: torch.Tensor,
             heads: int, concat: bool) -> torch.Tensor:
    """One ``GATConv`` with its skip, over the edges (src, dst)."""
    lin, att_src, att_dst = (w[prefix + "lin.weight"], w[prefix + "att_src"],
                             w[prefix + "att_dst"])
    c = att_src.shape[1]
    z = (x @ lin.T).view(-1, heads, c)                       # (S, H, C)
    a_src = (z * att_src).sum(-1)
    a_dst = (z[:num_dst] * att_dst).sum(-1)
    src, dst = self_loops(src, dst, num_dst)
    e = F.leaky_relu(a_src[src] + a_dst[dst], NEGATIVE_SLOPE)
    alpha = scatter_softmax(e, dst, num_dst)                 # (E, H)
    out = torch.zeros((num_dst, heads, c), dtype=x.dtype,
                      device=x.device).index_add(0, dst,
                                                 alpha[..., None] * z[src])
    out = out.reshape(num_dst, heads * c) if concat else out.mean(1)
    skip = x[:num_dst] @ w[prefix + "skip.weight"].T + w[prefix + "skip.bias"]
    return out + w[prefix + "bias"] + skip


def logits(w: Dict[str, torch.Tensor], x: torch.Tensor,
           blocks: Sequence[Tuple[torch.Tensor, torch.Tensor]], heads: int,
           drop: Optional[Sequence[Optional[torch.Tensor]]] = None,
           keep: float = 1.0) -> torch.Tensor:
    """The forward over ``blocks`` in model order (outermost first), each
    ``(nbr_pos, nbr_mask)``; block i's dst rows are the first
    ``nbr_pos.shape[0]`` rows of its input. ``drop[i]``: layer i's kept
    entries (None: no dropout), kept values scaled by ``1 / keep``."""
    no_tf32()
    h = x
    n = len(blocks)
    for i, (pos, mask) in enumerate(blocks):
        src, dst = blocks_to_edges(pos, mask)
        h = gat_conv(w, f"layers.{i}.", h, pos.shape[0], src, dst, heads,
                     concat=i < n - 1)
        if i < n - 1:
            h = F.elu(h)
            if drop is not None and drop[i] is not None:
                h = torch.where(drop[i], h / keep, torch.zeros_like(h))
    return h


def loss(out: torch.Tensor, labels: torch.Tensor, num: int) -> torch.Tensor:
    """Mean cross-entropy over the first ``num`` rows."""
    return F.cross_entropy(out[:num], labels[:num].long())


def parameter_names(num_layers: int) -> List[str]:
    return [f"layers.{i}.{k}" for i in range(num_layers)
            for k in ("lin.weight", "att_src", "att_dst", "bias",
                      "skip.weight", "skip.bias")]
