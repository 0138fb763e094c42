"""The plain reference that decides ``correct``: the configuration's
model (its forward from ``models.module(arch)``), its masked
cross-entropy, its gradients and Adam, in float32 plain PyTorch, and a
check of sampled blocks against the CSR they were drawn from. It imports
nothing of the port: it reads the cell's inputs (the arrays ``graphgen``
made and handed to the program) and the program's outputs, which it
judges.

A step ``s`` the program ran is a dict of host tensors:

* ``seeds`` (cap0,) int32, -1 padded, ``num_seeds``, ``labels`` (cap0,);
* ``frontier`` (M,) int32: the batch's node ids in the program's
  numbering ``[seeds | hop-1 new | hop-2 new]``, -1 padded;
* ``blocks``: per hop in sampling order ``(nbr_pos, nbr_mask, num_src,
  num_dst, identity_offset)``; the dst rows of hop k are rows
  ``[0, nbr_pos.shape[0])`` of the frontier, its src rows are
  ``frontier[nbr_pos]``;
* ``rels``: per hop in sampling order, the relation id of each slot's
  edge (``nbr_pos``'s shape; the port's ``Block.nbr_rel``), or None where
  the block carries none (every block of a homogeneous graph);
* ``h``: by entry ``i`` of the program's ``model.layers`` (its blocks'
  layers, then any head entries), the hidden rows that reached entry
  ``i``, after dropout (their zeros give the dropout mask the program
  drew on entry ``i - 1``'s output), None where nothing was noted
  (always entry 0);
* ``x``: the feature rows the program delivered to the model, where the
  step was observed outside a graph replay (else None).

Sampling and dropout are random, so the reference follows the program's
draws: it checks each drawn block against the CSR (``sampler_faults``)
and takes the dropout masks from ``h``, then computes everything else
from the inputs and its own weights. A step's feature rows are gathered
from the table where it lives, the host in a run's check, and moved to
the device one step at a time (``frontier_rows``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gnnbench import models

# the float8 format the control rounds every matrix operand to
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in float32 (TF32 would be a lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- the sampler's blocks -----------------------------------------------------

def _edge_of(indptr: torch.Tensor, indices: torch.Tensor, v: torch.Tensor,
             u: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
    """(n,) int64: the address in ``indices`` of the first edge from
    ``u[i]`` into ``v[i]``, -1 where ``u[i]`` is no in-neighbour of
    ``v[i]``."""
    out = torch.full((v.shape[0],), -1, dtype=torch.int64, device=v.device)
    for s in range(0, v.shape[0], chunk):
        vs, us = v[s:s + chunk].long(), u[s:s + chunk]
        start, deg = indptr[vs], indptr[vs + 1] - indptr[vs]
        width = int(deg.max()) if deg.numel() else 0
        if width == 0:
            continue
        j = torch.arange(width, device=v.device)
        addr = (start[:, None] + j).clamp(max=indices.shape[0] - 1)
        hit = (indices[addr] == us[:, None]) & (j < deg[:, None])
        first = hit.to(torch.uint8).argmax(1)
        out[s:s + chunk] = torch.where(hit.any(1), start + first, -1)
    return out


def sampler_faults(step: Dict, indptr: torch.Tensor, indices: torch.Tensor,
                   edge_rel: Optional[torch.Tensor] = None,
                   node_type_offsets: Optional[torch.Tensor] = None) -> int:
    """How many of the step's sampled rows break the sampler's contract:
    the seeds lead the frontier; a dst row ``d`` below ``num_dst`` holds
    ``min(deg, fanout)`` valid slots, the first ones, each naming an
    in-neighbour of ``frontier[d]``; rows past ``num_dst`` hold none; a
    deduplicated hop numbers distinct ids, each new one drawn in this hop,
    and points every slot inside its count; an identity-appended hop puts
    slot ``(d, j)`` at row ``offset + d * fanout + j``; the ids past the
    last count are padding. On a typed graph (``edge_rel``: each edge's
    relation id) each valid slot's ``rels`` entry is the relation of the
    edge it names, and a block without ``rels`` counts every live dst row;
    with ``node_type_offsets`` each seed is of type 0, the labelled one."""
    dev = indptr.device
    fr = step["frontier"].to(dev).long()
    seeds = step["seeds"].to(dev).long()
    ns = int(step["num_seeds"])
    faults = int((fr[:ns] != seeds[:ns]).sum())
    if node_type_offsets is not None:
        faults += int((seeds[:ns] >= int(node_type_offsets[1])).sum())
    rels = step.get("rels") or [None] * len(step["blocks"])
    prev = ns
    for (pos, mask, num_src, num_dst, off), rel in zip(step["blocks"], rels):
        pos, mask = pos.to(dev).long(), mask.to(dev)
        p, f = pos.shape
        num_src, num_dst = int(num_src), int(num_dst)
        faults += int(num_dst != prev)
        rows = torch.arange(p, device=dev)
        live = rows < num_dst
        v = torch.where(live, fr[:p], 0)
        deg = indptr[v + 1] - indptr[v]
        want = live[:, None] & (torch.arange(f, device=dev)[None, :]
                                < deg[:, None])
        bad_row = (mask != want).any(1)
        if off is not None:
            ident = off + rows[:, None] * f + torch.arange(f, device=dev)
            bad_row |= (pos != ident).any(1)
            hole = fr[off:off + p * f].reshape(p, f)
            bad_row |= ((hole >= 0) != mask).any(1)
        safe = torch.where(mask, pos, 0).clamp(max=fr.shape[0] - 1)
        bad_row |= (mask & ((pos < 0) | (pos >= num_src))).any(1)
        dd, jj = torch.nonzero(mask, as_tuple=True)
        u = fr[safe[dd, jj]]
        addr = _edge_of(indptr, indices, fr[dd].clamp(min=0), u.clamp(min=0))
        ok = (u >= 0) & (addr >= 0)
        if edge_rel is not None:
            if rel is None:
                bad_row |= live
            else:
                ok &= edge_rel[addr.clamp(min=0)].long() == \
                    rel.to(dev).long()[dd, jj]
        bad = torch.zeros(p, dtype=torch.bool, device=dev)
        bad[dd[~ok]] = True
        faults += int((bad_row | bad).sum())
        if off is None:
            ids = fr[:num_src]
            faults += int((ids < 0).sum())
            faults += num_src - int(torch.unique(ids).numel())
            used = torch.zeros(num_src, dtype=torch.bool, device=dev)
            used[safe[mask].clamp(max=max(num_src - 1, 0))] = True
            faults += int((~used[num_dst:]).sum())       # a new id not drawn
        prev = num_src
    faults += int((fr[prev:] != -1).sum())
    return faults


# -- the rows delivered -----------------------------------------------------

def frontier_rows(features, frontier: torch.Tensor, device) -> torch.Tensor:
    """(M, F) on ``device``: the feature row of each id of ``frontier``
    in the table's own dtype, a zero row for padding. The rows are
    gathered where ``features`` (a numpy array or a tensor) lives, the
    host for a run's check, and only they are moved: the table is never
    copied to the device whole."""
    table = torch.as_tensor(features)
    fr = frontier.to(table.device).long()
    live = fr >= 0
    rows = torch.zeros((fr.shape[0], table.shape[1]), dtype=table.dtype,
                       device=table.device)
    rows[live] = table[fr[live]]
    return rows.to(device)


def row_faults(x: torch.Tensor, frontier: torch.Tensor, features,
               device) -> int:
    """Rows of ``x`` that are not the feature row of their frontier id in
    ``x``'s dtype (zero columns past the table's width, a zero row for
    padding), compared on ``device``."""
    rows = frontier_rows(features, frontier, device)
    want = torch.zeros((rows.shape[0], x.shape[1]), dtype=x.dtype,
                       device=device)
    want[:, :rows.shape[1]] = rows.to(x.dtype)
    return int((x.to(device) != want).any(1).sum())


# -- the model step ---------------------------------------------------------

def quantize(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale (its largest
    magnitude to the format's largest), back in float32; the gradient
    passes through unchanged."""
    amax = t.detach().abs().max().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).to(FP8).to(torch.float32) / scale
    return t + (q - t.detach())


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              num: int) -> torch.Tensor:
    """Mean cross-entropy over the first ``num`` rows."""
    lab = labels[:num].long()
    return F.cross_entropy(logits[:num].float(), lab)


class Adam:
    """Adam with bias correction (b1, b2, eps as the configuration states)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            denom = (self.v[k] / c2).sqrt() + self.eps
            out[k] = p - self.lr * (self.m[k] / c1) / denom
        return out


def drop_masks(step: Dict, layers: int, device) -> List[Optional[torch.Tensor]]:
    """Entry i's kept entries, read from the hidden rows the program fed
    entry i + 1 of ``model.layers`` (a kept entry of a positive ReLU
    output is nonzero; a zero one contributes nothing either way)."""
    masks: List[Optional[torch.Tensor]] = [None] * layers
    for i, h in enumerate(step["h"][1:layers], start=1):
        if h is not None:
            masks[i - 1] = h.to(device) != 0
    return masks


def follow(steps: Sequence[Dict], weights0: Dict[str, torch.Tensor],
           features, model: Dict, lowp: bool = False,
           keep_half: bool = False, device=None) -> Dict:
    """The reference run of ``steps`` on ``device`` (default: where
    ``features`` is), each step's rows gathered from ``features`` by
    ``frontier_rows``: per step the loss, the first step's gradient, and
    the parameters after the last. ``lowp``: every product in float8 (the
    control). ``keep_half``: the loss over the first half of each batch's
    seeds only (a planted fault)."""
    arch = models.module(model["arch"])
    dev = torch.as_tensor(features).device if device is None \
        else torch.device(device)
    params = {k: v.to(dev, torch.float32).clone() for k, v in weights0.items()}
    opt = Adam(params, model["learning_rate"], tuple(model["adam_betas"]),
               model["adam_eps"])
    keep = 1.0 - model["dropout"]
    typed = getattr(arch, "TYPED", False)
    losses, first_grad = [], None
    for step in steps:
        rows = frontier_rows(features, step["frontier"], dev)
        x = torch.zeros((rows.shape[0], arch.in_width(params)),
                        dtype=torch.float32, device=dev)
        x[:, :rows.shape[1]] = rows.float()
        blocks = [(b[0].to(dev).long(), b[1].to(dev)) for b in step["blocks"]]
        extra = {}
        if typed:
            rels = step.get("rels") or [None] * len(blocks)
            extra = {"rels": [None if r is None else r.to(dev).long()
                              for r in rels],
                     "num_dst": [int(b[3]) for b in step["blocks"]]}
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        logits = arch.logits(leaves, x, blocks,
                             drop_masks(step, len(step["h"]), dev), keep,
                             lowp, **extra)
        num = int(step["num_seeds"])
        loss = masked_ce(logits, step["labels"].to(dev),
                         num // 2 if keep_half else num)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        params = opt.step(params, grads)
        del x, logits, leaves
    return {"losses": losses, "first_grad": first_grad, "params": params}


# -- the numbers compared ---------------------------------------------------

def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def worst_leaf_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   leaves: Optional[Sequence[str]] = None) -> float:
    """The largest gap between a leaf's norm in ``got`` and in ``ref``,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    keys = list(leaves if leaves is not None else ref)
    rn = _norms({k: ref[k] for k in keys})
    gn = _norms({k: got[k] for k in keys})
    med = float(np.median(list(rn.values()))) if rn else 0.0
    gaps = [abs(gn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys]
    return max(gaps) if gaps else 0.0


def moved_leaves(first_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose first gradient is not nought to rounding: a norm of at
    least a thousandth of the median leaf's (the others move under Adam by
    round-off alone)."""
    n = _norms(first_grad)
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= 1e-3 * med]


def compare(got: Dict, ref: Dict, weights0: Dict[str, torch.Tensor]) -> Dict:
    """The training numbers of ``got`` (a program's or the control's run
    of the same steps) against the reference's: ``loss_gap`` (the worst
    step's relative loss gap), ``grad_gap`` (the first gradient, worst
    leaf) and ``change_gap`` (the parameters' change over the steps,
    worst moved leaf), with the count of leaves left out of the last."""
    lg = max(abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(got["losses"], ref["losses"]))
    dev = next(iter(ref["params"].values())).device
    w0 = {k: v.to(dev, torch.float32) for k, v in weights0.items()}
    d_got = {k: got["params"][k].to(dev, torch.float32) - w0[k] for k in w0}
    d_ref = {k: ref["params"][k] - w0[k] for k in w0}
    moved = moved_leaves(ref["first_grad"])
    return {"leaves_left_out": len(w0) - len(moved), "loss_gap": lg,
            "grad_gap": worst_leaf_gap(
                {k: v.to(dev) for k, v in got["first_grad"].items()},
                ref["first_grad"]),
            "change_gap": worst_leaf_gap(d_got, d_ref, moved)}


def initial_weights(shapes: Dict[str, Sequence[int]], seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """The weights both sides start from: each matrix normal with variance
    1 / fan_in, drawn on ``device`` in one call from ``seed``; a vector
    named ``*.weight`` (a normalisation's scale) one, every other vector
    (a bias, a normalisation's shift) zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    total = sum(math.prod(s) for s in mats.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if len(s) == 2:
            n = math.prod(s)
            out[k] = flat[at:at + n].reshape(s) / math.sqrt(s[1])
            at += n
        elif k.endswith(".weight"):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out
