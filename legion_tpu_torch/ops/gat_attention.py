"""GAT's edge-softmax aggregation over a block's fanout slots.

For each dst row ``d < num_dst`` and head ``h`` the slots scored are the
valid sampled slots of row ``d`` whose position is not ``d`` itself, plus
one self slot at position ``d``: PyTorch Geometric's ``GATConv`` after
``remove_self_loops`` and ``add_self_loops``, in the deduplicated
numbering, where the dst rows are the first rows of the src frontier. For
a scored slot at position ``j``:

    e = leaky_relu(a_src[j, h] + a_dst[d, h], 0.2)
    alpha = softmax over the row's scored slots of e
    out[d, h] = sum alpha * z[j, h]

``z`` is ``(S, H, C)``, ``a_src`` ``(S, H)``, ``a_dst`` ``(D, H)``, all in
one dtype (float32 or bfloat16; the score rows may lie apart: column
slices of a wider buffer), ``nbr_pos`` ``(D, F)`` int32 and ``nbr_mask``
``(D, F)`` bool; ``out`` is ``(D, H, C)`` in z's dtype, scored, normalised
and summed in float32. A row with no scored slot but its self slot gets
``z[d]``; a row at or past ``num_dst`` scores nothing and is zero. A
valid slot whose position lies outside z's rows (only after a cap
overflow, which the train step reports) is not scored.

It replaces no TPU kernel: ``legion_tpu`` has no GAT. On the card the
forward is one CUDA kernel (``edge_softmax_fwd_kernel``) and the backward
two launchers of kernels named ``edge_softmax_*`` (a zero fill and a
count, then a placement, the src-row pass, the dst-row pass and a cast),
with PyTorch's cumsum between them; all are bound together in a
``torch.autograd.Function``, and the designs are in
``csrc/legion_kernels.cu``. A CPU tensor takes the plain PyTorch version
beside them, differentiable through autograd; a CUDA tensor takes the
kernels or raises. ``scored_slots`` counts the slots scored, as the train
step's ``attn_slots`` counter does; ``edge_softmax_traffic`` the bytes
the kernels must move, for their bound.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from legion_tpu_torch.ops import _build

NEGATIVE_SLOPE = 0.2
# a src row named by more slots than this is split into chunks of this
# many for the backward's src-row pass (the hubs of a skewed graph)
CHUNK = 32


def scored(nbr_pos: torch.Tensor, nbr_mask: torch.Tensor, num_rows: int,
           num_dst: Optional[torch.Tensor]) -> torch.Tensor:
    """(D, F + 1) bool: which slots a row scores, the self slot last."""
    d = torch.arange(nbr_pos.shape[0], device=nbr_pos.device)
    live = d < (nbr_pos.shape[0] if num_dst is None else num_dst)
    sampled = (nbr_mask & (nbr_pos != d[:, None]) & (nbr_pos >= 0)
               & (nbr_pos < num_rows) & live[:, None])
    return torch.cat([sampled, live[:, None]], 1)


def scored_slots(nbr_pos: torch.Tensor, nbr_mask: torch.Tensor,
                 num_rows: int,
                 num_dst: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The slots one block's attention scores, self slots included, as a
    0-d int32 device tensor (no host read)."""
    return scored(nbr_pos, nbr_mask, num_rows, num_dst).sum(
        dtype=torch.int32)


def edge_softmax_aggregate_plain(z, a_src, a_dst, nbr_pos, nbr_mask,
                                 num_dst=None):
    """Plain PyTorch version; differentiable in z, a_src and a_dst."""
    s, _, _ = z.shape
    dn = nbr_pos.shape[0]
    ok = scored(nbr_pos, nbr_mask, s, num_dst)                # (D, F+1)
    rows = torch.arange(dn, device=z.device)[:, None]
    pos = torch.cat([nbr_pos.clamp(0, s - 1), rows], 1).long()
    e = F.leaky_relu(a_src.float()[pos] + a_dst.float()[:, None, :],
                     NEGATIVE_SLOPE)                           # (D, F+1, H)
    e = e.masked_fill(~ok[..., None], float("-inf"))
    top = e.amax(1, keepdim=True)
    p = torch.exp(e - torch.where(torch.isfinite(top), top,
                                  torch.zeros_like(top)))
    alpha = p / p.sum(1, keepdim=True).clamp(min=torch.finfo(
        torch.float32).tiny)
    out = (alpha[..., None] * z.float()[pos]).sum(1)           # (D, H, C)
    return out.to(z.dtype)


def _check(z, a_src, a_dst, nbr_pos, nbr_mask):
    if z.dim() != 3 or a_src.dim() != 2 or a_dst.dim() != 2:
        raise ValueError("want z (S, H, C), a_src (S, H) and a_dst (D, H)")
    s, h, _ = z.shape
    dn, f = nbr_pos.shape
    if (a_src.shape != (s, h) or a_dst.shape != (dn, h) or dn > s
            or nbr_mask.shape != nbr_pos.shape):
        raise ValueError(f"shapes disagree: z {tuple(z.shape)}, a_src "
                         f"{tuple(a_src.shape)}, a_dst {tuple(a_dst.shape)},"
                         f" nbr_pos {tuple(nbr_pos.shape)}, nbr_mask "
                         f"{tuple(nbr_mask.shape)} (D <= S)")
    if nbr_pos.dtype != torch.int32 or nbr_mask.dtype != torch.bool:
        raise ValueError("nbr_pos must be int32 and nbr_mask bool")
    if z.dtype not in _build.DTYPE_CODES or a_src.dtype != z.dtype or \
            a_dst.dtype != z.dtype:
        raise ValueError(f"z, a_src and a_dst must share one dtype of "
                         f"{tuple(_build.DTYPE_CODES)}; got {z.dtype}, "
                         f"{a_src.dtype}, {a_dst.dtype}")


def _row_stride(a: torch.Tensor) -> int:
    """The row stride of a score matrix whose heads lie side by side."""
    if a.shape[1] > 1 and a.stride(1) != 1:
        raise ValueError(f"score rows must hold their heads side by side; "
                         f"strides {a.stride()}")
    return a.stride(0) if a.shape[0] > 1 else a.shape[1]


def _num_dst_ptr(num_dst: Optional[torch.Tensor], dn: int,
                 dev) -> torch.Tensor:
    if num_dst is None:
        return torch.full((), dn, dtype=torch.int32, device=dev)
    if num_dst.dtype != torch.int32 or num_dst.dim() != 0:
        raise ValueError("num_dst must be a 0-d int32 tensor")
    return num_dst


def _forward_cuda(z, a_src, a_dst, nbr_pos, nbr_mask, num_dst):
    """(out, stats): stats (D, H, 2) f32, each row and head's softmax
    (max, 1 / sum), kept for the backward."""
    _build.require_cuda(z, nbr_pos, nbr_mask, num_dst)
    s, h, c = z.shape
    dn, f = nbr_pos.shape
    out = torch.empty((dn, h, c), dtype=z.dtype, device=z.device)
    stats = torch.empty((dn, h, 2), dtype=torch.float32, device=z.device)
    if out.numel() == 0:
        return out, stats
    lib = _build.load_library()
    _build.check(lib.legion_edge_softmax_fwd(
        z.data_ptr(), a_src.data_ptr(), _row_stride(a_src), a_dst.data_ptr(),
        _row_stride(a_dst), _build.DTYPE_CODES[z.dtype], nbr_pos.data_ptr(),
        nbr_mask.view(torch.uint8).data_ptr(), num_dst.data_ptr(),
        out.data_ptr(), stats.data_ptr(), s, dn, f, h, c,
        _build.stream_of(z)), "edge_softmax_aggregate")
    edge_softmax_aggregate.launches += 1
    return out, stats


def edge_softmax_aggregate_backward(g, z, a_src, a_dst, nbr_pos, nbr_mask,
                                    num_dst, stats):
    """The kernels' backward: (dz (S, H, C), da_src (S, H), da_dst (D, H))
    in z's dtype from the output's gradient ``g`` (D, H, C) and the
    forward's ``stats``. The scored slots are turned around by position
    (a count, PyTorch's cumsum of the counts, a placement, each placed
    slot's weights), then one pass a src row writes its dz row once and
    each slot's dot ``g . z``, and one pass a dst row runs the softmax's
    backward: ``da_dst`` once a row, ``da_src`` through f32 atomics and a
    cast."""
    _build.require_cuda(g, z, nbr_pos, nbr_mask, num_dst, stats)
    s, h, c = z.shape
    dn, f = nbr_pos.shape
    dev = z.device
    dz = torch.empty((s, h, c), dtype=z.dtype, device=dev)
    da_src = torch.empty((s, h), dtype=z.dtype, device=dev)
    da_dst = torch.empty((dn, h), dtype=z.dtype, device=dev)
    if dz.numel() == 0:
        return dz, da_src, da_dst
    # counts (S + 1), ranks (S) and da_src's f32 sums (S * H), zeroed in
    # one pass
    words = torch.empty((2 * s + 1 + s * h,), dtype=torch.int32, device=dev)
    cur, da_s = words[s + 1:].split([s, s * h])
    pos_p = nbr_pos.data_ptr()
    mask_p = nbr_mask.view(torch.uint8).data_ptr()
    stream = _build.stream_of(z)
    lib = _build.load_library()
    _build.check(lib.legion_edge_softmax_bwd_count(
        pos_p, mask_p, num_dst.data_ptr(), words.data_ptr(), words.numel(),
        s, dn, f, stream), "edge_softmax_aggregate_backward")
    off = torch.cumsum(words[:s + 1], 0, dtype=torch.int32)
    slots = dn * (f + 1)
    entries = torch.empty((slots,), dtype=torch.int32, device=dev)
    # each placed slot's weights, then each slot's g . z, heads side by side
    weights, dalpha = torch.empty((2, slots * h), dtype=torch.float32,
                                  device=dev)
    # the rows named by more than CHUNK slots, numbered (hrank), and their
    # chunks of CHUNK entries, numbered (cprefix); each such row has more
    # than CHUNK entries, so there are fewer than slots / CHUNK of them and
    # fewer than 2 * slots / CHUNK chunks
    named = words[1:s + 1]
    heavy = named > CHUNK
    hrank = torch.cumsum(heavy, 0, dtype=torch.int32)
    cprefix = torch.cumsum(torch.where(heavy, (named + CHUNK - 1) // CHUNK,
                                       0), 0, dtype=torch.int32)
    stage_rows = slots // (CHUNK + 1) + 1
    stage = torch.empty((stage_rows * h * c,), dtype=torch.float32,
                        device=dev)
    _build.check(lib.legion_edge_softmax_bwd(
        g.data_ptr(), z.data_ptr(), a_src.data_ptr(), _row_stride(a_src),
        a_dst.data_ptr(), _row_stride(a_dst), _build.DTYPE_CODES[z.dtype],
        pos_p, mask_p, num_dst.data_ptr(), stats.data_ptr(), off.data_ptr(),
        cur.data_ptr(), entries.data_ptr(), weights.data_ptr(),
        dalpha.data_ptr(), da_s.data_ptr(), hrank.data_ptr(),
        cprefix.data_ptr(), stage.data_ptr(), stage_rows,
        2 * slots // CHUNK + 1, CHUNK, dz.data_ptr(), da_src.data_ptr(),
        da_dst.data_ptr(), s, dn, f, h, c, stream),
        "edge_softmax_aggregate_backward")
    edge_softmax_aggregate_backward.launches += 1
    return dz, da_src, da_dst


class _EdgeSoftmaxAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, a_src, a_dst, nbr_pos, nbr_mask, num_dst):
        out, stats = _forward_cuda(z, a_src, a_dst, nbr_pos, nbr_mask,
                                   num_dst)
        ctx.save_for_backward(z, a_src, a_dst, nbr_pos, nbr_mask, num_dst,
                              stats)
        return out

    @staticmethod
    def backward(ctx, g):
        dz, da_src, da_dst = edge_softmax_aggregate_backward(
            g.contiguous(), *ctx.saved_tensors)
        return dz, da_src, da_dst, None, None, None


def edge_softmax_aggregate(z: torch.Tensor, a_src: torch.Tensor,
                           a_dst: torch.Tensor, nbr_pos: torch.Tensor,
                           nbr_mask: torch.Tensor,
                           num_dst: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """(D, H, C): the attention-weighted sum of each dst row's scored
    slots (the module docstring); ``num_dst`` a 0-d int32 tensor (None:
    every row is live). Differentiable in z, a_src and a_dst."""
    _check(z, a_src, a_dst, nbr_pos, nbr_mask)
    if z.device.type == "cpu":
        return edge_softmax_aggregate_plain(z, a_src, a_dst, nbr_pos,
                                            nbr_mask, num_dst)
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    num_dst = _num_dst_ptr(num_dst, nbr_pos.shape[0], z.device)
    return _EdgeSoftmaxAggregate.apply(z, a_src, a_dst, nbr_pos, nbr_mask,
                                       num_dst)


edge_softmax_aggregate.launches = 0
edge_softmax_aggregate_backward.launches = 0


def edge_softmax_traffic(num_src: float, num_dst: float, fanout: int,
                         heads: int, width: int, itemsize: int) -> dict:
    """Bytes the forward and the backward must move on one block: every
    src row is referenced (each dst row by its self slot, each new row by
    the slot that drew it), so the forward reads each of the ``num_src``
    z rows and its a_src once, each live dst row's positions (4 B) and
    mask (1 B) a slot and its a_dst once, and writes each live dst row's
    output once; the backward reads the output's gradient, z, the scores,
    positions and mask once, and writes each src row's gradient of z and
    of a_src and each dst row's of a_dst once."""
    row, score = heads * width * itemsize, heads * itemsize
    reads = num_src * (row + score) + num_dst * (fanout * 5 + score)
    return {"forward": reads + num_dst * row,
            "backward": (num_dst * row + reads + num_src * (row + score)
                         + num_dst * score)}
