"""K1 and K2: masked norm-reduce aggregation over a block's fanout slots
(port of ``legion_tpu/ops/identity_agg_pallas.py``), and the gathered
feature mean.

* K1 ``identity_masked_mean``: identity-layout blocks (the last hop is
  identity-appended), where the f slots of dst ``d`` are the contiguous
  rows ``x[off + d*f : off + (d+1)*f]``. Raw features carry no gradient,
  so K1 has no backward, as on the TPU.
* K2 ``gathered_masked_mean``: the slots of dst ``d`` are the rows
  ``h_t[nbr_pos[d, j]]`` of transformed activations, which do carry
  gradient. Forward and backward are CUDA kernels bound in one
  ``torch.autograd.Function``; the backward scatter-adds
  ``m[d, j] * scale[d]`` into ``d_h_t[nbr_pos[d, j]]``.
* ``gathered_feature_mean``: K2's forward with norm "mean" over raw
  feature rows, emitted in a type of its own and with no backward, for a
  gathered block whose layer widens (SAGE's layer 0 on a deduplicated
  outer block aggregates before it transforms). The reference leaves this
  case to XLA; its kernel replaces no TPU kernel.

norm: "mean" (SAGE), "sqrt" (sum / sqrt(in-degree), GCN) or "sum"; a
dst with no valid slot gives a zero row. K2 gathers with the fill
semantics of JAX's ``jnp.take``: a valid slot whose position is past
h_t's rows (after a cap overflow) makes its dst row NaN, and the
backward drops it. The kernels live in
``csrc/legion_kernels.cu`` (K1 ``masked_agg_kernel``; K2
``gathered_agg_kernel``, ``scatter_rows_kernel`` and
``narrow_rows_kernel``, one warp per dst row; ``feature_mean_kernel``),
with their source notes.
A CPU tensor takes the plain PyTorch version beside each kernel; a CUDA
tensor takes the kernel or raises.
"""

from __future__ import annotations

import torch

from legion_tpu_torch.ops import _build

_DTYPES = tuple(_build.DTYPE_CODES)


def _check_args(x, nbr_mask, norm, *dtypes):
    if norm not in _build.NORM_CODES:
        raise ValueError(f"norm must be one of {tuple(_build.NORM_CODES)}, "
                         f"got {norm!r}")
    if x.dim() != 2 or nbr_mask.dim() != 2 or nbr_mask.dtype != torch.bool:
        raise ValueError("want 2-d rows and a 2-d bool nbr_mask")
    for dt in (x.dtype, *dtypes):
        if dt not in _DTYPES:
            raise ValueError(f"dtype {dt} not in {_DTYPES}")


def _normalize(s: torch.Tensor, nbr_mask: torch.Tensor,
               norm: str) -> torch.Tensor:
    """Apply the norm to f32 per-dst sums (plain versions)."""
    if norm == "sum":
        return s
    denom = nbr_mask.sum(1, keepdim=True, dtype=torch.float32).clamp(min=1.0)
    return s / denom if norm == "mean" else s * torch.rsqrt(denom)


def in_rows(pos: torch.Tensor, n: int) -> torch.Tensor:
    """Which positions address one of n rows. A position past the
    frontier exists only after a cap overflow, which the train step
    reports."""
    return (pos >= 0) & (pos < n)


def take_rows(h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``h[pos]`` with the fill semantics of JAX's ``jnp.take``: a
    position outside h's rows gives a NaN row, and in the backward its
    gradient is dropped (the ``torch.where`` routes none to the clamped
    row)."""
    ok = in_rows(pos, h.shape[0])
    rows = h[pos.clamp(0, h.shape[0] - 1).long()]
    return torch.where(ok[..., None], rows,
                       torch.full((), float("nan"), dtype=h.dtype,
                                  device=h.device))


def _masked_reduce_plain(rows: torch.Tensor, nbr_mask: torch.Tensor,
                         norm: str) -> torch.Tensor:
    """(P, f, D) rows -> (P, D) f32 masked norm-reduce."""
    s = (rows.float() * nbr_mask[..., None]).sum(1)
    return _normalize(s, nbr_mask, norm)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def identity_masked_mean_plain(x, nbr_mask, identity_offset, norm="mean",
                               out_dtype=torch.bfloat16):
    p, f = nbr_mask.shape
    rows = x[identity_offset: identity_offset + p * f].reshape(p, f, -1)
    return _masked_reduce_plain(rows, nbr_mask, norm).to(out_dtype)


def identity_masked_mean(x: torch.Tensor, nbr_mask: torch.Tensor,
                         identity_offset: int, norm: str = "mean",
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """out[d] = norm-reduce over valid slots j of
    x[identity_offset + d*f + j]; x: (F, D) f32 or bf16, nbr_mask: (P, f)
    bool; out: (P, D) in out_dtype, summed in f32."""
    _check_args(x, nbr_mask, norm, out_dtype)
    p, f = nbr_mask.shape
    if x.shape[0] < identity_offset + p * f:
        raise ValueError(f"x has {x.shape[0]} rows < offset {identity_offset}"
                         f" + {p}*{f}")
    if x.device.type == "cpu" and nbr_mask.device.type == "cpu":
        return identity_masked_mean_plain(x, nbr_mask, identity_offset, norm,
                                          out_dtype)
    _build.require_cuda(x, nbr_mask)
    if x.requires_grad:
        raise ValueError("identity_masked_mean has no backward: its input "
                         "is raw features")
    out = torch.empty((p, x.shape[1]), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    _build.check(lib.legion_identity_masked_mean(
        x.data_ptr(), _build.DTYPE_CODES[x.dtype],
        nbr_mask.view(torch.uint8).data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[out_dtype], x.shape[0], p, f, x.shape[1],
        identity_offset,
        _build.NORM_CODES[norm], _build.stream_of(x)), "identity_masked_mean")
    identity_masked_mean.launches += 1
    return out


identity_masked_mean.launches = 0


# ---------------------------------------------------------------------------
# The gathered feature mean
# ---------------------------------------------------------------------------

def gathered_feature_mean_plain(x, nbr_pos, nbr_mask,
                                out_dtype=torch.bfloat16):
    """K2's plain arithmetic on raw rows: the f32 sum over the valid
    slots, one divide, one rounding to out_dtype."""
    rows = take_rows(x, nbr_pos)                          # (P, f, D)
    return _masked_reduce_plain(rows, nbr_mask, "mean").to(out_dtype)


def gathered_feature_mean(x: torch.Tensor, nbr_pos: torch.Tensor,
                          nbr_mask: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """out[d] = mean over valid slots j of x[nbr_pos[d, j]]; x: (S, D) f32
    or bf16 raw features, nbr_pos: (P, f) int32, nbr_mask: (P, f) bool;
    out: (P, D) in out_dtype, summed in f32 and rounded once. A dst with no
    valid slot gives a zero row, a valid slot past x's rows a NaN row."""
    _check_args(x, nbr_mask, "mean", out_dtype)
    if nbr_pos.shape != nbr_mask.shape or nbr_pos.dtype != torch.int32:
        raise ValueError("nbr_pos must be int32 with nbr_mask's shape")
    if x.device.type == "cpu":
        return gathered_feature_mean_plain(x, nbr_pos, nbr_mask, out_dtype)
    _build.require_cuda(x, nbr_pos, nbr_mask)
    if x.requires_grad:
        raise ValueError("gathered_feature_mean has no backward: its input "
                         "is raw features")
    p, f = nbr_mask.shape
    out = torch.empty((p, x.shape[1]), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    _build.check(lib.legion_gathered_feature_mean(
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], nbr_pos.data_ptr(),
        nbr_mask.view(torch.uint8).data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[out_dtype], x.shape[0], p, f, x.shape[1],
        _build.stream_of(x)), "gathered_feature_mean")
    gathered_feature_mean.launches += 1
    return out


gathered_feature_mean.launches = 0


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def gathered_masked_mean_plain(h_t, nbr_pos, nbr_mask, norm="mean"):
    """Plain version; differentiable in h_t through PyTorch's autograd.
    A valid slot past h_t's rows makes its row NaN (``take_rows``)."""
    rows = take_rows(h_t, nbr_pos)                        # (P, f, D)
    return _masked_reduce_plain(rows, nbr_mask, norm).to(h_t.dtype)


def gathered_masked_mean_backward_plain(g, nbr_pos, nbr_mask, num_src,
                                        norm="mean", out_dtype=None):
    """d_h_t of the masked norm-reduce: d_h_t[nbr_pos[d, j]] +=
    m[d, j] * scale[d], summed in f32 and cast to out_dtype. A slot past
    num_src is dropped; it still counts in the mean's denominator."""
    scale = _normalize(g.float(), nbr_mask, norm)                  # (P, D)
    keep = nbr_mask & in_rows(nbr_pos, num_src)
    contrib = scale[:, None, :] * keep[..., None]                  # (P, f, D)
    d = torch.zeros((num_src, g.shape[1]), dtype=torch.float32,
                    device=g.device)
    d.index_add_(0, nbr_pos.clamp(0, num_src - 1).long().reshape(-1),
                 contrib.reshape(-1, g.shape[1]))
    return d.to(out_dtype or g.dtype)


def staging_width(d: int, out_dtype: torch.dtype) -> int:
    """Row stride, in floats, of K2 backward's f32 staging buffer. A
    float32 result is scattered straight into its own rows (stride d,
    with the widest atomics d allows, and no cast pass). For any other
    type d is rounded up to a multiple of 4, so that every row starts
    16-byte aligned and takes the kernel's 16-byte vector atomics; the
    cast pass drops the padding."""
    return d if out_dtype == torch.float32 else -(-d // 4) * 4


def scatter_masked_rows(g: torch.Tensor, nbr_pos: torch.Tensor,
                        nbr_mask: torch.Tensor, staging: torch.Tensor,
                        norm: str = "mean") -> None:
    """K2 backward's scatter kernel: adds ``m[d, j] * scale[d]`` into row
    ``nbr_pos[d, j]`` of ``staging``, a (num_src, ld >= D) f32 buffer that
    the caller has zeroed; its columns from D on are padding and receive
    nothing. 16-byte atomics where ld is a multiple of 4 floats and the
    buffer 16-byte aligned, else 8-byte or scalar ones."""
    _build.require_cuda(g, nbr_pos, nbr_mask, staging)
    if (staging.dtype != torch.float32 or staging.dim() != 2
            or staging.shape[1] < g.shape[1]):
        raise ValueError("staging must be (num_src, >= D) float32")
    p, f = nbr_mask.shape
    if g.numel() == 0 or staging.numel() == 0:
        return
    lib = _build.load_library()
    _build.check(lib.legion_gathered_masked_mean_bwd(
        g.data_ptr(), _build.DTYPE_CODES[g.dtype], nbr_pos.data_ptr(),
        nbr_mask.view(torch.uint8).data_ptr(), staging.data_ptr(),
        staging.shape[0], p, f, g.shape[1], staging.shape[1],
        _build.NORM_CODES[norm], _build.stream_of(g)),
        "gathered_masked_mean_backward")
    gathered_masked_mean_backward.launches += 1


def narrow_rows(staging: torch.Tensor, d: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """The first d columns of the (num_src, ld) f32 staging buffer as a
    contiguous (num_src, d) tensor in out_dtype: one kernel pass for the
    cast and the un-padding. A float32 result at ld == d is the buffer
    itself."""
    if out_dtype == torch.float32 and staging.shape[1] == d:
        return staging
    _build.require_cuda(staging)
    out = torch.empty((staging.shape[0], d), dtype=out_dtype,
                      device=staging.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    _build.check(lib.legion_narrow_rows(
        staging.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[out_dtype],
        staging.shape[0], d, staging.shape[1], _build.stream_of(staging)),
        "narrow_rows")
    return out


def gathered_masked_mean_backward(g: torch.Tensor, nbr_pos: torch.Tensor,
                                  nbr_mask: torch.Tensor, num_src: int,
                                  norm: str = "mean",
                                  out_dtype: torch.dtype | None = None
                                  ) -> torch.Tensor:
    """K2 backward: (P, D) upstream gradient -> (num_src, D) gradient of
    h_t in out_dtype (default g's). On the card it is three passes: the
    zero fill of an f32 staging buffer with padded rows
    (``staging_width``), the scatter kernel's vector atomics into it
    (``scatter_masked_rows``), and one kernel that casts and un-pads
    (``narrow_rows``); a float32 result is the staging buffer itself, at
    the true width, and takes no third pass."""
    out_dtype = out_dtype or g.dtype
    _check_args(g, nbr_mask, norm, out_dtype)
    if nbr_pos.shape != nbr_mask.shape or nbr_pos.dtype != torch.int32:
        raise ValueError("nbr_pos must be int32 with nbr_mask's shape")
    if g.device.type == "cpu":
        return gathered_masked_mean_backward_plain(g, nbr_pos, nbr_mask,
                                                   num_src, norm, out_dtype)
    d = g.shape[1]
    staging = torch.zeros((num_src, staging_width(d, out_dtype)),
                          dtype=torch.float32, device=g.device)
    scatter_masked_rows(g, nbr_pos, nbr_mask, staging, norm)
    return narrow_rows(staging, d, out_dtype)


gathered_masked_mean_backward.launches = 0


def _gathered_forward_cuda(h_t, nbr_pos, nbr_mask, norm):
    _build.require_cuda(nbr_pos, nbr_mask)
    p, f = nbr_mask.shape
    d = h_t.shape[1]
    # rows may lie apart (a column slice of a wider buffer); within a row
    # the elements follow each other
    if (h_t.device != nbr_pos.device or (d > 1 and h_t.stride(1) != 1)
            or (h_t.shape[0] > 1 and h_t.stride(0) < d)):
        raise ValueError("h_t must lie on nbr_pos's device with unit column "
                         "stride and a row stride >= its width; got strides "
                         f"{h_t.stride()} on {h_t.device}")
    out = torch.empty((p, d), dtype=h_t.dtype, device=h_t.device)
    if out.numel() == 0:
        return out
    ld = h_t.stride(0) if h_t.shape[0] > 1 else d
    lib = _build.load_library()
    _build.check(lib.legion_gathered_masked_mean(
        h_t.data_ptr(), _build.DTYPE_CODES[h_t.dtype], nbr_pos.data_ptr(),
        nbr_mask.view(torch.uint8).data_ptr(), out.data_ptr(), h_t.shape[0],
        p, f, d, ld, _build.NORM_CODES[norm], _build.stream_of(h_t)),
        "gathered_masked_mean")
    gathered_masked_mean.launches += 1
    return out


class _GatheredMaskedMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_t, nbr_pos, nbr_mask, norm):
        ctx.save_for_backward(nbr_pos, nbr_mask)
        ctx.norm = norm
        ctx.num_src = h_t.shape[0]
        ctx.dtype = h_t.dtype
        return _gathered_forward_cuda(h_t, nbr_pos, nbr_mask, norm)

    @staticmethod
    def backward(ctx, g):
        nbr_pos, nbr_mask = ctx.saved_tensors
        d = gathered_masked_mean_backward(g.contiguous(), nbr_pos, nbr_mask,
                                          ctx.num_src, ctx.norm, ctx.dtype)
        return d, None, None, None


def gathered_masked_mean(h_t: torch.Tensor, nbr_pos: torch.Tensor,
                         nbr_mask: torch.Tensor,
                         norm: str = "mean") -> torch.Tensor:
    """out[d] = norm-reduce over valid slots j of h_t[nbr_pos[d, j]];
    h_t: (S, D) f32 or bf16 at its true width D (on the card its rows may
    lie apart: a column slice of a wider buffer); nbr_pos: (P, f) int32;
    nbr_mask: (P, f) bool. out: (P, D) in h_t's dtype, summed in f32.
    Differentiable in h_t."""
    _check_args(h_t, nbr_mask, norm)
    if nbr_pos.shape != nbr_mask.shape or nbr_pos.dtype != torch.int32:
        raise ValueError("nbr_pos must be int32 with nbr_mask's shape")
    if h_t.device.type == "cpu":
        return gathered_masked_mean_plain(h_t, nbr_pos, nbr_mask, norm)
    return _GatheredMaskedMean.apply(h_t, nbr_pos, nbr_mask, norm)


gathered_masked_mean.launches = 0
