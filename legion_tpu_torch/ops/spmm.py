"""K5: grouped masked row-sum, the SpMM of identity-layout blocks (port of
``legion_tpu/ops/spmm_pallas.py``).

With the last hop identity-appended, the outermost layer's aggregation is
a sum over fixed groups of ``f`` consecutive src rows:
``out[g] = sum_{j<f} x2[g*f + j] * mask[g, j]``. The mask is bool or
holds float weights, which are cast to x2's dtype and multiplied, as the
reference does. The CUDA kernel (``grouped_masked_sum_kernel`` in
``csrc/legion_kernels.cu``, with its source notes) takes any P, f and D
in f32 or bf16, sums in f32 and casts once; bf16 therefore rounds once
where the reference's XLA formulation sums in bf16. A CPU tensor takes the
plain PyTorch version; a CUDA tensor takes the kernel or raises.

Backward: ``dx = repeat(dy, f) * mask``, a plain expression as in the
reference (whose VJP stays in XLA); the mask gets no gradient. The float32
GCN's layer 0 reaches this through ``ops.segment.fanout_gather_sum`` on
raw features, which carry no gradient.
"""

from __future__ import annotations

import torch

from legion_tpu_torch.ops import _build


def _weights(x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The (P, f) mask as the kernel reads it: bool as it is, float
    weights in x2's dtype."""
    return mask if mask.dtype == torch.bool else mask.detach().to(x2.dtype)


def grouped_masked_sum_plain(x2: torch.Tensor, mask: torch.Tensor,
                             f: int) -> torch.Tensor:
    """Plain version; differentiable in x2 through PyTorch's autograd."""
    p = x2.shape[0] // f
    w = _weights(x2, mask).float()
    return (x2.float().reshape(p, f, -1) * w[..., None]).sum(1).to(x2.dtype)


class _GroupedMaskedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, f):
        ctx.save_for_backward(w)
        ctx.f = f
        p, d = w.shape[0], x2.shape[1]
        out = torch.empty((p, d), dtype=x2.dtype, device=x2.device)
        if out.numel() == 0:
            return out
        lib = _build.load_library()
        wk = w.view(torch.uint8) if w.dtype == torch.bool else w
        _build.check(lib.legion_grouped_masked_sum(
            x2.data_ptr(), _build.DTYPE_CODES[x2.dtype], wk.data_ptr(),
            int(w.dtype != torch.bool), out.data_ptr(), p, f, d,
            _build.stream_of(x2)), "grouped_masked_sum")
        grouped_masked_sum.launches += 1
        return out

    @staticmethod
    def backward(ctx, dy):
        (w,) = ctx.saved_tensors
        dx = dy.repeat_interleave(ctx.f, 0) * w.to(dy.dtype).reshape(-1, 1)
        return dx, None, None


def grouped_masked_sum(x2: torch.Tensor, mask: torch.Tensor,
                       f: int) -> torch.Tensor:
    """out[g] = sum_{j<f} x2[g*f + j] * mask[g, j]; x2: (P*f, D) f32 or
    bf16, mask: (P, f) bool or float; out: (P, D) in x2's dtype, summed
    in f32. Differentiable in x2."""
    if x2.dim() != 2 or mask.dim() != 2 or mask.shape[1] != f:
        raise ValueError(f"want (P*f, D) rows and a (P, f={f}) mask, got "
                         f"{tuple(x2.shape)} and {tuple(mask.shape)}")
    if x2.shape[0] != mask.shape[0] * f:
        raise ValueError(f"x2 has {x2.shape[0]} rows, the mask covers "
                         f"{mask.shape[0]} x {f}")
    if x2.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"dtype {x2.dtype} not in "
                         f"{tuple(_build.DTYPE_CODES)}")
    if mask.dtype != torch.bool and not mask.is_floating_point():
        raise ValueError(f"mask must be bool or float, got {mask.dtype}")
    if x2.device.type == "cpu" and mask.device.type == "cpu":
        return grouped_masked_sum_plain(x2, mask, f)
    w = _weights(x2, mask)
    _build.require_cuda(x2, w)
    return _GroupedMaskedSum.apply(x2, w, f)


grouped_masked_sum.launches = 0
