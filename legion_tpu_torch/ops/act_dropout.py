"""The activation and dropout between layers: ``act(h)`` followed by
inverted dropout, as the models run them after every layer but the last.

    out = u < keep ? act(h) / keep : 0,    keep = 1 - rate

``act`` is ``"relu"`` or ``"elu"`` (alpha 1), ``h`` float32 or
bfloat16 of any shape, ``u`` float32 uniforms ``torch.rand`` draws from
the step's generator, of h's shape. The draw stays PyTorch's, so a seed
drops the same elements whichever version runs, and the generator's state
after the call is the same.

It replaces no TPU kernel: ``legion_tpu``'s models leave the activation
and the dropout to XLA, which fuses them. On the card the forward is one
CUDA kernel (``act_dropout_fwd_kernel``) and the backward one
(``act_dropout_bwd_kernel``), bound in a ``torch.autograd.Function``; the
forward keeps one bit an element for the backward (kept, and for ReLU
kept and ``h > 0``) and ELU's backward reads ``h`` too. Both give the bits
of the PyTorch chain they replace (the activation, then ``dropout``'s
comparison, division and ``where``) where ``keep`` is a power of two;
otherwise PyTorch's CUDA division by a Python number multiplies by its
inverse, and the kernels divide, as the CPU does. The design is in
``csrc/legion_kernels.cu``. A CPU tensor takes that plain chain; a CUDA
tensor takes the kernels or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from legion_tpu_torch.ops import _build

ACTIVATIONS = {"relu": F.relu, "elu": F.elu}
_ACT_CODES = {"relu": 1, "elu": 2}


def dropout(h: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with an explicit generator (flax's semantics:
    keep with probability 1 - rate and scale kept values by 1/keep): the
    plain version."""
    keep = 1.0 - rate
    if keep == 0.0:
        return torch.zeros_like(h)
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device))


def _check(h: torch.Tensor, act: str) -> None:
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {tuple(ACTIVATIONS)}, got "
                         f"{act!r}")
    if h.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"act_dropout takes {tuple(_build.DTYPE_CODES)}; "
                         f"got {h.dtype}")


def act_dropout_forward(h: torch.Tensor, u: torch.Tensor, keep: float,
                        act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (out in h's dtype and shape, bits), bits a
    (ceil(n / 8),) uint8 tensor whose bit i % 8 of byte i / 8 is element
    i's (in h's flat order) ``unpack_bits`` reads."""
    _check(h, act)
    if u.shape != h.shape or u.dtype != torch.float32:
        raise ValueError(f"u must be float32 of h's shape {tuple(h.shape)}; "
                         f"got {u.dtype} {tuple(u.shape)}")
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep must lie in (0, 1]; got {keep}")
    _build.require_cuda(h, u)
    n = h.numel()
    out = torch.empty_like(h)
    bits = torch.empty(((n + 7) // 8,), dtype=torch.uint8, device=h.device)
    if n:
        _build.check(_build.load_library().legion_act_dropout_fwd(
            h.data_ptr(), _build.DTYPE_CODES[h.dtype], u.data_ptr(), keep,
            _ACT_CODES[act], out.data_ptr(), bits.data_ptr(), n,
            _build.stream_of(h)), "act_dropout")
        act_dropout.launches += 1
    return out, bits


def act_dropout_backward(g: torch.Tensor, bits: torch.Tensor,
                         h: torch.Tensor, keep: float,
                         act: str) -> torch.Tensor:
    """The backward kernel: dh in g's dtype and shape from the output's
    gradient, the forward's bits and its input h, which only ELU reads
    (ReLU may pass g)."""
    _check(g, act)
    if bits.dtype != torch.uint8 or bits.numel() != (g.numel() + 7) // 8:
        raise ValueError("bits must be the forward's uint8 mask of g's "
                         "elements")
    if h.shape != g.shape or h.dtype != g.dtype:
        raise ValueError("h must have g's shape and dtype")
    _build.require_cuda(g, bits, h)
    dh = torch.empty_like(g)
    if g.numel():
        _build.check(_build.load_library().legion_act_dropout_bwd(
            g.data_ptr(), _build.DTYPE_CODES[g.dtype], bits.data_ptr(),
            h.data_ptr(), keep, _ACT_CODES[act], dh.data_ptr(), g.numel(),
            _build.stream_of(g)), "act_dropout_backward")
        act_dropout_backward.launches += 1
    return dh


class _ActDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, u, keep, act):
        out, bits = act_dropout_forward(h, u, keep, act)
        ctx.keep, ctx.act = keep, act
        # ReLU needs the bits alone; ELU its input too
        ctx.save_for_backward(bits, h if act == "elu" else None)
        return out

    @staticmethod
    def backward(ctx, g):
        bits, h = ctx.saved_tensors
        g = g.contiguous()
        dh = act_dropout_backward(g, bits, g if h is None else h, ctx.keep,
                                  ctx.act)
        return dh, None, None, None


def act_dropout(h: torch.Tensor, act: str, rate: float,
                generator: torch.Generator) -> torch.Tensor:
    """``dropout(ACTIVATIONS[act](h), rate, generator)``, differentiable in
    h: on a CUDA tensor one kernel forward and one backward, drawing the
    same uniforms; at rate 1 all zeros and no draw."""
    _check(h, act)
    if h.device.type == "cpu":
        return dropout(ACTIVATIONS[act](h), rate, generator)
    keep = 1.0 - rate
    if keep == 0.0:
        return torch.zeros_like(h)
    if not h.is_contiguous():
        raise ValueError("act_dropout takes a contiguous tensor on CUDA")
    u = torch.rand(h.shape, generator=generator, device=h.device)
    return _ActDropout.apply(h, u, keep, act)


act_dropout.launches = 0
act_dropout_backward.launches = 0


def unpack_bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool: the forward's bit of each element, in h's flat order."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits[:, None] >> shifts) & 1).bool().reshape(-1)[:n]


def act_dropout_traffic(n: float, itemsize: int, act: str) -> dict:
    """Bytes the kernels must move over n elements: forward h, the f32
    uniforms and out once and a bit an element; backward the gradient,
    the bits and dh once, and h again for ELU."""
    bits = n / 8
    return {"forward": n * (2 * itemsize + 4) + bits,
            "backward": n * (2 + (act == "elu")) * itemsize + bits}
