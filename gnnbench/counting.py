"""The yardstick's arithmetic, frozen here so that the program cannot move
it: the card's published peaks, the least time of a kernel's bytes or
operations, the matrix-product operations of a SAGE step, the bytes the
sampling kernel must move, and the device's busy time in a trace.

Copies of the port's ``tools/bench_kernels.py::bound`` (its peaks),
``tools/sol_model.py::sage_flops``, ``ops/sample.py::sample_traffic``
and ``tools/profile_cached.py::device_busy_ms``, each as it stood when the
benchmark was defined, and held to brute-force counts in
``tests/test_counting.py``.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
# without sparsity, at its 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12


def bound(nbytes, flops):
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory peak, or the operations
    at the float32 peak, whichever is larger."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_F32_FLOP_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(nbytes), "bound_flops": int(flops)}


def sage_flops(batch: int, m_hop1: int, hidden: int, feat_dim: int,
               num_classes: int) -> int:
    """Matrix-product flops of one train step of a 2-layer SAGE. Layer 0
    reduces first and transforms m_hop1 rows twice (fc_neigh on the means,
    fc_self on the prefix); its inputs are features, so its backward is
    the weight gradients alone (2x forward). Layer 1 transforms first
    (``num_classes < hidden``): fc_neigh over the m_hop1 rows, fc_self over
    the batch; its backward has both gradients (3x)."""
    l0 = 2 * m_hop1 * feat_dim * hidden
    l1 = m_hop1 * hidden * num_classes + batch * hidden * num_classes
    return 2 * (2 * l0 + 3 * l1)


def _draws(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    d = deg[:, None]
    return torch.minimum((u * d.to(torch.float32)).to(torch.int32),
                         (d - 1).clamp(min=0))


def sample_traffic(indptr: torch.Tensor, frontier: torch.Tensor,
                   u: torch.Tensor) -> dict:
    """What the sampling kernel must move on these inputs. A slot is valid
    where its node is not padding (id >= 0) and its index is below the
    node's degree.

    * ``valid_slots``;
    * ``useful_bytes``: ``frontier`` read once, ``out`` written once, the
      uniform of each valid slot, one ``indptr`` pair per node that is not
      padding, and one ``indices`` entry per valid slot;
    * ``sector_bytes``: the same reads counted in the 32-byte sectors
      device memory moves."""
    p, f = u.shape
    rows = torch.nonzero(frontier >= 0).flatten()
    ids = frontier[rows].long()
    start = indptr[ids]
    deg = indptr[ids + 1] - start
    ok = torch.arange(f, device=u.device)[None, :] < deg[:, None]
    slot = (rows[:, None] * f + torch.arange(f, device=u.device))[ok]
    addr = (start[:, None].long() + _draws(u[rows], deg).long())[ok]
    valid = int(slot.numel())

    def sectors(i: torch.Tensor) -> int:
        return int(torch.unique(torch.div(i, 8, rounding_mode="floor"))
                   .numel())

    whole = 4 * p + 4 * p * f
    return {"valid_slots": valid,
            "useful_bytes": whole + 8 * ids.numel() + 8 * valid,
            "sector_bytes": whole + 32 * (sectors(torch.cat([ids, ids + 1]))
                                          + sectors(addr) + sectors(slot))}


def device_busy_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Microseconds covered by ``spans`` ((start, end) pairs), each
    overlap once."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def idle_gaps(spans: Iterable[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    gaps, at = [], lo
    for a, b in sorted(spans):
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(a, b) for a, b in gaps if b > a]
