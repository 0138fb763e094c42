"""Neighbor sampling of one hop (the port's counterpart of K4,
``legion_tpu/ops/select_pallas.py:46``, with the sampler code around it).

``out[p, f]`` is a uniform-with-replacement draw from the CSR run of
``frontier[p]``: ``indices[indptr[id] + min(int(u[p, f] * deg), deg-1)]``,
and ``-1`` where the node is padding (``id < 0``), has no neighbor, or
``f >= deg``. These are the semantics of the reference's
``sample_neighbors_per_edge`` (``legion_tpu/sampling/sampler.py:258``),
which every JAX layout reproduces bit for bit, so the same uniforms give
the same neighbors.

The CUDA kernel (``csrc/legion_kernels.cu``, ``sample_neighbors_kernel``)
runs one warp per tile of 32 frontier rows (per slice of a tile's rounds
when the tiles are too few to fill the card) and computes the draw with
the plain version's float32 rounding; see the source note there. A CPU tensor
takes the plain version; a CUDA tensor takes the kernel or raises.
``sample_traffic`` counts the bytes the kernel's work needs on given
inputs, for its bound.
"""

from __future__ import annotations

import torch

from legion_tpu_torch.ops import _build


def _draws(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Draw offsets in [0, deg) per (node, slot), in float32 as the
    reference computes them: min(int(u * deg), max(deg - 1, 0))."""
    d = deg[:, None]
    return torch.minimum((u * d.to(torch.float32)).to(torch.int32),
                         (d - 1).clamp(min=0))


def sample_neighbors_plain(indptr: torch.Tensor, indices: torch.Tensor,
                           frontier: torch.Tensor,
                           u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, bit-identical to it."""
    fanout = u.shape[1]
    valid = frontier >= 0
    ids = torch.where(valid, frontier, 0).long()
    start = indptr[ids]
    deg = indptr[ids + 1] - start
    addr = (start[:, None] + _draws(u, deg)).clamp(0, indices.shape[0] - 1)
    nbr = indices[addr.long()]
    slot = torch.arange(fanout, dtype=torch.int32, device=frontier.device)
    d = deg[:, None]
    ok = valid[:, None] & (slot[None, :] < d) & (d > 0)
    return torch.where(ok, nbr, -1)


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
      device memory moves: the distinct sectors of the ``indptr`` pairs, of
      the drawn ``indices`` entries and of the valid slots' uniforms,
      beside ``frontier`` and ``out``, which are whole and contiguous.
      Sectors are counted from each array's start (tensors start aligned).
    """
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

    whole = 4 * p + 4 * p * f                      # frontier and out
    return {"valid_slots": valid,
            "useful_bytes": whole + 8 * ids.numel() + 8 * valid,
            "sector_bytes": whole + 32 * (sectors(torch.cat([ids, ids + 1]))
                                          + sectors(addr) + sectors(slot))}


def sample_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                     frontier: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(P, fanout) int32 sampled neighbor ids, -1 where invalid.
    indptr (N+1,), indices (E,) and frontier (P,) int32; u (P, fanout)
    float32 uniforms in [0, 1)."""
    if any(t.dtype != torch.int32 for t in (indptr, indices, frontier)):
        raise ValueError("sample_neighbors wants int32 indptr, indices and "
                         f"frontier; got {indptr.dtype}, {indices.dtype}, "
                         f"{frontier.dtype}")
    if (u.dtype != torch.float32 or u.dim() != 2 or frontier.dim() != 1
            or u.shape[0] != frontier.shape[0]):
        raise ValueError(f"sample_neighbors wants float32 u of shape (P, f) "
                         f"for a (P,) frontier; got {u.dtype} "
                         f"{tuple(u.shape)} and {tuple(frontier.shape)}")
    if indices.shape[0] == 0:
        raise ValueError("sample_neighbors: empty indices")
    if all(t.device.type == "cpu" for t in (indptr, indices, frontier, u)):
        return sample_neighbors_plain(indptr, indices, frontier, u)
    _build.require_cuda(indptr, indices, frontier, u)
    out = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    _build.check(lib.legion_sample_neighbors(
        indptr.data_ptr(), indices.data_ptr(), frontier.data_ptr(),
        u.data_ptr(), out.data_ptr(), u.shape[0], u.shape[1],
        _build.stream_of(u)), "sample_neighbors")
    sample_neighbors.launches += 1
    return out


sample_neighbors.launches = 0
