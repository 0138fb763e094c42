"""K3: batched row gather from a device-resident table (port of
``legion_tpu/ops/gather_pallas.py``).

``out[i] = table[ids[i]]``, a zero row where ``ids[i] < 0``; ids at or
beyond the table clamp to its last row, as JAX's gather does. This is the
contract of ``sampling.sampler.gather_features`` and the largest memory
operation of the training step: at the main path, 1,344,640 rows of 128
float32 from a 2,449,029-row table.

The CUDA kernel (``csrc/legion_kernels.cu``, ``gather_rows_kernel``)
moves one 16-byte word per thread, so each warp copies a 512-byte row in
one coalesced load and store; rows that are no multiple of 16 bytes move
in 4-byte words, and on CUDA a row must be a multiple of 4 bytes (any
float32 table). See the source note there. A CPU tensor takes the plain
version; a CUDA tensor takes the kernel or raises.
"""

from __future__ import annotations

import torch

from legion_tpu_torch.ops import _build


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, bit-identical to it."""
    safe = ids.clamp(0, table.shape[0] - 1).long()
    return torch.where((ids >= 0)[:, None], table[safe],
                       torch.zeros((), dtype=table.dtype, device=table.device))


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[i] = table[ids[i]] with zero rows for ids < 0. table: (N, D);
    ids: (M,) int32."""
    if table.dim() != 2 or ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"gather_rows wants a 2-d table and 1-d int32 ids; "
                         f"got {tuple(table.shape)} and {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if table.shape[0] == 0:
        raise ValueError("gather_rows: empty table")
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return gather_rows_plain(table, ids)
    _build.require_cuda(table, ids)
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 4:
        raise ValueError(f"gather_rows on CUDA wants rows of a multiple of 4 "
                         f"bytes; got {row_bytes}")
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    _build.check(lib.legion_gather_rows(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.shape[0],
        table.shape[0], row_bytes, _build.stream_of(table)), "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
