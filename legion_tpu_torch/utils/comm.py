"""Communication accounting (counterpart of ``legion_tpu/utils/comm.py``).

The reference asserts closed forms of each collective's volume against the
collectives in a program's compiled HLO. The port has no HLO: every
collective it makes goes through the wrappers below, which count the
bytes of each call by op kind on this rank. ``reset_counts`` and
``read_counts`` bracket a step (or any span), and the closed forms are
asserted against what was read.

A call's bytes are the bytes of the tensor this rank hands in (for
``all_reduce`` the buffer reduced in place; for ``all_gather_object`` the
pickled object), so a count is the reference's HLO output bytes for the
ops the port uses so far.
"""

from __future__ import annotations

import pickle
from typing import Dict, List

import torch
import torch.distributed as dist

_COUNTS: Dict[str, int] = {}
_CALLS: Dict[str, int] = {}


def _count(op: str, nbytes: int) -> None:
    _COUNTS[op] = _COUNTS.get(op, 0) + int(nbytes)
    _CALLS[op] = _CALLS.get(op, 0) + 1


def reset_counts() -> None:
    _COUNTS.clear()
    _CALLS.clear()


def read_counts() -> Dict[str, int]:
    """Bytes by op kind since the last reset."""
    return dict(_COUNTS)


def read_calls() -> Dict[str, int]:
    """Calls by op kind since the last reset."""
    return dict(_CALLS)


def all_reduce(tensor: torch.Tensor) -> torch.Tensor:
    """In-place sum over every rank (``dist.all_reduce``); returns
    ``tensor``."""
    _count("all_reduce", tensor.numel() * tensor.element_size())
    dist.all_reduce(tensor)
    return tensor


def all_gather_object(obj) -> List:
    """Every rank's ``obj``, in rank order."""
    _count("all_gather_object", len(pickle.dumps(obj)))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# Closed forms (bytes per rank per step)
# ---------------------------------------------------------------------------

def link_bytes(out_bytes: Dict[str, int], k: int) -> int:
    """Approximate per-rank link traffic of ``read_counts()``-style bytes
    on a ring of k ranks: an all-reduce moves ~2 (k-1)/k x its input, any
    other op its bytes once. (The reference's factors for the ops the
    port does not call yet come with the paths that call them.)"""
    return int(sum(v * (2 * (k - 1) / k if op == "all_reduce" else 1.0)
                   for op, v in out_bytes.items()))


def grad_allreduce_bytes(param_count: int, itemsize: int = 4) -> int:
    """The DP gradient all-reduce (DDP's): 2 x param bytes on a ring."""
    return 2 * param_count * itemsize


def param_bytes(module: torch.nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())
