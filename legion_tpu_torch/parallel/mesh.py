"""Rank layout and process start-up (counterpart of
``legion_tpu/parallel/mesh.py``).

The reference lays its chips out as a ``jax.sharding.Mesh`` with axes
``data`` (data parallelism, the reference's per-GPU runners and DDP) and
``cache`` (a cache group: chips that jointly hold one striped copy of the
hot cache). Here a rank is one process with one device, over
``torch.distributed``: the world is data x cache ranks, and a cache group
is ``group_size`` consecutive ranks (rank r sits at data r // group_size,
cache r % group_size, as the reference's row-major mesh does). No path
of the port uses a cache group yet (ROADMAP queue 1 items 4 and 5), so
no ``dist`` group of the cache axis is made.

``spawn`` starts the ranks with ``torch.multiprocessing.spawn``; each
joins the group through a file (``init_method="file://..."``), so runs in
parallel never contend for a port. NCCL carries a CUDA run and gloo a CPU
run, and only the CPU asks for gloo: a CUDA run never falls back to it.
Rank r takes ``cuda:r``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data x cache) grid."""

    data: int
    cache: int
    rank: int

    @property
    def world(self) -> int:
        return self.data * self.cache

    @property
    def shape(self) -> dict:
        return {"data": self.data, "cache": self.cache}


def make_mesh(cache_group_size: int = 1) -> Mesh:
    """The layout of the initialized process group."""
    world = dist.get_world_size()
    if world % cache_group_size:
        raise ValueError(f"{world} ranks not divisible by cache group "
                         f"{cache_group_size}")
    return Mesh(data=world // cache_group_size, cache=cache_group_size,
                rank=dist.get_rank())


def backend_for(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"device type must be 'cuda' or 'cpu', got "
                     f"{device_type!r}")


def check_world(world: int, device_type: str) -> None:
    """A CUDA world needs one card per rank."""
    if world < 1:
        raise ValueError(f"world size must be >= 1, got {world}")
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if world > have:
            raise ValueError(f"{world} ranks need {world} CUDA devices; "
                             f"this process sees {have}")


def init_process(rank: int, world: int, init_file: str,
                 device_type: str) -> torch.device:
    """Join the process group as ``rank`` of ``world`` and return the
    rank's device (``cuda:rank``, or the CPU)."""
    check_world(world, device_type)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend_for(device_type),
                            init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    return device


def _entry(rank: int, fn: Callable, world: int, init_file: str,
           device_type: str, threads: Optional[int], args: Sequence):
    if threads:
        torch.set_num_threads(threads)
    device = init_process(rank, world, init_file, device_type)
    try:
        fn(device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device_type: str, args: Sequence = (),
          threads: Optional[int] = None) -> None:
    """Run ``fn(device, *args)`` on ``world`` new ranks and wait for all of
    them; a rank that raises makes this raise. ``fn`` and ``args`` are
    pickled to the ranks, so pass small things (a config's JSON, a
    loader and its arguments), never a graph."""
    check_world(world, device_type)
    tmp = tempfile.mkdtemp(prefix="legion_dist_")
    try:
        torch.multiprocessing.spawn(
            _entry, args=(fn, world, os.path.join(tmp, "init"), device_type,
                          threads, tuple(args)),
            nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
