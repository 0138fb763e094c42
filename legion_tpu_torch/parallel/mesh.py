"""Rank layout and process start-up (counterpart of
``legion_tpu/parallel/mesh.py``).

The reference lays its chips out as a ``jax.sharding.Mesh`` with axes
``data`` (data parallelism, the reference's per-GPU runners and DDP) and
``cache`` (a cache group: chips that jointly hold one striped copy of the
hot cache). Here a rank is one process with one device, over
``torch.distributed``: the world is data x cache ranks, and a cache group
is ``group_size`` consecutive ranks (rank r sits at data r // group_size,
cache r % group_size, as the reference's row-major mesh does).
``make_mesh`` builds every cache group's ``dist.new_group`` in every rank
(``new_group`` must be called by all ranks, in the same order) and keeps
this rank's: the row exchanges of ``parallel.feature_exchange`` run over
it, on a group of one rank too.

``spawn`` starts the ranks with ``torch.multiprocessing.spawn``; each
joins the group through a file (``init_method="file://..."``), so runs in
parallel never contend for a port. NCCL carries a CUDA run and gloo a CPU
run, and only the CPU asks for gloo: a CUDA run never falls back to it.
Rank r takes ``cuda:r``.

One mode exists for a machine with fewer cards than ranks, and only when
asked for by name (``share_device=True``): every rank takes ``cuda:0``,
the group runs gloo, and ``utils.comm`` stages each collective's CUDA
tensors through host memory. It shows behaviour across ranks, not speed;
NCCL is never used in it.

``captures_steps`` says whether a rank's steps, collectives and all, are
captured as CUDA graphs (``train/graphed.py``): on a NCCL group only.
Gloo cannot be captured, so CPU ranks and the share-device mode run the
same steps eagerly.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from legion_tpu_torch.utils import comm


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data x cache) grid, and its cache
    group's ``dist`` group (None only on a hand-built Mesh)."""

    data: int
    cache: int
    rank: int
    group: Optional[object] = dataclasses.field(default=None, compare=False,
                                                repr=False)

    @property
    def world(self) -> int:
        return self.data * self.cache

    @property
    def shape(self) -> dict:
        return {"data": self.data, "cache": self.cache}

    @property
    def data_rank(self) -> int:
        """This rank's index on the data axis (its cache group's)."""
        return self.rank // self.cache

    @property
    def cache_rank(self) -> int:
        """This rank's index within its cache group."""
        return self.rank % self.cache


def make_mesh(cache_group_size: int = 1) -> Mesh:
    """The layout of the initialized process group, with every cache
    group made (ranks [d*K, (d+1)*K) for each data index d)."""
    world = dist.get_world_size()
    k = cache_group_size
    if k < 1 or world % k:
        raise ValueError(f"{world} ranks not divisible by cache group {k}")
    rank = dist.get_rank()
    mine = None
    for d in range(world // k):
        g = dist.new_group(list(range(d * k, (d + 1) * k)))
        if d == rank // k:
            mine = g
    return Mesh(data=world // k, cache=k, rank=rank, group=mine)


def backend_for(device_type: str, share_device: bool = False) -> str:
    if device_type == "cuda":
        return "gloo" if share_device else "nccl"
    if device_type == "cpu":
        if share_device:
            raise ValueError("share_device is a mode of CUDA ranks")
        return "gloo"
    raise ValueError(f"device type must be 'cuda' or 'cpu', got "
                     f"{device_type!r}")


def captures_steps(device: torch.device | str) -> bool:
    """Whether this rank captures its steps: its device is a CUDA device
    and its process group runs NCCL (the share-device mode runs gloo)."""
    return (torch.device(device).type == "cuda"
            and dist.get_backend() == "nccl")


def check_world(world: int, device_type: str,
                share_device: bool = False) -> None:
    """A CUDA world needs one card per rank, unless the ranks were asked
    to share one card (``share_device``)."""
    if world < 1:
        raise ValueError(f"world size must be >= 1, got {world}")
    if device_type == "cuda":
        have = torch.cuda.device_count()
        need = 1 if share_device else world
        if need > have:
            raise ValueError(f"{world} ranks need {need} CUDA devices; "
                             f"this process sees {have}")


def init_process(rank: int, world: int, init_file: str,
                 device_type: str, share_device: bool = False
                 ) -> torch.device:
    """Join the process group as ``rank`` of ``world`` and return the
    rank's device (``cuda:rank``, ``cuda:0`` for every rank with
    ``share_device``, or the CPU)."""
    check_world(world, device_type, share_device)
    backend = backend_for(device_type, share_device)
    if device_type == "cuda":
        device = torch.device("cuda", 0 if share_device else rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    comm.stage_through_host(share_device)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    return device


def _entry(rank: int, fn: Callable, world: int, init_file: str,
           device_type: str, threads: Optional[int], args: Sequence,
           share_device: bool):
    if threads:
        torch.set_num_threads(threads)
    device = init_process(rank, world, init_file, device_type, share_device)
    try:
        fn(device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device_type: str, args: Sequence = (),
          threads: Optional[int] = None, share_device: bool = False) -> None:
    """Run ``fn(device, *args)`` on ``world`` new ranks and wait for all of
    them; a rank that raises makes this raise. ``fn`` and ``args`` are
    pickled to the ranks, so pass small things (a config's JSON, a
    loader and its arguments), never a graph. ``share_device=True``
    (CUDA only) puts every rank on ``cuda:0`` over gloo: see the module
    note."""
    check_world(world, device_type, share_device)
    backend_for(device_type, share_device)
    tmp = tempfile.mkdtemp(prefix="legion_dist_")
    try:
        torch.multiprocessing.spawn(
            _entry, args=(fn, world, os.path.join(tmp, "init"), device_type,
                          threads, tuple(args), share_device),
            nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
