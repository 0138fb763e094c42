"""Process start-up of the edge-partitioned path and each rank's loading of
its own shard (port of ``legion_tpu/parallel/launch.py``).

One process per device. On several machines torchrun starts them, e.g.
two hosts of four cards:

    torchrun --nnodes 2 --nproc-per-node 4 --node-rank $NODE \\
        --master-addr host0 --master-port 29500 \\
        -m legion_tpu_torch.train --partitioned --devices 8 ...

and gives each process ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``, which take the place of the
reference's ``LEGION_COORDINATOR`` / ``LEGION_NUM_PROCESSES`` /
``LEGION_PROCESS_ID``. ``maybe_initialize_distributed`` joins the group
they describe (``init_method="env://"``; a failure raises) and takes
``cuda:LOCAL_RANK``. Without them ``run_ranks`` starts the ranks itself
(``parallel.mesh.spawn``), or at world size 1 joins a one-rank group in
this process.

Each rank builds only its own part (``put_shard_distributed``): the padded
shapes come from the partition vector alone (``HostShard.part_shapes``),
so no rank reads another part's adjacency or feature rows.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from legion_tpu_torch.parallel import mesh
from legion_tpu_torch.parallel.halo import HostShard
from legion_tpu_torch.utils import comm

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def torchrun_env() -> Optional[Dict[str, str]]:
    """torchrun's variables when this process is one of its ranks, None
    when none is set; a partial set raises."""
    have = {v: os.environ[v] for v in TORCHRUN_VARS if v in os.environ}
    if not have:
        return None
    missing = [v for v in TORCHRUN_VARS if v not in have]
    if missing:
        raise ValueError(f"torchrun's variables are partly set: {missing} "
                         "missing")
    return have


def maybe_initialize_distributed(device_type: str
                                 ) -> Optional[torch.device]:
    """Join the process group that torchrun's variables describe and
    return this rank's device (``cuda:LOCAL_RANK`` or the CPU); None, and
    nothing done, without them."""
    env = torchrun_env()
    if env is None:
        return None
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env["LOCAL_RANK"])
    backend = mesh.backend_for(device_type)
    if device_type == "cuda":
        if local >= torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK {local} but this process sees "
                             f"{torch.cuda.device_count()} CUDA devices")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    comm.stage_through_host(False)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    return device


def run_ranks(fn: Callable, world: int, device_type: str,
              args: Sequence = (), threads: Optional[int] = None,
              share_device: bool = False) -> None:
    """Run ``fn(device, *args)`` on every rank: in this process when
    torchrun started it (the group its variables describe), else on
    ``world`` ranks that ``parallel.mesh.spawn`` starts, or at world size
    1 in this process through a one-rank group."""
    device = maybe_initialize_distributed(device_type)
    if device is None and (world > 1 or share_device):
        mesh.spawn(fn, world, device_type, args, threads=threads,
                   share_device=share_device)
        return
    with tempfile.TemporaryDirectory(prefix="legion_dist_") as tmp:
        if device is None:
            device = mesh.init_process(0, 1, os.path.join(tmp, "init"),
                                       device_type)
        try:
            fn(device, *args)
        finally:
            dist.destroy_process_group()


def put_shard_distributed(indptr, indices, features, partition: np.ndarray,
                          k: int, rank: int,
                          device: torch.device | str) -> HostShard:
    """Rank ``rank``'s part of the k-way partitioned graph on ``device``,
    padded to the largest part's shape, built from that part alone."""
    rows, edges = HostShard.part_shapes(indptr, partition, k)
    max_c, max_e = int(rows.max()), max(int(edges.max()), 1)
    return HostShard.to_device(
        HostShard.build_one(indptr, indices, features, partition, rank,
                            max_c, max_e), device)
