"""The data-parallel step (counterpart of ``legion_tpu/parallel/dp.py``):
the gradient mean, and the striped feature table of
``feature_placement="hbm_sharded"``.

Every rank samples and trains on its own batch; the gradients are
averaged over the ranks between the backward pass and the optimizer step
(DDP's all-reduce, the reference's ``legion_graphsage.py:140-141``). The
reference pins two things (``legion_tpu/train/loop.py:160-175``,
``tests/test_comm_accounting.py``): exactly one parameter-sized
all-reduce a step, and the mean of the ranks' gradients, not their sum.
``GradMean`` makes both hold: it flattens every gradient into one float32
buffer, sums it over the ranks in one ``all_reduce`` through the counting
wrapper, divides by the world size and copies the result back.
``DistributedDataParallel`` is not used: its buckets decide the number of
all-reduces.

``make_dp_epoch_fns`` builds a rank's step functions, the counterpart of
the reference's ``make_dp_train_step`` and ``make_dp_epoch_fns``: where
the reference compiles each epoch into one ``jit(shard_map(lax.scan))``
program, the port captures the step, the gradient's all-reduce inside
it, as a CUDA graph on a NCCL group and replays it
(``train/graphed.py``). ``GradMean``'s flat buffer and its views are
allocated once, outside the step, and the gradients in the graph's pool.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from legion_tpu_torch.config import Config
from legion_tpu_torch.parallel.feature_exchange import (
    sharded_row_fetch_stats, stripe_rows)
from legion_tpu_torch.parallel.mesh import Mesh
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.train.loop import StepFns, make_step_fns
from legion_tpu_torch.train.train_state import TrainState, save_checkpoint
from legion_tpu_torch.utils import comm


def put_striped_features(features: np.ndarray, mesh: Mesh,
                         device: torch.device | str) -> torch.Tensor:
    """This rank's stripe of the feature table striped over its cache
    group (rows with id % k == its cache rank, zero-padded to ceil(N/k)),
    on ``device``; only those rows are read."""
    return torch.from_numpy(stripe_rows(np.asarray(features), mesh.cache,
                                        mesh.cache_rank)).to(device)


def save_every_rank(ckpt_dir: str, state: TrainState) -> None:
    """A checkpoint of a data-parallel run, written by rank 0: the shared
    model and optimizer with every rank's generator state. Every rank
    calls it (the generator states are gathered)."""
    generators = comm.all_gather_object(state.generator.get_state())
    if dist.get_rank() == 0:
        save_checkpoint(ckpt_dir, state, generators=generators)


class GradMean:
    """``reducer(model)`` for ``make_step_fns``: every parameter's
    gradient becomes the mean over the ranks."""

    def __init__(self, model: torch.nn.Module):
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.world = dist.get_world_size()
        n = sum(p.numel() for p in self.params)
        self.flat = torch.empty(n, dtype=torch.float32,
                                device=self.params[0].device)
        self.views = []
        off = 0
        for p in self.params:
            self.views.append(self.flat[off:off + p.numel()].view_as(p))
            off += p.numel()

    def __call__(self, model: torch.nn.Module) -> None:
        for p, v in zip(self.params, self.views):
            v.copy_(p.grad)
        comm.all_reduce(self.flat)
        self.flat.div_(self.world)
        for p, v in zip(self.params, self.views):
            p.grad.copy_(v)


def make_dp_epoch_fns(cfg: Config, model: torch.nn.Module,
                      caps: Sequence[int], mesh: Mesh,
                      sharded_features: bool = False,
                      pool: Optional[GraphPool] = None) -> StepFns:
    """This rank's step functions at ``caps`` (``train.loop.StepFns``):
    the train step averages ``model``'s gradients over the ranks
    (``GradMean``), and with ``sharded_features`` every step fetches the
    frontier's rows from the table striped over ``mesh``'s cache group
    (``sharded_row_fetch_stats`` at the probe-free owner cap, its capped
    requests counted in ``cap_overflow``). ``epoch_scan`` and
    ``eval_scan`` are the reference's ``jit_epoch`` and
    ``jit_eval_scan``: captured in ``pool`` where it captures
    (``parallel.mesh.captures_steps``), eager otherwise."""
    fetch = None
    if sharded_features:
        def fetch(feats, frontier):
            return sharded_row_fetch_stats(feats, frontier, mesh.group)
    return make_step_fns(cfg, caps, reducer=GradMean(model),
                         feature_fetch=fetch, pool=pool)
