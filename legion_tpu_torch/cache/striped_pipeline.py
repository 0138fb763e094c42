"""Data-parallel cached training over cache groups (port of
``legion_tpu/cache/striped_pipeline.py``).

Every rank samples and trains its own batch (the reference's per-GPU
runner, ``src/Server.cu:167-368``); the hot feature rows are striped over
the rank's cache group (``cache/striped.py``), the hits fetched from their
owners and the misses staged from host memory by each rank for itself
(``src/Kernels.cu:662-702``); gradients are averaged over every rank
(DDP, ``legion_graphsage.py:140-141``). The step is
``cache/pipeline.py``'s: one packed device -> host read a step, which here
also carries the exchange's demoted hits (``exchange_overflow``); the
losses and counts stay on the device and one all-reduce an epoch sums them
over the ranks. The stages are ``CachedTrainer``'s: captured on a NCCL
group (``parallel.mesh.captures_steps``), the exchange's collectives and
the gradient's all-reduce inside the train graphs, eager over gloo.

On one rank this trainer is the ``CachedTrainer``: the same generator
stream, plan and rows, so the same losses.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from legion_tpu_torch.cache.pipeline import CachedTrainer
from legion_tpu_torch.cache.striped import StripedFeatureCache
from legion_tpu_torch.config import Config
from legion_tpu_torch.parallel.dp import GradMean, save_every_rank
from legion_tpu_torch.sampling.sampler import DeviceGraph
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.utils import comm


class StripedCachedTrainer(CachedTrainer):
    """``CachedTrainer`` over the ranks of the process group with a
    ``StripedFeatureCache``: hits past an owner's cap are demoted to
    misses (staged), the gradient is the mean over every rank, and an
    epoch's losses (the mean over the ranks) and statistics (their sum)
    come from one all-reduce. Every rank runs the same number of steps."""

    n_stats = 6

    def __init__(self, cfg: Config, model: torch.nn.Module, caps,
                 graph: DeviceGraph, cache: StripedFeatureCache,
                 pool: Optional[GraphPool] = None):
        super().__init__(cfg, model, caps, graph, cache,
                         reducer=GradMean(model), pool=pool)
        self.world = torch.distributed.get_world_size()
        self.save = save_every_rank

    def _plan(self, frontier):
        plan, demoted = self.cache.plan_demoted(frontier)
        return plan, [demoted]

    def _sum_ranks(self, t: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(t.clone())

    def run_epoch(self, state, seeds_epoch: np.ndarray,
                  labels_epoch: np.ndarray, uniforms=None) -> Dict:
        """``CachedTrainer.run_epoch`` on this rank's (steps, batch) seeds;
        the losses are the mean over the ranks, the figures the sums."""
        r = super().run_epoch(state, seeds_epoch, labels_epoch, uniforms)
        r["losses"] = [v / self.world for v in r["losses"]]
        r["loss"] = r["losses"][-1] if r["losses"] else float("nan")
        return r

    def _extra(self, tot: np.ndarray) -> Dict:
        return {"exchange_overflow": int(tot[5])}
