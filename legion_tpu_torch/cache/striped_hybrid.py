"""Data-parallel hybrid training over cache groups: the hot sub-CSR and the
hot feature rows striped over each cache group, the host sampler for the
rest (port of ``legion_tpu/cache/striped_hybrid.py``).

The reference's uk2014 / clueweb class on every GPU at once
(``src/Server.cu:116-133``): hybrid sampling (GPU threads reading the
pinned host CSR, a cached sub-CSR for the hot rows,
``src/Kernels.cu:387-397,468-564``) with the topology and the features
striped over the NVLink clique (``src/GPUCache.cu:88-141``). Here each
rank runs ``HybridTrainer``'s pipeline for its own batch: the hot hops
through ``StripedTopoCache.sample_hot`` (the owner draws with the sampling
kernel and sends the draws back), the misses through the C++ host sampler
for this rank's misses only, the features through ``StripedFeatureCache``;
one packed read a hop, batch i+1's hop 0 issued inside batch i's finish,
gradients averaged over every rank.

The hot hops' uniforms form one (k*M, fanout) grid per cache group, the
same on every rank of it: rank c's request j draws with row c*M + j. The
port builds the grid from one generator per rank of the group, seeded by
that rank's global index, so a rank's rows, and so its draws, are the same
at every group size (the reference folds only the data index into the
group's key for the same purpose). On one rank the grid is drawn from the
state's generator, as ``HybridTrainer`` draws it, so that a one-rank run is
``run_hybrid_training``. Dropout and the host legs draw per rank.

The stages are ``HybridTrainer``'s, captured on a NCCL group
(``parallel.mesh.captures_steps``) with the hot hops' and the features'
exchanges and the gradient's all-reduce inside the graphs, and eager over
gloo. The group's generators lend their state to generators of the run's
own for each pass, which the graphs are registered with.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from legion_tpu_torch.cache.hybrid import HybridTrainer
from legion_tpu_torch.cache.striped import (StripedFeatureCache,
                                            StripedTopoCache)
from legion_tpu_torch.config import Config
from legion_tpu_torch.parallel.dp import GradMean, save_every_rank
from legion_tpu_torch.parallel.mesh import Mesh
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.train.loop import rank_seed
from legion_tpu_torch.utils import comm


class StripedHybridTrainer(HybridTrainer):
    """``HybridTrainer`` over the ranks of the process group with striped
    caches. ``topo_owner_caps``: hop k's per-owner request cap of the hot
    hop's exchange (None: the probe-free cap); the feature cache carries
    its own. Uniform sources (``run_epoch``'s and ``eval_epoch``'s
    ``uniforms``): a callable (step, hop) -> the group's grid (parity
    tests), or a list of one generator per rank of the group."""

    n_stats = 5            # HybridTrainer's, then the demoted feature hits

    def __init__(self, cfg: Config, model: torch.nn.Module, caps,
                 topo: StripedTopoCache, host_indptr: np.ndarray,
                 host_indices: np.ndarray, fcache: StripedFeatureCache,
                 mesh: Mesh,
                 topo_owner_caps: Optional[Sequence[Optional[int]]] = None,
                 pool: Optional[GraphPool] = None):
        super().__init__(cfg, model, caps, topo, host_indptr, host_indices,
                         fcache, reducer=GradMean(model), pool=pool)
        hops = len(self.fanouts)
        self.topo_owner_caps = (tuple(topo_owner_caps) if topo_owner_caps
                                else (None,) * hops)
        if len(self.topo_owner_caps) != hops:
            raise ValueError(f"{len(self.topo_owner_caps)} topology owner "
                             f"caps for {hops} hops")
        self.mesh = mesh
        self.save = save_every_rank

    def group_generators(self, seed: int) -> List[torch.Generator]:
        """One generator per rank of this rank's cache group, rank g's
        seeded ``rank_seed(seed, g)`` (g its global index)."""
        m = self.mesh
        return [torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, m.data_rank * m.cache + c))
            for c in range(m.cache)]

    def _uniform_shape(self, hop: int):
        """The group's (k*M, fanout) grid of hop ``hop``."""
        return (self.mesh.cache * self.caps[hop], self.fanouts[hop])

    def _draw(self, gens, hop: int) -> torch.Tensor:
        """The grid from the state's generator (one rank) or from one
        generator per rank of the group, each drawing its (M, fanout)
        rows."""
        if len(gens) == 1:
            return super()._draw(gens, hop)
        shape = (self.caps[hop], self.fanouts[hop])
        return torch.cat([torch.rand(shape, generator=g, device=self.device,
                                     dtype=torch.float32) for g in gens])

    def _hot(self, frontier, u, hop: int):
        return self.topo.sample_hot(frontier, u, cap=self.topo_owner_caps[hop])

    def _plan(self, frontier):
        plan, demoted = self.fcache.plan_demoted(frontier)
        return plan, [demoted]

    def _cold_seed(self, seed: int) -> int:
        return rank_seed(seed, self.mesh.rank)

    def _sum_ranks(self, t: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(t.clone())

    def _extra(self, tot) -> Dict:
        return {"exchange_overflow": int(tot[4])}

    def run_epoch(self, state, seeds_epoch: np.ndarray,
                  labels_epoch: np.ndarray, epoch: int,
                  uniforms=None) -> Dict:
        """``HybridTrainer.run_epoch`` on this rank's (steps, batch) seeds.
        The hot hops draw from the state's generator on one rank, else
        from the group's generators of this epoch (seeded
        ``seed * 1_000_003 + epoch``); the losses are the mean over the
        ranks, the other figures the sums (``fetches``: this rank's
        reads)."""
        if uniforms is None and self.mesh.world > 1:
            uniforms = self.group_generators(
                self.cfg.train.seed * 1_000_003 + epoch)
        r = super().run_epoch(state, seeds_epoch, labels_epoch, epoch,
                              uniforms)
        r["losses"] = [v / self.mesh.world for v in r["losses"]]
        r["loss"] = r["losses"][-1] if r["losses"] else float("nan")
        return r

    def eval_epoch(self, model: torch.nn.Module, seeds: np.ndarray,
                   counts: np.ndarray, labels: np.ndarray,
                   uniforms=None) -> float:
        """``HybridTrainer.eval_epoch`` on this rank's seeds, the hot hops
        drawing from the group's generators seeded from 4242 (on one rank
        the single-device eval stream), the counts summed over the
        ranks."""
        if uniforms is None:
            uniforms = self.group_generators(4242)
        return super().eval_epoch(model, seeds, counts, labels, uniforms)
