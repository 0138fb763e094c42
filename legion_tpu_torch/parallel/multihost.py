"""The training step over an edge-partitioned graph (port of
``legion_tpu/parallel/multihost.py``).

No rank holds the whole graph or feature table (``parallel/halo.py``):
each hop's neighbor expansion is served by the partitions' owners, every
hop is deduped by ``grow_frontier`` with the ``[seeds | hop1-new |
hop2-new]`` numbering of the rank's own batch, the frontier's features
arrive through the halo exchange, and ``dp.GradMean`` averages the
gradients in one parameter-sized all-reduce a step. The step functions are
``train.loop.make_step_fns``' with the partitioned sampler and feature
fetch in place of the single-device ones. Nothing in a step reads a device
value on the host: the losses, edge counts and the requests the exact
exchange had to cap (``halo_overflow``, summed on the device by
``HaloPath``) come back in one small all-reduce an epoch, the eval counts
in one an evaluation.

The draw grid is the reference's: each rank draws one (k * M, fanout)
float32 grid a hop (M the hop's frontier cap) from its state's generator
in training and from a generator of its own in eval; parity tests hand
the grids in instead (``uniforms``).

An epoch and an eval pass run through the step functions' ``epoch_scan``
and ``eval_scan`` (``make_partitioned_epoch_fns``, the counterpart of the
reference's ``make_partitioned_train_step`` / ``make_partitioned_epoch_fns``
and its ``_partitioned_step_fns``' scans): on a NCCL group each step is
captured as a CUDA graph, its collectives inside, and replayed
(``train/graphed.py``); under gloo the same static-buffer step runs
eagerly. ``HaloPath.overflow`` is added to in place inside the step, so
replays keep accumulating it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from legion_tpu_torch.config import Config
from legion_tpu_torch.parallel.dp import GradMean
from legion_tpu_torch.parallel.halo import (
    HostShard, partitioned_row_fetch, partitioned_row_fetch_exact,
    partitioned_sample_hop, partitioned_sample_hop_exact)
from legion_tpu_torch.sampling.block import SampledBatch
from legion_tpu_torch.sampling.sampler import grow_frontier
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.train.loop import StepFns, make_step_fns
from legion_tpu_torch.utils import comm, trace


def sample_batch_partitioned(shard: HostShard, seeds: torch.Tensor,
                             num_seeds: torch.Tensor, labels: torch.Tensor,
                             fanouts: Sequence[int], caps: Sequence[int],
                             grids: Sequence[torch.Tensor],
                             owner_of: Optional[torch.Tensor] = None,
                             dist_caps: Optional[Sequence[int]] = None,
                             group=None) -> Tuple[SampledBatch, torch.Tensor]:
    """Multi-hop sampling whose neighbor expansion the partitions' owners
    serve; the dedup and the numbering stay this rank's. ``grids[h]`` is
    this rank's (k * caps[h], fanouts[h]) float32 grid of hop h.
    ``dist_caps`` set: the exact exchange (``owner_of`` the (N,) int8
    owner table), whose capped requests come back -1 and are counted;
    None: the psum exchange. Returns (batch, () int32 capped requests)."""
    caps = tuple(caps)
    dev = seeds.device
    frontier = torch.full((caps[0],), -1, dtype=torch.int32, device=dev)
    frontier[: seeds.shape[0]] = seeds
    num = num_seeds.to(torch.int32)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    blocks = []
    for hop, u in enumerate(grids):
        if dist_caps is not None:
            nbrs, ov = partitioned_sample_hop_exact(
                shard, owner_of, u, frontier, dist_caps, group)
            overflow = overflow + ov
        else:
            nbrs = partitioned_sample_hop(shard, u, frontier, group)
        frontier, num, blk = grow_frontier(frontier, num, nbrs, caps[hop + 1])
        blocks.append(blk)
    return SampledBatch(seeds=seeds, labels=labels,
                        num_seeds=num_seeds.to(torch.int32),
                        frontier=frontier, num_frontier=num,
                        blocks=tuple(blocks)), overflow


class HaloPath:
    """This rank's side of the partitioned path: its shard, the owner table
    (None for the psum exchange, which needs none) and the exchange (exact
    at ``dist_caps``, psum where None), with the
    sampler and the feature fetch that ``make_step_fns`` takes. Every
    request the exact exchange caps adds to ``overflow``, a () int32 device
    tensor that the caller zeroes and reads."""

    def __init__(self, shard: HostShard, owner_of: Optional[torch.Tensor],
                 dist_caps: Optional[Sequence[int]], group=None):
        self.shard = shard
        self.owner_of = owner_of
        self.dist_caps = None if dist_caps is None else tuple(dist_caps)
        self.group = group
        self.k = dist.get_world_size(group)
        self.overflow = torch.zeros((), dtype=torch.int32,
                                    device=shard.owned_ids.device)

    def sampler(self, fanouts: Sequence[int], caps: Sequence[int]):
        """``make_step_fns``' sampler: each hop's grid drawn from the
        generator, or ``uniforms[h]`` where given."""
        k = self.k

        def sample(graph, seeds, num_seeds, labels, generator, uniforms):
            grids = uniforms
            if grids is None:
                grids = [torch.rand((k * c, f), generator=generator,
                                    device=seeds.device, dtype=torch.float32)
                         for c, f in zip(caps, fanouts)]
            batch, ov = sample_batch_partitioned(
                graph, seeds, num_seeds, labels, fanouts, caps, grids,
                self.owner_of, self.dist_caps, self.group)
            self.overflow += ov
            return batch
        return sample

    def fetch(self, feats, frontier: torch.Tensor) -> torch.Tensor:
        """``make_step_fns``' feature fetch: the frontier's rows (``feats``
        is the shard's own table, read through the exchange)."""
        if self.dist_caps is None:
            return partitioned_row_fetch(self.shard, frontier, self.group)
        x, ov = partitioned_row_fetch_exact(self.shard, self.owner_of,
                                            frontier, self.dist_caps,
                                            self.group)
        self.overflow += ov
        return x


def make_partitioned_epoch_fns(cfg: Config, model: torch.nn.Module,
                               path: HaloPath, caps: Sequence[int],
                               pool: Optional[GraphPool] = None) -> StepFns:
    """The partitioned path's step functions at the frontier caps ``caps``
    (``train.loop.StepFns``): ``path``'s sampler and feature fetch, and
    ``dp.GradMean`` averaging ``model``'s gradients in the train step.
    ``epoch_scan`` and ``eval_scan`` are the reference's ``jit_epoch`` and
    ``jit_eval_scan``, each hop's uniforms a (k * cap, fanout) grid:
    captured in ``pool`` where it captures
    (``parallel.mesh.captures_steps``), eager otherwise."""
    fanouts = tuple(cfg.sampler.fanouts)
    return make_step_fns(cfg, caps, reducer=GradMean(model),
                         feature_fetch=path.fetch,
                         sampler=path.sampler(fanouts, caps), pool=pool,
                         uniform_shapes=[(path.k * c, f)
                                         for c, f in zip(caps, fanouts)])


def _int32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


class PartitionedTrainer:
    """The train and eval steps of the partitioned path over ``path``'s
    ranks (``make_partitioned_epoch_fns``), at the loose frontier caps
    ``caps`` (train) and ``eval_caps``, captured in ``pool`` where it
    captures."""

    def __init__(self, cfg: Config, model: torch.nn.Module, path: HaloPath,
                 caps: Sequence[int], eval_caps: Sequence[int],
                 pool: Optional[GraphPool] = None):
        self.path = path
        self.caps, self.eval_caps = tuple(caps), tuple(eval_caps)
        self.fns = make_partitioned_epoch_fns(cfg, model, path, caps, pool)
        self.fns_eval = make_partitioned_epoch_fns(cfg, model, path,
                                                   eval_caps, pool)

    def run_epoch(self, state, seeds: np.ndarray, labels: np.ndarray,
                  uniforms: Optional[Callable] = None) -> Dict:
        """Train this rank's (steps, b) seeds in lockstep with the others
        through ``epoch_scan``. ``uniforms(step, hop)`` gives the grids
        (``step`` the state's global step). Returns the figures of all
        ranks: per-step mean loss, the epoch's edges, frontier-cap and
        halo overflow."""
        shard = self.path.shard
        scan = self.fns.epoch_scan
        with trace.span("epoch.prepare"), trace.span("epoch.load"):
            self.path.overflow.zero_()
            run = scan.load(state, shard, shard.feat_rows, _int32(seeds),
                            _int32(labels), uniforms)
        steps = seeds.shape[0]
        with trace.span("epoch.steps"):
            m = scan.replay(run, state, shard, shard.feat_rows, steps,
                            uniforms)
        with trace.span("epoch.read"):
            # loss, edges and cap_overflow of every step, and the epoch's
            # halo overflow: the epoch's one device -> host read, summed
            # over ranks
            packed = comm.all_reduce(torch.cat([
                m[:, [0, 1, 3]].reshape(-1),
                self.path.overflow.to(torch.float64)[None]])).cpu()
        m = packed[:-1].reshape(steps, 3)
        losses = (m[:, 0] / self.path.k).to(torch.float32).numpy()
        return {"losses": losses.tolist(), "steps": steps,
                "edges": int(m[:, 1].to(torch.int64).sum()),
                "cap_overflow": int(m[:, 2].sum()),
                "halo_overflow": int(packed[-1])}

    @torch.no_grad()
    def eval_counts(self, model: torch.nn.Module, seeds: np.ndarray,
                    counts: np.ndarray, labels: np.ndarray,
                    generator: torch.Generator,
                    uniforms: Optional[Callable] = None):
        """(correct, valid, halo overflow) of this rank's (steps, cap) eval
        seeds, summed over the ranks (``lp_sage``: LP loss sum and valid
        pairs). ``uniforms(step, hop)`` gives the grids. Through
        ``eval_scan``, which sums in float32 as the reference's does."""
        shard = self.path.shard
        scan = self.fns_eval.eval_scan
        with trace.epoch("eval") as root:
            root.steps = seeds.shape[0]
            with trace.span("epoch.prepare"), trace.span("epoch.load"):
                self.path.overflow.zero_()
                run = scan.load(model, shard, shard.feat_rows, _int32(seeds),
                                _int32(counts), _int32(labels), generator,
                                uniforms)
            with trace.span("epoch.steps"):
                acc = scan.replay(run, model, shard, shard.feat_rows,
                                  generator, seeds.shape[0], uniforms)
            with trace.span("epoch.read"):
                c, n, ov = comm.all_reduce(torch.cat([
                    acc, self.path.overflow[None]]).to(torch.float64)).tolist()
        return c, n, int(ov)


def owner_table(partition: np.ndarray,
                device: torch.device | str) -> torch.Tensor:
    """The (N,) int8 partition id of every node on ``device``, replicated:
    the requester's owner lookup of the exact exchange (N bytes a rank for
    k <= 127)."""
    if int(np.asarray(partition).max(initial=0)) >= 127:
        raise ValueError("the int8 owner table holds at most 127 parts")
    return torch.from_numpy(np.asarray(partition).astype(np.int8)).to(device)


def probe_dist_caps(indptr, indices, partition: np.ndarray, shards,
                    fanouts, caps, k: int, batch: int,
                    slack: float = 1.3, probes: int = 2,
                    seed: int = 0) -> Tuple[int, ...]:
    """The exact exchange's k - 1 per-distance caps: ``slack`` x the most
    requests any rank made at each ring distance over ``probes`` random
    batches of ``batch`` seeds from each rank's shard, their frontiers
    grown by the host sampler (``probe_dist_caps_batches``). Probe at the
    largest batch the caps will serve."""
    rng = np.random.default_rng(seed * 7907 + 3)
    batches = [(i, rng.permutation(np.asarray(shards[i]))[:batch])
               for bi in range(probes) for i in range(k)
               if len(shards[i])]
    return probe_dist_caps_batches(indptr, indices, partition, batches,
                                   fanouts, caps, k, slack=slack, seed=seed)


def probe_dist_caps_batches(indptr, indices, partition: np.ndarray,
                            batches, fanouts, caps, k: int,
                            slack: float = 1.3,
                            seed: int = 0) -> Tuple[int, ...]:
    """``probe_dist_caps`` over explicit (requesting rank, seed ids)
    batches, such as the eval schedule's fixed chunks. Every hop's
    frontier counts (``cache.hotness.host_frontier_probe``); each cap is
    ``feature_exchange.probed_cap`` of the maximum, within the last
    frontier cap."""
    from legion_tpu_torch.cache.hotness import host_frontier_probe
    from legion_tpu_torch.parallel.feature_exchange import probed_cap
    rng = np.random.default_rng(seed * 7907 + 3)
    dmax = np.zeros(k, np.int64)
    for bi, (i, ids) in enumerate(batches):
        ids = np.asarray(ids)
        ids = ids[ids >= 0]
        if not len(ids):
            continue

        def visit(hop, frontier, i=i):
            dist_ = (partition[frontier] - i) % k
            np.maximum(dmax, np.bincount(dist_, minlength=k), out=dmax)

        host_frontier_probe(indptr, indices, [ids], fanouts, caps, visit,
                            rng, seed_base=1300 + bi * 1009)
    return tuple(probed_cap(int(dmax[r]), caps[-1], slack)
                 for r in range(1, k))
