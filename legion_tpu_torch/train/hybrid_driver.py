"""Hybrid-placement training driver: the CSR in host memory, a hot sub-CSR
on the device, host features behind a ``FeatureCache`` (port of
``legion_tpu/train/hybrid_driver.py`` and, with a mesh,
``legion_tpu/train/striped_hybrid_driver.py``).

The uk-union / clueweb class of placement (``topology_placement="host"``):
the topology does not fit the device, so the device samples only the
frontier's cache hits from the compacted sub-CSR (``cache/topo_cache.py``)
while the misses are sampled by the threaded C++ host sampler and merged
(``cache/hybrid.py``), where the reference's GPU threads read a pinned
host CSR zero-copy (``src/Kernels.cu:468-564``). Features stay in host
memory behind the hotness cache, as in the cached driver, and the cost
model splits one budget between the two caches.

Presampling runs on the host (the reference's pre-sampler reads the host
CSR too, ``kernel_pre_sampler_optimized``): hotness histograms through
the C++ runtime, and the realized frontier maxima that size the caps.

With a mesh it is the uk2014 / clueweb class of placement on every rank at
once (``src/Server.cu:116-133``, ``src/Kernels.cu:387-397``,
``src/GPUCache.cu:88-141``): every rank does the same host presample over
every rank's stream, so each reaches the same cost model (over the
group's budget, ``group_size`` x a device's), caps and hot sets without a
collective, and each then builds only its own stripes of both caches
(``cache/striped.py``, ``cache/striped_hybrid.py``). On one rank the mesh
path trains as the path without one; rank 0 logs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from legion_tpu_torch import runtime
from legion_tpu_torch.cache.cost_model import solve_cost_model
from legion_tpu_torch.cache.feature_cache import (FeatureCache,
                                                  cache_dtype_for,
                                                  fixed_miss_cap)
from legion_tpu_torch.cache.hotness import host_frontier_probe, observed_caps
from legion_tpu_torch.cache.hybrid import HybridSampler, HybridTrainer
from legion_tpu_torch.cache.striped import (StripedFeatureCache,
                                            StripedTopoCache)
from legion_tpu_torch.cache.striped_hybrid import StripedHybridTrainer
from legion_tpu_torch.cache.topo_cache import TopoCache
from legion_tpu_torch.config import Config
from legion_tpu_torch.data.format import GraphData
from legion_tpu_torch.models import build_model, model_args
from legion_tpu_torch.parallel.dp import save_every_rank
from legion_tpu_torch.parallel.feature_exchange import probed_owner_cap
from legion_tpu_torch.parallel.mesh import Mesh, captures_steps, make_mesh
from legion_tpu_torch.parallel.trainer import _quiet
from legion_tpu_torch.sampling.seeds import (epoch_train_seeds,
                                             make_seed_plan, seeds_of_epoch,
                                             shard_node_set)
from legion_tpu_torch.train.cached_driver import rank_eval
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.train.loop import rank_seed
from legion_tpu_torch.train.train_state import (create_train_state,
                                                restore_checkpoint,
                                                save_checkpoint)
from legion_tpu_torch.utils import trace
from legion_tpu_torch.utils.logging import eval_labels


def presample_hotness_host(indptr: np.ndarray, indices: np.ndarray,
                           seeds_epoch: np.ndarray, fanouts: Sequence[int],
                           num_nodes: int, seed: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host presampling epoch over (steps, batch) seeds: (node_hot,
    edge_hot, max_per_hop). ``cache.hotness.presample_hotness``'s
    semantics on the host CSR: feature hotness counts every unique
    frontier membership, topology hotness every adjacency row a hop reads;
    hop k of step t is seeded ``seed * 1_000_003 + t * 31 + k``."""
    node_hot = np.zeros(num_nodes, np.int64)
    edge_hot = np.zeros(num_nodes, np.int64)
    max_per_hop = np.zeros(len(fanouts) + 1, np.int64)
    for t in range(seeds_epoch.shape[0]):
        row = seeds_epoch[t]
        frontier = np.unique(row[row >= 0]).astype(np.int32)
        counts = [len(frontier)]
        for k, f in enumerate(fanouts):
            runtime.accumulate_hist(edge_hot, frontier)      # rows read
            nbrs = runtime.sample_neighbors(
                indptr, indices, frontier, f,
                seed=seed * 1_000_003 + t * 31 + k)
            frontier = np.unique(np.concatenate(
                [frontier, nbrs[nbrs >= 0]])).astype(np.int32)
            counts.append(len(frontier))
        runtime.accumulate_hist(node_hot, frontier)          # rows gathered
        max_per_hop = np.maximum(max_per_hop, counts)
    return node_hot, edge_hot, max_per_hop


def _probe_owner_caps(indptr, indices, seeds_batches, fanouts, caps,
                      hot_topo: np.ndarray, hot_feat: np.ndarray, kg: int,
                      seed: int = 0):
    """The striped exchanges' owner caps from a host-side probe: frontiers
    grown by ``host_frontier_probe``, each hop's topology-hit ranks and
    the final frontier's feature-hit ranks counted by owner (rank % kg).
    Returns (per-hop topology caps, feature cap) at ~1.05x the observed
    maxima; a burst past them demotes to the host path."""
    rng = np.random.default_rng(seed * 9176 + 13)
    h = len(fanouts)
    tmax = np.zeros(h, np.int64)
    fmax = np.zeros(1, np.int64)

    def hit_ranks(hot_sorted, ids):
        if len(hot_sorted) == 0 or len(ids) == 0:
            return np.empty(0, np.int64)
        pos = np.clip(np.searchsorted(hot_sorted, ids), 0,
                      len(hot_sorted) - 1)
        return pos[hot_sorted[pos] == ids]

    def omax(ranks):
        if not len(ranks):
            return 0
        return int(np.bincount(ranks % kg, minlength=kg).max())

    def visit(hop, frontier):
        if hop < h:
            tmax[hop] = max(tmax[hop], omax(hit_ranks(hot_topo, frontier)))
        else:
            fmax[0] = max(fmax[0], omax(hit_ranks(hot_feat, frontier)))

    host_frontier_probe(indptr, indices, seeds_batches, fanouts, caps,
                        visit, rng, seed_base=7700 + seed * 131)
    tcaps = tuple(probed_owner_cap(int(tmax[k]), caps[k], kg)
                  for k in range(h))
    return tcaps, probed_owner_cap(int(fmax[0]), caps[-1], kg)


def run_hybrid_training(cfg: Config, data: GraphData,
                        device: torch.device | str,
                        mesh: Optional[Mesh] = None,
                        log: Callable[[str], None] = print) -> Dict:
    """Initialize -> PreSc (on the host) -> Run for the host-topology
    placement on ``device``; with ``mesh``, in this rank of the
    initialized process group, both caches striped over its cache group.
    Returns {"state", "history", "cost", "trainer", "test_acc"} and,
    without a mesh, "sampler" (a ``HybridSampler`` on the caches) or, with
    one, "mesh" (its shape); each history record is the trainer's
    ``run_epoch``'s plus the epoch, its validation figure (accuracy, or
    the LP loss for ``lp_sage``), the caps, the staging capacity, the
    owner caps (None without a cache group) and the presample's seconds.
    The staging capacity is the reference's fixed formula (neither probed
    nor grown). With ``train.checkpoint_dir`` set it resumes from that
    directory's latest checkpoint, saves after every epoch and, with
    ``train.checkpoint_every_steps``, within one. As the reference's
    driver, it reads neither placement, nor ``CacheConfig.enabled``, nor
    ``train.profile_dir``: the topology and the features stay in host
    memory here, and a zero budget gives two empty caches (every hop and
    every feature row is served from the host)."""
    n, kg, rank = ((mesh.world, mesh.cache, mesh.rank) if mesh is not None
                   else (1, 1, 0))
    # without a mesh the cost model still takes ``group_size`` devices'
    # budget, as the reference's single-device driver does
    budget_group = kg if mesh is not None else cfg.cache.group_size
    if rank != 0:
        log = _quiet
    device = torch.device(device)
    # int64 offsets and int32 ids as they are loaded: nothing is copied,
    # and the CSR never goes to the device whole
    indptr = np.ascontiguousarray(np.asarray(data.indptr), np.int64)
    indices = np.ascontiguousarray(np.asarray(data.indices), np.int32)
    num_classes = cfg.dataset.num_classes or data.num_classes
    b = cfg.sampler.batch_size
    fanouts = tuple(cfg.sampler.fanouts)

    shards = shard_node_set(np.asarray(data.train_ids), n)
    plan = make_seed_plan([len(s) for s in shards],
                          [max(len(data.valid_ids), 1)] * n,
                          [max(len(data.test_ids), 1)] * n, b,
                          cfg.sampler.eval_batch_size)
    rng = np.random.default_rng(cfg.train.seed)
    seeds, _ = epoch_train_seeds(rng, shards, plan)       # (n, steps, b)

    # ---- presampling (host CSR) over every rank's stream -------------------
    with trace.span("setup.presample") as span:
        steps = cfg.cache.presample_steps or plan.train_steps
        pres = seeds[:, :steps].reshape(-1, b)
        node_hot, edge_hot, max_per_hop = presample_hotness_host(
            indptr, indices, pres, fanouts, data.num_nodes, cfg.train.seed)
    presample_s = span.seconds
    log(f"host presampling: {pres.shape[0]} steps in {presample_s:.1f}s")

    # ---- cost model: one budget split between the two caches --------------
    cache_dtype, row_bytes = cache_dtype_for(cfg.model.dtype,
                                             data.feature_dim)
    with trace.span("setup.cost_model"):
        cost = solve_cost_model(
            node_hot, edge_hot, data.degrees(), cfg.cache.budget_bytes,
            feat_row_bytes=row_bytes, group_size=budget_group,
            granularity=cfg.cache.cost_model_granularity)
    log(f"cost model: alpha={cost.alpha:.2f} feat_cap={cost.feat_capacity} "
        f"topo_cap={cost.topo_capacity} (x{budget_group} ranks/group)")
    caps = observed_caps(max_per_hop, cfg.sampler.observed_cap_slack)

    # the reference's fixed staging capacity: it is neither probed nor
    # grown, so a step with more misses reads the rest as zero rows
    # (``staging_overflow`` counts them)
    miss_cap = fixed_miss_cap(caps[-1])

    # on a cache group, the exchanges' owner caps from a host probe of
    # rank 0's first two batches (the probe-free caps on a one-rank group)
    tcaps = ocap_feat = None
    if kg > 1:
        topo_n = int(min(cost.topo_capacity, len(cost.topo_order)))
        feat_n = int(min(cost.feat_capacity, len(cost.feat_order)))
        tcaps, ocap_feat = _probe_owner_caps(
            indptr, indices, seeds[0][: min(2, seeds.shape[1])], fanouts,
            caps, np.sort(np.asarray(cost.topo_order[:topo_n], np.int64)),
            np.sort(np.asarray(cost.feat_order[:feat_n], np.int64)), kg,
            seed=cfg.train.seed)
        log(f"owner-cap probe (Kg={kg}): topo {tcaps}, feat {ocap_feat}")
    with trace.span("setup.cache_build"):
        if mesh is None:
            topo = TopoCache.build(indptr, indices, cost.topo_order,
                                   cost.topo_capacity, device)
            cache = FeatureCache.build(data.features, cost.feat_order,
                                       cost.feat_capacity, miss_cap=miss_cap,
                                       dtype=cache_dtype, device=device)
        else:
            topo = StripedTopoCache.build(indptr, indices, cost.topo_order,
                                          cost.topo_capacity, mesh, device)
            cache = StripedFeatureCache.build(
                data.features, cost.feat_order, cost.feat_capacity, miss_cap,
                mesh, dtype=cache_dtype, device=device,
                owner_cap_rows=ocap_feat)
    out = ({"sampler": HybridSampler(topo, indptr, indices, fanouts, caps)}
           if mesh is None else {"mesh": mesh.shape})

    # ---- model/state: the same weights on every rank -----------------------
    model = build_model(**model_args(cfg.model, data.feature_dim,
                                     num_classes, cfg.train.seed)).to(device)
    state = create_train_state(model, cfg.train.learning_rate,
                               rank_seed(cfg.train.seed, rank), device)
    if (cfg.train.checkpoint_dir
            and restore_checkpoint(cfg.train.checkpoint_dir, state,
                                   rank=rank, world=n)):
        log(f"resumed from checkpoint at step {state.step}, "
            f"epoch {state.epoch}")

    # the pipeline's device stages are captured on a CUDA device; on a
    # group, on a NCCL one
    if mesh is None:
        tr = HybridTrainer(cfg, model, caps, topo, indptr, indices, cache,
                           pool=GraphPool(device))
    else:
        tr = StripedHybridTrainer(
            cfg, model, caps, topo, indptr, indices, cache, mesh,
            topo_owner_caps=tcaps,
            pool=GraphPool(device) if captures_steps(device) else None)
    save = save_checkpoint if mesh is None else save_every_rank
    labels_all = np.asarray(data.labels)
    vlab, tlab = eval_labels(cfg)

    def eval_set(ids: np.ndarray) -> float:
        if not len(ids):
            return float("nan")
        s, c, lab = rank_eval(shard_node_set(ids, n), b,
                              cfg.sampler.eval_batch_size, rank, labels_all)
        return tr.eval_epoch(model, s, c, lab)

    # ---- training ---------------------------------------------------------
    history = []
    for epoch in range(state.epoch, cfg.train.epochs):
        s = seeds_of_epoch(cfg.train.seed, epoch, shards, plan)[rank]
        r = tr.run_epoch(state, s, labels_all[s], epoch)
        state = r.pop("state")
        r.update(caps=list(caps), miss_cap=miss_cap, presample_s=presample_s,
                 topo_owner_caps=tcaps, feat_owner_cap=ocap_feat)
        r["epoch"] = epoch
        r["valid"] = eval_set(np.asarray(data.valid_ids))
        state.epoch = epoch + 1
        history.append(r)
        log(f"Epoch:{epoch}, Cost:{r['seconds']:.3f} s, "
            f"Loss:{r['loss']:.4f}, feat_hit:{r['feat_hit_rate']:.3f}, "
            f"topo_hot:{r['topo_hot_fraction']:.3f}, "
            f"{vlab}: {r['valid']:.4f}"
            + (f" [STAGING OVERFLOW {r['staging_overflow']} rows]"
               if r["staging_overflow"] else "")
            + (f" [EXCHANGE OVERFLOW {r['exchange_overflow']} hits demoted]"
               if r.get("exchange_overflow") else ""))
        if cfg.train.checkpoint_dir:
            save(cfg.train.checkpoint_dir, state)
    test_acc = eval_set(np.asarray(data.test_ids))
    log(f"{tlab}: {test_acc:.4f}")
    return {"state": state, "history": history, "cost": cost, "trainer": tr,
            "test_acc": test_acc, **out}


def hybrid_rank(device: torch.device, cfg_json: str, load: Callable,
                load_kwargs: Dict) -> None:
    """A rank's whole run on the mesh of ``cache.group_size``-rank cache
    groups, as ``parallel.mesh.spawn`` calls it (see
    ``parallel.trainer.fit_rank``)."""
    cfg = Config.from_json(cfg_json)
    data = load(**load_kwargs)
    run_hybrid_training(cfg, data, device,
                        mesh=make_mesh(cfg.cache.group_size))
