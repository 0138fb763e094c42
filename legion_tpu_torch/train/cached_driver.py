"""Cached-training driver: presampling epoch -> cost model -> cache build
-> pipelined training with eval (port of
``legion_tpu/train/cached_driver.py`` and, with a mesh,
``legion_tpu/train/striped_driver.py``).

It follows the reference server's lifecycle ``Initialize -> PreSc ->
Run`` (``src/main.cpp:4-9``, ``src/Server.cu:83-133``) in one process:
presampling measures hotness and the realized frontier sizes, the cost
model gives the feature cache its budget, the caps are tightened to 1.2x
what presampling saw (``src/Server.cu:273-282``), the cache is filled,
and training runs the pipeline of ``cache/pipeline.py``. The topology is
whole in device memory; the features stay in host memory (a numpy array
or memmap) behind the cache. The set-up's phases are the spans
``setup.presample``, ``setup.cost_model`` and ``setup.cache_build`` of
``utils/trace.py``.

With a mesh it is the configuration the reference ships as "Legion" on
this rank of the process group: N GPU runners training data-parallel
(``src/Server.cu:116-133``) with the hot feature cache striped over each
NVLink clique (``src/GPUCache.cu:103-141``). Every rank presamples over
every rank's seed stream (each does the same work, so each reaches the
same hot set and caps without a collective), the cost model takes the
group's budget (``group_size`` x a device's), and the cache and pipeline
are ``cache/striped.py``'s and ``cache/striped_pipeline.py``'s. Rank r
draws ``train.loop.rank_seed(seed, r)``'s stream, so that on one rank
the mesh path trains as the path without one; rank 0 writes every rank's
generator in a checkpoint, and logs.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from legion_tpu_torch.cache.cost_model import solve_cost_model
from legion_tpu_torch.cache.feature_cache import (FeatureCache,
                                                  cache_dtype_for,
                                                  grown_miss_cap,
                                                  probe_staging,
                                                  probed_miss_cap)
from legion_tpu_torch.cache.hotness import observed_caps, presample_hotness
from legion_tpu_torch.cache.pipeline import CachedTrainer
from legion_tpu_torch.cache.striped import StripedFeatureCache
from legion_tpu_torch.cache.striped_pipeline import StripedCachedTrainer
from legion_tpu_torch.config import Config
from legion_tpu_torch.data.format import GraphData
from legion_tpu_torch.models import build_model, model_args
from legion_tpu_torch.parallel.dp import save_every_rank
from legion_tpu_torch.parallel.feature_exchange import probed_owner_cap
from legion_tpu_torch.parallel.mesh import Mesh, captures_steps, make_mesh
from legion_tpu_torch.parallel.trainer import _quiet
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import DeviceGraph
from legion_tpu_torch.sampling.seeds import (epoch_eval_seeds,
                                             epoch_train_seeds,
                                             make_seed_plan, seeds_of_epoch,
                                             shard_node_set)
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.train.loop import rank_seed
from legion_tpu_torch.train.train_state import (create_train_state,
                                                restore_checkpoint,
                                                save_checkpoint)
from legion_tpu_torch.utils import trace
from legion_tpu_torch.utils.logging import eval_labels


def rank_eval(shards, b: int, eval_batch_size: int, rank: int,
              labels_all: np.ndarray):
    """This rank's (seeds, counts, labels) of an eval set split over the
    ranks (``shards``), in the lockstep plan of the reference's striped
    drivers: as many steps as the longest shard needs, sampled at the
    train caps (so a step holds at most min(eval_batch_size, b) seeds),
    short shards padded with -1. One shard is the single-device plan."""
    per_lim = min(eval_batch_size, b)
    mx = max(max(len(s) for s in shards), 1)
    steps = (mx - 1) // per_lim + 1
    per = tuple((len(s) - 1) // steps + 1 if len(s) else 0 for s in shards)
    seeds, counts = epoch_eval_seeds(shards, steps, per, b)
    lab = np.where(seeds[rank] >= 0,
                   labels_all[np.clip(seeds[rank], 0, None)], -1)
    return seeds[rank], counts[rank], lab.astype(np.int32)


def run_cached_training(cfg: Config, data: GraphData,
                        device: torch.device | str,
                        mesh: Optional[Mesh] = None,
                        log: Callable[[str], None] = print) -> Dict:
    """Train ``cfg`` on ``data`` with host-resident features behind the
    hot-row cache on ``device``; with ``mesh``, in this rank of the
    initialized process group, the cache striped over its cache group.
    Returns {"state", "history", "cost", "test_acc"}, with a mesh also
    "trainer" and "mesh" (its shape); each history record is the
    trainer's ``run_epoch``'s (with a mesh, figures of every rank) plus
    the epoch, its validation figure (accuracy, or the LP loss for
    ``lp_sage``), the caps, the staging capacity, the owner cap (None
    without a cache group) and the presample's seconds. With
    ``train.checkpoint_dir`` set it resumes from that directory's latest
    checkpoint, saves after every epoch and, with
    ``train.checkpoint_every_steps``, within an epoch. Without a mesh and
    with ``train.profile_dir`` set, the first epoch it trains after the
    one that captures the pipeline's stages (the steady state; the only
    epoch, if it trains one) runs under ``torch.profiler``, its trace
    written there as ``epoch_<n>.pt.trace.json``. As the reference's
    driver, it does not read ``feature_placement``: the features always
    stay in host memory here."""
    if not cfg.cache.enabled:
        raise ValueError(
            "run_cached_training keeps the features behind the cache: it "
            "needs CacheConfig(enabled=True), got enabled=False "
            "(train.loop.Trainer runs features in device memory)")
    if cfg.dataset.topology_placement != "hbm":
        raise ValueError(
            "run_cached_training keeps the topology whole in device memory; "
            f"topology_placement={cfg.dataset.topology_placement!r} runs "
            "through "
            "legion_tpu_torch.train.hybrid_driver.run_hybrid_training")
    n, kg, rank = ((mesh.world, mesh.cache, mesh.rank) if mesh is not None
                   else (1, 1, 0))
    # without a mesh the cost model still takes ``group_size`` devices'
    # budget, as the reference's single-device driver does
    budget_group = kg if mesh is not None else cfg.cache.group_size
    if rank != 0:
        log = _quiet
    device = torch.device(device)
    graph = DeviceGraph.from_host(data.indptr, data.indices, device)
    num_classes = cfg.dataset.num_classes or data.num_classes
    b = cfg.sampler.batch_size
    fanouts = tuple(cfg.sampler.fanouts)
    loose_caps = frontier_caps(b, fanouts)

    # every rank's train shard and the lockstep step plan
    shards = shard_node_set(np.asarray(data.train_ids), n)
    plan = make_seed_plan([len(s) for s in shards],
                          [max(len(data.valid_ids), 1)] * n,
                          [max(len(data.test_ids), 1)] * n, b,
                          cfg.sampler.eval_batch_size)
    rng = np.random.default_rng(cfg.train.seed)
    seeds, _ = epoch_train_seeds(rng, shards, plan)       # (n, steps, b)

    # ---- presampling epoch (PreSc) over every rank's stream ---------------
    with trace.span("setup.presample") as span:
        steps = cfg.cache.presample_steps or plan.train_steps
        pres = np.ascontiguousarray(seeds[:, :steps].reshape(-1, b))
        hot = presample_hotness(
            graph, torch.from_numpy(pres).to(device),
            torch.full((pres.shape[0],), b, dtype=torch.int32,
                       device=device),
            fanouts, loose_caps, data.num_nodes,
            generator=torch.Generator(device=device).manual_seed(
                cfg.train.seed))
        max_frontier = int(hot.max_frontier)      # waits for the presample
    presample_s = span.seconds
    log(f"presampling: {pres.shape[0]} steps in {presample_s:.1f}s, "
        f"max frontier {max_frontier}/{loose_caps[-1]}")

    # ---- cost model + cache build -----------------------------------------
    cache_dtype, row_bytes = cache_dtype_for(cfg.model.dtype,
                                             data.feature_dim)
    with trace.span("setup.cost_model"):
        # the topology is whole in device memory: a topology cache would
        # save no host bytes, so the whole budget goes to features
        node_hot = hot.node_hot.cpu().numpy().astype(np.int64)
        cost = solve_cost_model(
            node_hot, hot.edge_hot.cpu().numpy(), data.degrees(),
            cfg.cache.budget_bytes, feat_row_bytes=row_bytes,
            group_size=budget_group,
            granularity=cfg.cache.cost_model_granularity,
            topo_cacheable=False)
    log(f"cost model: alpha={cost.alpha:.2f} feat_cap={cost.feat_capacity} "
        f"(x{budget_group} ranks/group) topo_cap={cost.topo_capacity}")

    caps = observed_caps(hot.max_per_hop, cfg.sampler.observed_cap_slack)
    with trace.span("setup.cache_build"):
        # Staging is sized from the expected misses per step, not the
        # whole frontier: an unbiased probe of two fresh batches against
        # the built hot set and, without a mesh, at least the presample's
        # own estimate (biased low, since the cache holds what the
        # presample saw); an epoch that still overflows grows it. On a
        # cache group the probe's per-owner hit maxima size the exchange's
        # owner cap at ~1.05x what it saw (over-cap hits demote to
        # staging).
        cached_ids = np.asarray(cost.feat_order[:cost.feat_capacity])
        hot_sorted = torch.from_numpy(np.sort(cached_ids.astype(np.int32))
                                      ).to(device)
        probe_miss, owner_max = probe_staging(
            graph, shards, b, fanouts, caps, hot_sorted, cfg.train.seed, kg)
        expected = probe_miss
        if mesh is None:
            expected = max((node_hot.sum() - node_hot[cached_ids].sum())
                           / max(steps, 1), probe_miss)
        miss_cap = probed_miss_cap(expected, caps[-1])
        ocap = probed_owner_cap(owner_max, caps[-1], kg) if kg > 1 else None
        log(f"staging: expected {expected:.0f} misses/step (probe max "
            f"{probe_miss}), miss_cap {miss_cap} (frontier cap {caps[-1]})"
            + (f"; owner cap {ocap} (probe max {owner_max}/owner, Kg={kg})"
               if mesh is not None else ""))
        if mesh is None:
            cache = FeatureCache.build(data.features, cost.feat_order,
                                       cost.feat_capacity, miss_cap=miss_cap,
                                       dtype=cache_dtype, device=device)
        else:
            cache = StripedFeatureCache.build(
                data.features, cost.feat_order, cost.feat_capacity, miss_cap,
                mesh, dtype=cache_dtype, device=device, owner_cap_rows=ocap)

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

    # ---- training (Run) ---------------------------------------------------
    def trainer(cache):
        # the pipeline's device stages are captured on a CUDA device; on a
        # group, on a NCCL one
        if mesh is None:
            return CachedTrainer(cfg, model, caps, graph, cache,
                                 pool=GraphPool(device))
        return StripedCachedTrainer(
            cfg, model, caps, graph, cache,
            pool=GraphPool(device) if captures_steps(device) else None)

    tr = trainer(cache)
    save = save_checkpoint if mesh is None else save_every_rank
    labels_all = np.asarray(data.labels)
    vlab, tlab = eval_labels(cfg)

    def eval_set(ids: np.ndarray) -> float:
        if not len(ids):
            return float("nan")
        s, c, lab = rank_eval(shard_node_set(ids, n), b,
                              cfg.sampler.eval_batch_size, rank, labels_all)
        return tr.eval_epoch(model, s, c, lab, generator=torch.Generator(
            device=device).manual_seed(rank_seed(4242, rank)))

    history = []
    # the profiled epoch: the first one whose stages were captured before
    profiled = (min(state.epoch + 1, cfg.train.epochs - 1) if mesh is None
                else None)
    for epoch in range(state.epoch, cfg.train.epochs):
        s = seeds_of_epoch(cfg.train.seed, epoch, shards, plan)[rank]
        with (trace.profiled(cfg.train, epoch, device) if epoch == profiled
              else contextlib.nullcontext()):
            r = tr.run_epoch(state, s, labels_all[s])
        state = r.pop("state")
        r.update(caps=list(caps), miss_cap=miss_cap, owner_cap=ocap,
                 presample_s=presample_s)
        if r["staging_overflow"] > 0 and miss_cap < caps[-1]:
            # grow staging past the worst observed per-step need (on a
            # group, the group's overflow, so every rank grows alike); the
            # overflowed rows of the epoch just run read as zeros
            miss_cap = grown_miss_cap(miss_cap, r["staging_overflow"],
                                      r["steps"], caps[-1])
            log(f"staging overflow -> growing miss_cap to {miss_cap}")
            if mesh is None:
                cache = FeatureCache(cache.hot_ids, cache.rows,
                                     cache.host_features, miss_cap)
            else:
                cache = StripedFeatureCache(
                    cache.hot_ids, cache.rows, cache.host_features, miss_cap,
                    cache.group, cache.owner_cap_rows)
            # the old stages' graphs go; the new staging is captured anew
            tr.release()
            tr = trainer(cache)
        r["epoch"] = epoch
        r["valid"] = eval_set(np.asarray(data.valid_ids))
        state.epoch = epoch + 1
        history.append(r)
        log(f"Epoch:{epoch}, Cost:{r['seconds']:.3f} s, "
            f"Loss:{r['loss']:.4f}, hit:{r['cache_hit_rate']:.3f}, "
            f"host_gb:{r['host_gb']:.3f}, {vlab}: {r['valid']:.4f}"
            + (f" [STAGING OVERFLOW {r['staging_overflow']} rows]"
               if r["staging_overflow"] else "")
            + (f" [EXCHANGE OVERFLOW {r['exchange_overflow']} hits demoted]"
               if r.get("exchange_overflow") else ""))
        if cfg.train.checkpoint_dir:
            save(cfg.train.checkpoint_dir, state)
    test_acc = eval_set(np.asarray(data.test_ids))
    log(f"{tlab}: {test_acc:.4f}")
    res = {"state": state, "history": history, "cost": cost,
           "test_acc": test_acc}
    if mesh is not None:
        res.update(trainer=tr, mesh=mesh.shape)
    return res


def cached_rank(device: torch.device, cfg_json: str, load: Callable,
                load_kwargs: Dict) -> None:
    """A rank's whole run on the mesh of ``cache.group_size``-rank cache
    groups, as ``parallel.mesh.spawn`` calls it (see
    ``parallel.trainer.fit_rank``)."""
    cfg = Config.from_json(cfg_json)
    data = load(**load_kwargs)
    run_cached_training(cfg, data, device,
                        mesh=make_mesh(cfg.cache.group_size))
