"""Data-parallel cached training over cache groups: the reference's
lifecycle ``Initialize -> PreSc -> Run`` on every rank of the process group
(port of ``legion_tpu/train/striped_driver.py``).

The configuration the reference ships as "Legion": N GPU runners training
data-parallel (``src/Server.cu:116-133``) with the hot feature cache
striped over each NVLink clique (``src/GPUCache.cu:103-141``). Every rank
runs this driver: presampling over every rank's seed stream (each rank
does the same work, so each reaches the same hot set and caps without a
collective), the cost model over the group's budget (``group_size`` x a
device's), the striped cache of ``cache/striped.py``, and the pipeline of
``cache/striped_pipeline.py`` with validation every epoch, a test pass at
the end, and checkpoint and resume (rank 0 writes every rank's
generator). Rank r draws ``train.loop.rank_seed(seed, r)``'s stream, so
that on one rank this driver is ``run_cached_training``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from legion_tpu_torch.cache.cost_model import solve_cost_model
from legion_tpu_torch.cache.feature_cache import FeatureCache, cache_dtype_for
from legion_tpu_torch.cache.hotness import observed_caps, presample_hotness
from legion_tpu_torch.cache.striped import StripedFeatureCache
from legion_tpu_torch.cache.striped_pipeline import StripedCachedTrainer
from legion_tpu_torch.config import Config
from legion_tpu_torch.data.format import GraphData
from legion_tpu_torch.models import build_model
from legion_tpu_torch.parallel.dp import save_every_rank
from legion_tpu_torch.parallel.feature_exchange import (owner_counts,
                                                        probed_owner_cap)
from legion_tpu_torch.parallel.mesh import Mesh, captures_steps, make_mesh
from legion_tpu_torch.parallel.trainer import _quiet
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
from legion_tpu_torch.sampling.seeds import (epoch_eval_seeds,
                                             epoch_train_seeds,
                                             make_seed_plan, shard_node_set)
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.train.loop import rank_seed
from legion_tpu_torch.train.train_state import (create_train_state,
                                                restore_checkpoint)
from legion_tpu_torch.utils import trace
from legion_tpu_torch.utils.logging import eval_labels


def _round128(x) -> int:
    return (int(x) + 127) // 128 * 128


def rank_eval(shards, b: int, eval_batch_size: int, rank: int,
              labels_all: np.ndarray):
    """This rank's (seeds, counts, labels) of an eval set split over the
    ranks (``shards``), in the lockstep plan of the reference's striped
    drivers: as many steps as the longest shard needs, sampled at the
    train caps, short shards padded with -1."""
    per_lim = min(eval_batch_size, b)
    mx = max(max(len(s) for s in shards), 1)
    steps = (mx - 1) // per_lim + 1
    per = tuple((len(s) - 1) // steps + 1 if len(s) else 0 for s in shards)
    seeds, counts = epoch_eval_seeds(shards, steps, per, b)
    lab = np.where(seeds[rank] >= 0,
                   labels_all[np.clip(seeds[rank], 0, None)], -1)
    return seeds[rank], counts[rank], lab.astype(np.int32)


def run_striped_training(cfg: Config, data: GraphData,
                         device: torch.device | str,
                         mesh: Optional[Mesh] = None,
                         log: Callable[[str], None] = print) -> Dict:
    """Train ``cfg`` on ``data`` in this rank of the initialized process
    group, with host-resident features behind the hot cache striped over
    its cache group (``cache.group_size`` ranks; ``mesh`` defaults to
    ``make_mesh(cfg.cache.group_size)``). Returns {"state", "history",
    "cost", "trainer", "test_acc", "mesh"}; a history record is
    ``StripedCachedTrainer.run_epoch``'s (figures of every rank) plus the
    epoch, its validation figure, the caps, the staging capacity, the
    owner cap and the presample's seconds. Rank 0 logs."""
    if not cfg.cache.enabled:
        raise ValueError("run_striped_training keeps the features behind "
                         "the cache: it needs CacheConfig(enabled=True)")
    if cfg.dataset.topology_placement != "hbm":
        raise ValueError(
            "run_striped_training keeps the topology whole in device "
            "memory; topology_placement='host' runs through "
            "legion_tpu_torch.train.striped_hybrid_driver")
    mesh = mesh if mesh is not None else make_mesh(cfg.cache.group_size)
    n, kg, rank = mesh.world, mesh.cache, mesh.rank
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

    # ---- presampling (PreSc) over every rank's stream ----------------------
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

    # ---- cost model over the group's budget, striped cache -----------------
    cache_dtype, row_bytes = cache_dtype_for(cfg.model.dtype,
                                             data.feature_dim)
    # the topology is whole in device memory: the budget goes to features
    with trace.span("setup.cost_model"):
        cost = solve_cost_model(
            hot.node_hot.cpu().numpy().astype(np.int64),
            hot.edge_hot.cpu().numpy(), data.degrees(),
            cfg.cache.budget_bytes, feat_row_bytes=row_bytes, group_size=kg,
            granularity=cfg.cache.cost_model_granularity,
            topo_cacheable=False)
    log(f"cost model: alpha={cost.alpha:.2f} feat_cap={cost.feat_capacity} "
        f"(x{kg} ranks/group) topo_cap={cost.topo_capacity}")
    caps = observed_caps(hot.max_per_hop, cfg.sampler.observed_cap_slack)

    # Staging from an unbiased probe of two fresh batches against the built
    # hot set; the same probe's per-owner hit maxima size the exchange's
    # owner cap at ~1.05x what it saw (over-cap hits demote to staging).
    cached_ids = np.asarray(cost.feat_order[:cost.feat_capacity])
    hot_sorted = torch.from_numpy(np.sort(cached_ids.astype(np.int32))
                                  ).to(device)
    prng = np.random.default_rng(cfg.train.seed * 31 + 7)
    probe_miss = owner_max = 0
    with torch.no_grad():
        for i in range(2):
            ids_all = shards[i % len(shards)]
            sb = prng.permutation(ids_all)[:b].astype(np.int32)
            if len(sb) < b:
                sb = np.pad(sb, (0, b - len(sb)), constant_values=-1)
            batch = sample_batch(
                graph, torch.from_numpy(sb).to(device),
                torch.tensor(b, dtype=torch.int32, device=device),
                torch.zeros((b,), dtype=torch.int32, device=device),
                fanouts, caps, dedup_last=True,
                generator=torch.Generator(device=device).manual_seed(9000 + i))
            pl = FeatureCache.plan_ids(hot_sorted, batch.frontier, 128)
            probe_miss = max(probe_miss, int(pl.num_miss))
            owner_max = max(owner_max, int(owner_counts(
                torch.where(pl.hit, pl.slot, -1), max(kg, 1)).max()))
    miss_cap = int(min(caps[-1],
                       _round128(probe_miss * 1.5 + caps[-1] / 16 + 1024)))
    ocap = probed_owner_cap(owner_max, caps[-1], kg) if kg > 1 else None
    log(f"staging: probe max {probe_miss} misses/step, miss_cap {miss_cap}"
        f"/rank (frontier cap {caps[-1]}); owner cap {ocap} (probe max "
        f"{owner_max}/owner, Kg={kg})")
    with trace.span("setup.cache_build"):
        cache = StripedFeatureCache.build(data.features, cost.feat_order,
                                          cost.feat_capacity, miss_cap, mesh,
                                          dtype=cache_dtype, device=device,
                                          owner_cap_rows=ocap)

    # ---- model/state: the same weights on every rank -----------------------
    model = build_model(cfg.model.arch, data.feature_dim,
                        cfg.model.hidden_dim, num_classes,
                        cfg.model.num_layers, cfg.model.dropout,
                        dtype=cfg.model.dtype,
                        num_heads=cfg.model.num_heads,
                        generator=torch.Generator().manual_seed(
                            cfg.train.seed)).to(device)
    state = create_train_state(model, cfg.train.learning_rate,
                               rank_seed(cfg.train.seed, rank), device)
    if (cfg.train.checkpoint_dir
            and restore_checkpoint(cfg.train.checkpoint_dir, state,
                                   rank=rank, world=n)):
        log(f"resumed from checkpoint at step {state.step}, "
            f"epoch {state.epoch}")

    # ---- training (Run) ------------------------------------------------------
    # the pipeline's device stages are captured on a NCCL group
    capture = captures_steps(device)
    tr = StripedCachedTrainer(cfg, model, caps, graph, cache,
                              pool=GraphPool(device) if capture else None)
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
    for epoch in range(state.epoch, cfg.train.epochs):
        ep_rng = np.random.default_rng(cfg.train.seed * 100003 + epoch)
        s, _ = epoch_train_seeds(ep_rng, shards, plan)     # (n, steps, b)
        r = tr.run_epoch(state, s[rank], labels_all[s[rank]])
        state = r.pop("state")
        r.update(caps=list(caps), miss_cap=miss_cap, owner_cap=ocap,
                 presample_s=presample_s)
        if r["staging_overflow"] > 0 and miss_cap < caps[-1]:
            # grow staging past the worst observed per-step need (the
            # group's overflow, so every rank grows alike); the overflowed
            # rows of the epoch just run read as zeros
            need = miss_cap + r["staging_overflow"] / max(r["steps"], 1)
            miss_cap = int(min(caps[-1], _round128(need * 2.0)))
            log(f"staging overflow -> growing miss_cap to {miss_cap}")
            cache = StripedFeatureCache(cache.hot_ids, cache.rows,
                                        cache.host_features, miss_cap,
                                        cache.group, cache.owner_cap_rows)
            # the old stages' graphs go; the new staging is captured anew
            tr.release()
            tr = StripedCachedTrainer(
                cfg, model, caps, graph, cache,
                pool=GraphPool(device) if capture else None)
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
               if r["exchange_overflow"] else ""))
        if cfg.train.checkpoint_dir:
            save_every_rank(cfg.train.checkpoint_dir, state)
    test_acc = eval_set(np.asarray(data.test_ids))
    log(f"{tlab}: {test_acc:.4f}")
    return {"state": state, "history": history, "cost": cost,
            "trainer": tr, "test_acc": test_acc, "mesh": mesh.shape}


def striped_rank(device: torch.device, cfg_json: str, load: Callable,
                 load_kwargs: Dict) -> None:
    """A rank's whole run, as ``parallel.mesh.spawn`` calls it (see
    ``parallel.trainer.fit_rank``)."""
    run_striped_training(Config.from_json(cfg_json), load(**load_kwargs),
                         device)
