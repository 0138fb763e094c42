"""Cached-training driver: presampling epoch -> cost model -> cache build
-> pipelined training with eval (port of
``legion_tpu/train/cached_driver.py``).

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
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from legion_tpu_torch.cache.cost_model import solve_cost_model
from legion_tpu_torch.cache.feature_cache import FeatureCache, cache_dtype_for
from legion_tpu_torch.cache.hotness import observed_caps, presample_hotness
from legion_tpu_torch.cache.pipeline import CachedTrainer
from legion_tpu_torch.config import Config
from legion_tpu_torch.data.format import GraphData
from legion_tpu_torch.models import build_model
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
from legion_tpu_torch.sampling.seeds import (epoch_eval_seeds,
                                             epoch_train_seeds,
                                             make_seed_plan, shard_node_set)
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.train.train_state import (create_train_state,
                                                restore_checkpoint,
                                                save_checkpoint)
from legion_tpu_torch.utils import trace
from legion_tpu_torch.utils.logging import eval_labels


def _round128(x) -> int:
    return (int(x) + 127) // 128 * 128


def run_cached_training(cfg: Config, data: GraphData,
                        device: torch.device | str, log=print) -> Dict:
    """Train ``cfg`` on ``data`` with host-resident features behind the
    hot-row cache on ``device``. Returns {"state", "history", "cost",
    "test_acc"}; each history record is ``CachedTrainer.run_epoch``'s
    plus the epoch, its validation figure (accuracy, or the LP loss for
    ``lp_sage``), the caps, the staging capacity and the presample's
    seconds. With ``train.checkpoint_dir`` set it resumes from that
    directory's latest checkpoint, saves after every epoch and, with
    ``train.checkpoint_every_steps``, within an epoch. With
    ``train.profile_dir`` set, the first epoch it trains after the one
    that captures the pipeline's stages (the steady state; the only
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
    device = torch.device(device)
    graph = DeviceGraph.from_host(data.indptr, data.indices, device)
    num_classes = cfg.dataset.num_classes or data.num_classes
    b = cfg.sampler.batch_size
    fanouts = tuple(cfg.sampler.fanouts)
    loose_caps = frontier_caps(b, fanouts)

    shards = shard_node_set(np.asarray(data.train_ids), 1)
    valid_n = max(len(data.valid_ids), 1)
    test_n = max(len(data.test_ids), 1)
    plan = make_seed_plan([len(shards[0])], [valid_n], [test_n], b,
                          cfg.sampler.eval_batch_size)
    rng = np.random.default_rng(cfg.train.seed)
    seeds, _ = epoch_train_seeds(rng, shards, plan)

    # ---- presampling epoch (PreSc) ----------------------------------------
    with trace.span("setup.presample") as span:
        steps = cfg.cache.presample_steps or plan.train_steps
        hot = presample_hotness(
            graph, torch.from_numpy(seeds[0][:steps]).to(device),
            torch.full((steps,), b, dtype=torch.int32, device=device),
            fanouts, loose_caps, data.num_nodes,
            generator=torch.Generator(device=device).manual_seed(
                cfg.train.seed))
        max_frontier = int(hot.max_frontier)      # waits for the presample
    presample_s = span.seconds
    log(f"presampling: {steps} steps in {presample_s:.1f}s, "
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
            group_size=cfg.cache.group_size,
            granularity=cfg.cache.cost_model_granularity,
            topo_cacheable=False)
    log(f"cost model: alpha={cost.alpha:.2f} feat_cap={cost.feat_capacity} "
        f"topo_cap={cost.topo_capacity}")

    caps = observed_caps(hot.max_per_hop, cfg.sampler.observed_cap_slack)
    with trace.span("setup.cache_build"):
        # Staging is sized from the expected misses per step, not the
        # whole frontier: the presample's own estimate (biased low, since
        # the cache holds what the presample saw), corrected by an
        # unbiased probe of two fresh batches against the built hot set,
        # at 1.5x plus 1/16 of the frontier; an epoch that still overflows
        # grows it.
        cached_ids = np.asarray(cost.feat_order[:cost.feat_capacity])
        miss_per_step = ((node_hot.sum() - node_hot[cached_ids].sum())
                         / max(steps, 1))
        hot_sorted = torch.from_numpy(np.sort(cached_ids.astype(np.int32))
                                      ).to(device)
        prng = np.random.default_rng(cfg.train.seed * 31 + 7)
        ids_all = np.asarray(shards[0])
        probe_miss = 0
        with torch.no_grad():
            for i in range(2):
                sb = prng.permutation(ids_all)[:b].astype(np.int32)
                if len(sb) < b:
                    sb = np.pad(sb, (0, b - len(sb)), constant_values=-1)
                batch = sample_batch(
                    graph, torch.from_numpy(sb).to(device),
                    torch.tensor(b, dtype=torch.int32, device=device),
                    torch.zeros((b,), dtype=torch.int32, device=device),
                    fanouts, caps, dedup_last=True,
                    generator=torch.Generator(device=device).manual_seed(
                        9000 + i))
                probe_miss = max(probe_miss, int(FeatureCache.plan_ids(
                    hot_sorted, batch.frontier, 128).num_miss))
        miss_per_step = max(miss_per_step, probe_miss)
        miss_cap = int(min(caps[-1], _round128(
            miss_per_step * 1.5 + caps[-1] / 16 + 1024)))
        log(f"staging: expected {miss_per_step:.0f} misses/step "
            f"(probe max {probe_miss}), miss_cap {miss_cap} "
            f"(frontier cap {caps[-1]})")
        cache = FeatureCache.build(data.features, cost.feat_order,
                                   cost.feat_capacity, miss_cap=miss_cap,
                                   dtype=cache_dtype, device=device)

    # ---- model/state init -------------------------------------------------
    model = build_model(cfg.model.arch, data.feature_dim,
                        cfg.model.hidden_dim, num_classes,
                        cfg.model.num_layers, cfg.model.dropout,
                        dtype=cfg.model.dtype,
                        num_heads=cfg.model.num_heads,
                        generator=torch.Generator().manual_seed(
                            cfg.train.seed)).to(device)
    state = create_train_state(model, cfg.train.learning_rate,
                               cfg.train.seed, device)
    if (cfg.train.checkpoint_dir
            and restore_checkpoint(cfg.train.checkpoint_dir, state)):
        log(f"resumed from checkpoint at step {state.step}, "
            f"epoch {state.epoch}")

    # ---- training (Run) ---------------------------------------------------
    # the pipeline's device stages are captured on a CUDA device
    tr = CachedTrainer(cfg, model, caps, graph, cache, pool=GraphPool(device))
    history = []
    labels_all = np.asarray(data.labels)
    vlab, tlab = eval_labels(cfg)

    def eval_set(ids: np.ndarray) -> float:
        if not len(ids):
            return float("nan")
        # eval samples at the train caps, so a step holds at most
        # min(eval_batch_size, batch) seeds
        per_lim = min(cfg.sampler.eval_batch_size, b)
        n_steps = (len(ids) - 1) // per_lim + 1
        per = (len(ids) - 1) // n_steps + 1
        seeds_e, counts_e = epoch_eval_seeds([ids], n_steps, (per,), b)
        lab_e = np.where(seeds_e[0] >= 0,
                         labels_all[np.clip(seeds_e[0], 0, None)],
                         -1).astype(np.int32)
        return tr.eval_epoch(model, seeds_e[0], counts_e[0], lab_e)

    # the profiled epoch: the first one whose stages were captured before
    profiled = min(state.epoch + 1, cfg.train.epochs - 1)
    for epoch in range(state.epoch, cfg.train.epochs):
        ep_rng = np.random.default_rng(cfg.train.seed * 100003 + epoch)
        s, _ = epoch_train_seeds(ep_rng, shards, plan)
        with (trace.profiled(cfg.train, epoch, device) if epoch == profiled
              else contextlib.nullcontext()):
            r = tr.run_epoch(state, s[0], labels_all[s[0]])
        state = r.pop("state")
        r.update(caps=list(caps), miss_cap=miss_cap, presample_s=presample_s)
        if r["staging_overflow"] > 0 and miss_cap < caps[-1]:
            # grow staging past the worst observed per-step need; the
            # overflowed rows of the epoch just run read as zeros
            need = miss_cap + r["staging_overflow"] / max(r["steps"], 1)
            miss_cap = int(min(caps[-1], _round128(need * 2.0)))
            log(f"staging overflow -> growing miss_cap to {miss_cap}")
            cache = FeatureCache(cache.hot_ids, cache.rows,
                                 cache.host_features, miss_cap)
            # the old stages' graphs go; the new staging is captured anew
            tr.release()
            tr = CachedTrainer(cfg, model, caps, graph, cache,
                               pool=GraphPool(device))
        r["epoch"] = epoch
        r["valid"] = eval_set(np.asarray(data.valid_ids))
        state.epoch = epoch + 1
        history.append(r)
        log(f"Epoch:{epoch}, Cost:{r['seconds']:.3f} s, "
            f"Loss:{r['loss']:.4f}, hit:{r['cache_hit_rate']:.3f}, "
            f"host_gb:{r['host_gb']:.3f}, {vlab}: {r['valid']:.4f}"
            + (f" [STAGING OVERFLOW {r['staging_overflow']} rows]"
               if r["staging_overflow"] else ""))
        if cfg.train.checkpoint_dir:
            save_checkpoint(cfg.train.checkpoint_dir, state)
    test_acc = eval_set(np.asarray(data.test_ids))
    log(f"{tlab}: {test_acc:.4f}")
    return {"state": state, "history": history, "cost": cost,
            "test_acc": test_acc}
