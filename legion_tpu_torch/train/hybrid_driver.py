"""Hybrid-placement training driver: the CSR in host memory, a hot sub-CSR
on the device, host features behind a ``FeatureCache`` (port of
``legion_tpu/train/hybrid_driver.py``).

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
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from legion_tpu_torch import runtime
from legion_tpu_torch.cache.cost_model import solve_cost_model
from legion_tpu_torch.cache.feature_cache import FeatureCache, cache_dtype_for
from legion_tpu_torch.cache.hotness import observed_caps
from legion_tpu_torch.cache.hybrid import HybridSampler, HybridTrainer
from legion_tpu_torch.cache.topo_cache import TopoCache
from legion_tpu_torch.config import Config
from legion_tpu_torch.data.format import GraphData
from legion_tpu_torch.models import build_model
from legion_tpu_torch.sampling.seeds import (epoch_eval_seeds,
                                             epoch_train_seeds,
                                             make_seed_plan, shard_node_set)
from legion_tpu_torch.train.graphed import GraphPool
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


def run_hybrid_training(cfg: Config, data: GraphData,
                        device: torch.device | str, log=print) -> Dict:
    """Initialize -> PreSc (on the host) -> Run for the host-topology
    placement on ``device``. Returns {"state", "history", "cost",
    "sampler", "trainer", "test_acc"}; each history record is
    ``HybridTrainer.run_epoch``'s plus the epoch, its validation figure
    (accuracy, or the LP loss for ``lp_sage``), the caps, the staging
    capacity and the presample's seconds. With ``train.checkpoint_dir``
    set it resumes from that directory's latest checkpoint, saves after
    every epoch and, with ``train.checkpoint_every_steps``, within one.
    As the reference's driver, it reads neither placement, nor
    ``CacheConfig.enabled``, nor ``train.profile_dir``: the topology and
    the features stay in host memory here, and a zero budget gives two
    empty caches (every hop and every feature row is served from the
    host)."""
    device = torch.device(device)
    # int64 offsets and int32 ids as they are loaded: nothing is copied,
    # and the CSR never goes to the device whole
    indptr = np.ascontiguousarray(np.asarray(data.indptr), np.int64)
    indices = np.ascontiguousarray(np.asarray(data.indices), np.int32)
    num_classes = cfg.dataset.num_classes or data.num_classes
    b = cfg.sampler.batch_size
    fanouts = tuple(cfg.sampler.fanouts)

    shards = shard_node_set(np.asarray(data.train_ids), 1)
    plan = make_seed_plan([len(shards[0])], [max(len(data.valid_ids), 1)],
                          [max(len(data.test_ids), 1)], b,
                          cfg.sampler.eval_batch_size)
    rng = np.random.default_rng(cfg.train.seed)
    seeds, _ = epoch_train_seeds(rng, shards, plan)

    # ---- presampling (host CSR) -------------------------------------------
    with trace.span("setup.presample") as span:
        steps = cfg.cache.presample_steps or plan.train_steps
        node_hot, edge_hot, max_per_hop = presample_hotness_host(
            indptr, indices, seeds[0][:steps], fanouts, data.num_nodes,
            cfg.train.seed)
    presample_s = span.seconds
    log(f"host presampling: {steps} steps in {presample_s:.1f}s")

    # ---- cost model: one budget split between the two caches --------------
    cache_dtype, row_bytes = cache_dtype_for(cfg.model.dtype,
                                             data.feature_dim)
    with trace.span("setup.cost_model"):
        cost = solve_cost_model(
            node_hot, edge_hot, data.degrees(), cfg.cache.budget_bytes,
            feat_row_bytes=row_bytes, group_size=cfg.cache.group_size,
            granularity=cfg.cache.cost_model_granularity)
    log(f"cost model: alpha={cost.alpha:.2f} feat_cap={cost.feat_capacity} "
        f"topo_cap={cost.topo_capacity}")
    caps = observed_caps(max_per_hop, cfg.sampler.observed_cap_slack)

    # the reference's fixed staging capacity: it is neither probed nor
    # grown, so a step with more misses reads the rest as zero rows
    # (``staging_overflow`` counts them)
    miss_cap = int(min(caps[-1], (caps[-1] // 16 + 1024 + 127) // 128 * 128))
    with trace.span("setup.cache_build"):
        topo = TopoCache.build(indptr, indices, cost.topo_order,
                               cost.topo_capacity, device)
        cache = FeatureCache.build(data.features, cost.feat_order,
                                   cost.feat_capacity, miss_cap=miss_cap,
                                   dtype=cache_dtype, device=device)
    hs = HybridSampler(topo, indptr, indices, fanouts, caps)

    # ---- model/state ------------------------------------------------------
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

    # the pipeline's device stages are captured on a CUDA device
    tr = HybridTrainer(cfg, model, caps, topo, indptr, indices, cache,
                       pool=GraphPool(device))
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

    # ---- training ---------------------------------------------------------
    history = []
    for epoch in range(state.epoch, cfg.train.epochs):
        ep_rng = np.random.default_rng(cfg.train.seed * 100003 + epoch)
        s, _ = epoch_train_seeds(ep_rng, shards, plan)
        r = tr.run_epoch(state, s[0], labels_all[s[0]], epoch)
        state = r.pop("state")
        r.update(caps=list(caps), miss_cap=miss_cap, presample_s=presample_s)
        r["epoch"] = epoch
        r["valid"] = eval_set(np.asarray(data.valid_ids))
        state.epoch = epoch + 1
        history.append(r)
        log(f"Epoch:{epoch}, Cost:{r['seconds']:.3f} s, "
            f"Loss:{r['loss']:.4f}, feat_hit:{r['feat_hit_rate']:.3f}, "
            f"topo_hot:{r['topo_hot_fraction']:.3f}, "
            f"{vlab}: {r['valid']:.4f}"
            + (f" [STAGING OVERFLOW {r['staging_overflow']} rows]"
               if r["staging_overflow"] else ""))
        if cfg.train.checkpoint_dir:
            save_checkpoint(cfg.train.checkpoint_dir, state)
    test_acc = eval_set(np.asarray(data.test_ids))
    log(f"{tlab}: {test_acc:.4f}")
    return {"state": state, "history": history, "cost": cost,
            "sampler": hs, "trainer": tr, "test_acc": test_acc}
