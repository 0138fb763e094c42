"""Data-parallel hybrid-placement training over cache groups: the CSR and
the features in host memory, the hot sub-CSR and the hot feature rows
striped over each cache group (port of
``legion_tpu/train/striped_hybrid_driver.py``).

The uk2014 / clueweb class of placement on every rank at once
(``src/Server.cu:116-133``, ``src/Kernels.cu:387-397``,
``src/GPUCache.cu:88-141``): Initialize -> PreSc (host) -> cost model ->
striped cache fill -> Run, with validation every epoch, a test pass at the
end, and checkpoint and resume. Every rank runs this driver and does the
same host presample over every rank's stream, so each reaches the same
cost model, caps and hot sets without a collective; each then builds only
its own stripes. The cost model sees both caches as cacheable here, over
the group's budget (``group_size`` x a device's).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from legion_tpu_torch.cache.cost_model import solve_cost_model
from legion_tpu_torch.cache.feature_cache import cache_dtype_for
from legion_tpu_torch.cache.hotness import host_frontier_probe, observed_caps
from legion_tpu_torch.cache.striped import (StripedFeatureCache,
                                            StripedTopoCache)
from legion_tpu_torch.cache.striped_hybrid import StripedHybridTrainer
from legion_tpu_torch.config import Config
from legion_tpu_torch.data.format import GraphData
from legion_tpu_torch.models import build_model
from legion_tpu_torch.parallel.dp import save_every_rank
from legion_tpu_torch.parallel.feature_exchange import probed_owner_cap
from legion_tpu_torch.parallel.mesh import Mesh, captures_steps, make_mesh
from legion_tpu_torch.parallel.trainer import _quiet
from legion_tpu_torch.sampling.seeds import (epoch_train_seeds,
                                             make_seed_plan, shard_node_set)
from legion_tpu_torch.train.hybrid_driver import presample_hotness_host
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.train.loop import rank_seed
from legion_tpu_torch.train.striped_driver import rank_eval
from legion_tpu_torch.train.train_state import (create_train_state,
                                                restore_checkpoint)
from legion_tpu_torch.utils import trace
from legion_tpu_torch.utils.logging import eval_labels


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


def run_striped_hybrid_training(cfg: Config, data: GraphData,
                                device: torch.device | str,
                                mesh: Optional[Mesh] = None,
                                log: Callable[[str], None] = print) -> Dict:
    """Initialize -> PreSc (host) -> Run for the host-topology placement in
    this rank of the initialized process group (``mesh`` defaults to
    ``make_mesh(cfg.cache.group_size)``). Returns {"state", "history",
    "cost", "trainer", "test_acc", "mesh"}; a history record is
    ``StripedHybridTrainer.run_epoch``'s plus the epoch, its validation
    figure, the caps, the staging capacity, the owner caps and the
    presample's seconds. The staging capacity is the reference's fixed
    formula (neither probed nor grown). Rank 0 logs."""
    mesh = mesh if mesh is not None else make_mesh(cfg.cache.group_size)
    n, kg, rank = mesh.world, mesh.cache, mesh.rank
    if rank != 0:
        log = _quiet
    device = torch.device(device)
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

    # ---- cost model: one group budget split between the two caches --------
    cache_dtype, row_bytes = cache_dtype_for(cfg.model.dtype,
                                             data.feature_dim)
    with trace.span("setup.cost_model"):
        cost = solve_cost_model(
            node_hot, edge_hot, data.degrees(), cfg.cache.budget_bytes,
            feat_row_bytes=row_bytes, group_size=kg,
            granularity=cfg.cache.cost_model_granularity)
    log(f"cost model: alpha={cost.alpha:.2f} feat_cap={cost.feat_capacity} "
        f"topo_cap={cost.topo_capacity} (x{kg} ranks/group)")
    caps = observed_caps(max_per_hop, cfg.sampler.observed_cap_slack)
    # the reference's fixed staging capacity
    miss_cap = int(min(caps[-1], (caps[-1] // 16 + 1024 + 127) // 128 * 128))

    # the exchanges' owner caps from a host probe of rank 0's first two
    # batches (the probe-free caps on a one-rank group)
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
        topo = StripedTopoCache.build(indptr, indices, cost.topo_order,
                                      cost.topo_capacity, mesh, device)
        fcache = StripedFeatureCache.build(
            data.features, cost.feat_order, cost.feat_capacity, miss_cap,
            mesh, dtype=cache_dtype, device=device, owner_cap_rows=ocap_feat)

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
    tr = StripedHybridTrainer(cfg, model, caps, topo, indptr, indices, fcache,
                              mesh, topo_owner_caps=tcaps,
                              pool=GraphPool(device)
                              if captures_steps(device) else None)
    labels_all = np.asarray(data.labels)
    vlab, tlab = eval_labels(cfg)

    def eval_set(ids: np.ndarray) -> float:
        if not len(ids):
            return float("nan")
        s, c, lab = rank_eval(shard_node_set(ids, n), b,
                              cfg.sampler.eval_batch_size, rank, labels_all)
        return tr.eval_epoch(model, s, c, lab)

    history = []
    for epoch in range(state.epoch, cfg.train.epochs):
        ep_rng = np.random.default_rng(cfg.train.seed * 100003 + epoch)
        s, _ = epoch_train_seeds(ep_rng, shards, plan)     # (n, steps, b)
        r = tr.run_epoch(state, s[rank], labels_all[s[rank]], epoch)
        state = r.pop("state")
        r.update(caps=list(caps), miss_cap=miss_cap, presample_s=presample_s,
                 topo_owner_caps=tcaps, feat_owner_cap=ocap_feat)
        r["epoch"] = epoch
        r["valid"] = eval_set(np.asarray(data.valid_ids))
        state.epoch = epoch + 1
        history.append(r)
        log(f"Epoch:{epoch}, Cost:{r['seconds']:.3f} s, "
            f"Loss:{r['loss']:.4f}, feat_hit:{r['feat_hit_rate']:.3f}, "
            f"topo_hot:{r['topo_hot_fraction']:.3f}, {vlab}: {r['valid']:.4f}"
            + (f" [STAGING OVERFLOW {r['staging_overflow']} rows]"
               if r["staging_overflow"] else "")
            + (f" [EXCHANGE OVERFLOW {r['exchange_overflow']} hits demoted]"
               if r["exchange_overflow"] else ""))
        if cfg.train.checkpoint_dir:
            save_every_rank(cfg.train.checkpoint_dir, state)
    test_acc = eval_set(np.asarray(data.test_ids))
    log(f"{tlab}: {test_acc:.4f}")
    return {"state": state, "history": history, "cost": cost, "trainer": tr,
            "test_acc": test_acc, "mesh": mesh.shape}


def striped_hybrid_rank(device: torch.device, cfg_json: str, load: Callable,
                        load_kwargs: Dict) -> None:
    """A rank's whole run, as ``parallel.mesh.spawn`` calls it (see
    ``parallel.trainer.fit_rank``)."""
    run_striped_hybrid_training(Config.from_json(cfg_json),
                                load(**load_kwargs), device)
