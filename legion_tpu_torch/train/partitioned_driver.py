"""Edge-partitioned training: the whole lifecycle on every rank of the
process group (port of ``legion_tpu/train/partitioned_driver.py``).

No rank holds the whole graph or feature table. Rank p takes partition p
of a k-way partition of the graph (the dataset's precomputed
``partition_<k>_bn`` where it has one, else ``partition_graph(...,
"greedy")``): its CSR rows, feature rows and train seeds. Every hop's
neighbors of other ranks' nodes are drawn by their owner and every remote
feature row is fetched from its owner (``parallel/halo.py``), gradients are
averaged over the ranks (``parallel/multihost.py``), and the lifecycle is
the reference's: epochs with a validation pass after each, a test pass at
the end, checkpoint and resume (rank 0 writes every rank's generator). On
a NCCL group the train and eval steps are captured as CUDA graphs and
replayed (``parallel.mesh.captures_steps``); under gloo they run eagerly.

The exact exchange's per-distance caps are probed on the host before
training, at the larger of the train and eval shapes, over random train
batches and over the exact chunks the eval schedule runs (one
``eval_schedule`` serves the probe and the eval). The frontier caps are
the loose ``frontier_caps`` (no frontier probe, as in the reference).
Requests past a per-distance cap read as zero rows or -1 draws and are
metered as ``halo_overflow`` in training and eval. The model is built at
the dataset's feature width, unpadded, as the reference builds it.

``partitioned_rank`` is a rank's body for ``parallel.launch.run_ranks``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from legion_tpu_torch.config import Config
from legion_tpu_torch.data.format import GraphData
from legion_tpu_torch.data.partition import edge_cut_fraction, partition_graph
from legion_tpu_torch.models import build_model, model_args
from legion_tpu_torch.parallel.dp import save_every_rank
from legion_tpu_torch.parallel.launch import put_shard_distributed
from legion_tpu_torch.parallel.mesh import Mesh, captures_steps
from legion_tpu_torch.parallel.multihost import (HaloPath, PartitionedTrainer,
                                                 owner_table, probe_dist_caps,
                                                 probe_dist_caps_batches)
from legion_tpu_torch.parallel.trainer import _quiet
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.seeds import (epoch_eval_seeds,
                                             make_seed_plan, seeds_of_epoch,
                                             shard_node_set)
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.train.loop import rank_seed
from legion_tpu_torch.train.train_state import (create_train_state,
                                                restore_checkpoint)
from legion_tpu_torch.utils import trace
from legion_tpu_torch.utils.logging import eval_labels, log_metrics


def eval_chunks(ids: np.ndarray, partition: np.ndarray, k: int, cap: int):
    """The eval schedule: each rank's share of ``ids`` by partition, in
    lockstep steps of at most ``cap`` seeds; the cap probe and the eval
    both read this one definition. Returns (seeds (k, steps, cap), counts
    (k, steps), steps)."""
    eshards = shard_node_set(ids, k, partition)
    mx = max(max(len(s) for s in eshards), 1)
    steps = (mx - 1) // cap + 1
    per = tuple((len(s) - 1) // steps + 1 if len(s) else 0 for s in eshards)
    seeds, counts = epoch_eval_seeds(eshards, steps, per, cap)
    return seeds, counts, steps


def run_partitioned_training(cfg: Config, data: GraphData,
                             device: torch.device | str,
                             mesh: Optional[Mesh] = None,
                             log: Callable[[str], None] = print) -> Dict:
    """Train ``cfg`` on ``data`` in this rank of the initialized process
    group, whose ranks are the k partitions (``mesh`` defaults to the
    whole group as one data axis). Returns {"state", "history",
    "test_acc", "edge_cut", "mesh", "dist_caps", "caps", "setup_s",
    "trainer", "partition"}; a history record holds the epoch's per-step
    losses (mean over the ranks), its edges, seconds, edges/s, halo
    overflow and validation figure. Rank 0 logs. The set-up's phases are
    the spans ``setup.partition``, ``setup.shard``, ``setup.probe`` and
    ``setup.owner`` of ``utils/trace.py`` (``setup_s``: their seconds),
    each epoch a ``train`` root (``seconds``: its time up to the record
    less its ``epoch.seeds``; the record carries its ``spans`` and
    ``counts``)."""
    if mesh is None:
        mesh = Mesh(data=dist.get_world_size(), cache=1,
                    rank=dist.get_rank())
    k, rank = mesh.world, mesh.rank
    if cfg.parallel.num_devices not in (0, 1, k):
        raise ValueError(
            f"ParallelConfig(num_devices={cfg.parallel.num_devices}) but the "
            f"process group has {k} ranks")
    if rank != 0:
        log = _quiet
    device = torch.device(device)
    b = cfg.sampler.batch_size
    fanouts = tuple(cfg.sampler.fanouts)
    num_classes = cfg.dataset.num_classes or data.num_classes

    # ---- partition and this rank's shard ---------------------------------
    setup = {}
    with trace.span("setup.partition") as span:
        if (data.partition is not None
                and int(np.asarray(data.partition).max()) + 1 == k):
            part = np.asarray(data.partition).astype(np.int32)
            log(f"using precomputed {k}-way partition from dataset")
        else:
            part = partition_graph(data, k, mode="greedy")
        cut = edge_cut_fraction(data, part)
    setup["partition_s"] = span.seconds
    with trace.span("setup.shard") as span:
        shard = put_shard_distributed(data.indptr, data.indices,
                                      data.features, part, k, rank, device)
    setup["shard_s"] = span.seconds
    log(f"partitioned {k} ways in "
        f"{setup['partition_s'] + setup['shard_s']:.1f}s, "
        f"edge cut {cut:.3f} (process {rank}/{k})")

    shards = shard_node_set(np.asarray(data.train_ids), k, part)
    plan = make_seed_plan([len(s) for s in shards],
                          [max(len(data.valid_ids), 1)] * k,
                          [max(len(data.test_ids), 1)] * k, b,
                          cfg.sampler.eval_batch_size)
    caps = frontier_caps(b, fanouts)
    eval_caps = frontier_caps(cfg.sampler.eval_batch_size, fanouts)

    def eval_schedule(ids: np.ndarray):
        return eval_chunks(ids, part, k, cfg.sampler.eval_batch_size)

    # ---- the exact exchange's per-distance caps --------------------------
    with trace.span("setup.probe") as span:
        dist_caps = None
        if cfg.parallel.halo_exchange == "exact":
            probe_b = max(b, cfg.sampler.eval_batch_size)
            probe_caps = (tuple(max(c, e) for c, e in zip(caps, eval_caps))
                          if probe_b > b else caps)
            dist_caps = ()
            if k > 1:           # one rank has no distance to probe
                cap_sets = [probe_dist_caps(
                    data.indptr, data.indices, part, shards, fanouts,
                    probe_caps, k, probe_b,
                    slack=cfg.parallel.halo_cap_slack,
                    probes=cfg.parallel.halo_probe_batches,
                    seed=cfg.train.seed)]
                for ids_e in (np.asarray(data.valid_ids),
                              np.asarray(data.test_ids)):
                    if not len(ids_e):
                        continue
                    seeds_e, _, steps_e = eval_schedule(ids_e)
                    cap_sets.append(probe_dist_caps_batches(
                        data.indptr, data.indices, part,
                        [(i, seeds_e[i, t]) for t in range(steps_e)
                         for i in range(k)],
                        fanouts, probe_caps, k,
                        slack=cfg.parallel.halo_cap_slack,
                        seed=cfg.train.seed))
                dist_caps = tuple(max(c) for c in zip(*cap_sets))
            log(f"halo exact exchange: per-distance caps {dist_caps} "
                f"(frontier cap {probe_caps[-1]}, slack "
                f"{cfg.parallel.halo_cap_slack})")
    setup["probe_s"] = span.seconds
    with trace.span("setup.owner") as span:
        owner = owner_table(part, device) if dist_caps is not None else None
    setup["owner_s"] = span.seconds

    # ---- model and state: the same weights on every rank -----------------
    model = build_model(**model_args(cfg.model, data.feature_dim,
                                     num_classes, cfg.train.seed)).to(device)
    state = create_train_state(model, cfg.train.learning_rate,
                               rank_seed(cfg.train.seed, rank), device)
    if (cfg.train.checkpoint_dir
            and restore_checkpoint(cfg.train.checkpoint_dir, state,
                                   rank=rank, world=k)):
        log(f"resumed from checkpoint at step {state.step}, "
            f"epoch {state.epoch}")

    # on a NCCL group the steps are captured, their train and eval graphs
    # in one pool; a restore above loaded in place, before any capture
    pool = GraphPool(device) if captures_steps(device) else None
    tr = PartitionedTrainer(cfg, model, HaloPath(shard, owner, dist_caps),
                            caps, eval_caps, pool)
    labels_all = np.asarray(data.labels)
    vlab, tlab = eval_labels(cfg)
    # one eval generator, reseeded at each evaluation (a captured eval
    # step replays on the generator it was captured with)
    eval_gen = torch.Generator(device=device)

    def eval_set(ids: np.ndarray, phase: str) -> float:
        if not len(ids):
            return float("nan")
        seeds_e, counts_e, _ = eval_schedule(ids)
        s = seeds_e[rank]
        lab = np.where(s >= 0, labels_all[np.clip(s, 0, None)], -1)
        c, n, ov = tr.eval_counts(
            model, s, counts_e[rank], lab,
            eval_gen.manual_seed(rank_seed(12345, rank)))
        if ov > 0:
            log_metrics({"event": "halo_overflow", "phase": phase,
                         "dropped_requests": ov,
                         "hint": "raise parallel.halo_cap_slack"})
        return c / max(n, 1.0)

    history = []
    for epoch in range(state.epoch, cfg.train.epochs):
        with trace.epoch("train") as root:
            with trace.span("epoch.prepare"), trace.span("epoch.seeds"):
                s = seeds_of_epoch(cfg.train.seed, epoch, shards,
                                   plan)                    # (k, steps, b)
            rec = tr.run_epoch(state, s[rank], labels_all[s[rank]])
            root.steps = rec["steps"]
            with trace.span("epoch.record"):
                if rec["halo_overflow"] > 0:
                    log_metrics({"event": "halo_overflow", "epoch": epoch,
                                 "dropped_requests": rec["halo_overflow"],
                                 "hint": "raise parallel.halo_cap_slack"})
                dt = root.elapsed() - trace.seconds(root.tally,
                                                    "epoch.seeds")
                rec.update(epoch=epoch, loss=rec["losses"][-1],
                           mean_loss=float(np.mean(rec["losses"])),
                           seconds=dt, edges_per_s=rec["edges"] / dt,
                           edge_cut=cut)
        rec["spans"], rec["counts"] = root.entry["spans"], root.entry["counts"]
        rec["valid"] = eval_set(np.asarray(data.valid_ids), "valid")
        state.epoch = epoch + 1
        history.append(rec)
        log(f"Epoch:{epoch}, Cost:{dt:.3f} s, Loss:{rec['loss']:.4f}, "
            f"{vlab}: {rec['valid']:.4f}, edges/s: "
            f"{rec['edges_per_s']:.3e} [{k}-way partitioned]")
        if cfg.train.checkpoint_dir:
            save_every_rank(cfg.train.checkpoint_dir, state)
    test_acc = eval_set(np.asarray(data.test_ids), "test")
    log(f"{tlab}: {test_acc:.4f}")
    return {"state": state, "history": history, "test_acc": test_acc,
            "edge_cut": cut, "mesh": {"data": k}, "dist_caps": dist_caps,
            "caps": caps, "setup_s": setup, "trainer": tr,
            "partition": part}


def partitioned_rank(device: torch.device, cfg_json: str, load: Callable,
                     load_kwargs: Dict) -> None:
    """A rank's whole run, as ``parallel.launch.run_ranks`` calls it (see
    ``parallel.trainer.fit_rank``)."""
    run_partitioned_training(Config.from_json(cfg_json), load(**load_kwargs),
                             device)
