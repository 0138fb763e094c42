"""The edge-partitioned path at 2 ranks, its exact exchange held against
the psum exchange, and the same path at 1 rank, on the learning smoke's
graph.

    python -m legion_tpu_torch.tools.partition_cell OUT.json
    python -m legion_tpu_torch.tools.partition_cell OUT.json --device cpu --small

Two ranks run ``run_partitioned_training`` (SAGE-256 float32, fanout
[25,10], batch 1024 a rank, 2 epochs, the greedy partition); on a machine
with one card they share it (``parallel.mesh``'s share-device mode: gloo,
every collective staged through host memory), which shows the behaviour
across ranks, not their speed. The run's kernel launches are counted;
after it each rank trains one more epoch and evaluates once more with
the launches of each counted, then
samples one batch of its own seeds with one set of grids through the
exact and through the psum exchange: the draws and the feature matrices
must be bitwise equal, and the exact exchange's counted bytes are set
beside ``utils.comm``'s closed forms at the probed caps. Then one rank
runs the same in this process. OUT.json holds, per world size, rank 0's
view of every rank (losses, validation and test accuracy, caps, overflow,
launches, comparisons), the edge cut of the greedy partition beside
hash's, and the graph's size.

The graph is ``random_power_law_graph(50_000, 15, 100, 47)``; ``--small``
cuts it to 3000 nodes, batch 128 and hidden 32 for a run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                     ParallelConfig, SamplerConfig,
                                     TrainConfig)
from legion_tpu_torch.data.partition import edge_cut_fraction, partition_graph
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.parallel import launch
from legion_tpu_torch.parallel.multihost import HaloPath
from legion_tpu_torch.sampling.seeds import (epoch_train_seeds,
                                             make_seed_plan, shard_node_set)
from legion_tpu_torch.tools.cache_group_cell import _read, _reset
from legion_tpu_torch.train.loop import rank_seed
from legion_tpu_torch.train.partitioned_driver import (
    eval_chunks, run_partitioned_training)
from legion_tpu_torch.utils import comm

CLASSES = 47
FULL = dict(nodes=50_000, batch=1024, hidden=256)
SMALL = dict(nodes=3000, batch=128, hidden=32)


def graph(size: Dict):
    return random_power_law_graph(num_nodes=size["nodes"], avg_degree=15,
                                  feature_dim=100, num_classes=CLASSES,
                                  seed=0)


def config(size: Dict, world: int, halo: str = "exact") -> Config:
    return Config(
        dataset=DatasetConfig(num_classes=CLASSES),
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=size["batch"]),
        model=ModelConfig(arch="sage", hidden_dim=size["hidden"],
                          num_layers=2),
        train=TrainConfig(epochs=2),
        parallel=ParallelConfig(num_devices=world, halo_exchange=halo))


def _one_batch(path: HaloPath, shard, seeds, caps, fanouts, grids):
    """One batch of ``seeds`` through ``path``: (frontier, blocks' positions
    and masks, feature matrix), the counted bytes and the overflow."""
    dev = shard.owned_ids.device
    path.overflow.zero_()
    comm.reset_counts()
    batch = path.sampler(fanouts, caps)(
        shard, seeds, torch.tensor(seeds.shape[0], dtype=torch.int32,
                                   device=dev),
        torch.zeros_like(seeds), None, grids)
    x = path.fetch(shard.feat_rows, batch.frontier)
    counted = comm.read_counts()
    parts = [batch.frontier] + [t for b in batch.blocks
                                for t in (b.nbr_pos, b.nbr_mask)]
    return [t.cpu() for t in parts], x.cpu(), counted, int(path.overflow)


def run_rank(device: torch.device, out_path: str, small: bool) -> None:
    """One rank's whole run (``parallel.launch.run_ranks`` calls it)."""
    size = SMALL if small else FULL
    rank, world = dist.get_rank(), dist.get_world_size()
    data = graph(size)
    cfg = config(size, world)
    fanouts = tuple(cfg.sampler.fanouts)
    _reset()
    t0 = time.perf_counter()
    res = run_partitioned_training(cfg, data, device, log=lambda s: None)
    run_s = time.perf_counter() - t0
    run_launches = _read(device)
    tr, state, part = res["trainer"], res["state"], res["partition"]
    out: Dict = {"rank": rank, "run_s": run_s, "run_launches": run_launches,
                 "dist_caps": list(res["dist_caps"]), "caps": list(tr.caps),
                 "setup_s": res["setup_s"], "test_acc": res["test_acc"],
                 "history": [{k: h[k] for k in (
                     "losses", "valid", "halo_overflow", "cap_overflow",
                     "edges", "steps", "seconds")} for h in res["history"]]}

    # one more epoch and one evaluation, their launches counted
    shards = shard_node_set(np.asarray(data.train_ids), world, part)
    plan = make_seed_plan([len(s) for s in shards], [1] * world,
                          [1] * world, cfg.sampler.batch_size,
                          cfg.sampler.eval_batch_size)
    s, _ = epoch_train_seeds(np.random.default_rng(7), shards, plan)
    _reset()
    rec = tr.run_epoch(state, s[rank], np.asarray(data.labels)[s[rank]])
    out["train_launches"] = _read(device)
    out["train_steps"] = rec["steps"]
    out["extra_epoch_halo_overflow"] = rec["halo_overflow"]
    es, ec, steps_e = eval_chunks(np.asarray(data.valid_ids), part, world,
                                  cfg.sampler.eval_batch_size)
    lab = np.where(es[rank] >= 0,
                   np.asarray(data.labels)[np.clip(es[rank], 0, None)], -1)
    _reset()
    _, _, ov = tr.eval_counts(state.model, es[rank], ec[rank], lab,
                              torch.Generator(device=device).manual_seed(
                                  rank_seed(4321, rank)))
    out["eval_launches"] = _read(device)
    out["eval_steps"] = steps_e
    out["extra_eval_halo_overflow"] = ov

    # one batch through both exchanges, with the same grids
    path = tr.path
    psum = HaloPath(path.shard, path.owner_of, None)
    seeds = torch.from_numpy(shards[rank][:cfg.sampler.batch_size]).to(
        device)
    gen = torch.Generator(device=device).manual_seed(rank_seed(99, rank))
    grids = [torch.rand((world * c, f), generator=gen, device=device)
             for c, f in zip(tr.caps, fanouts)]
    ex = _one_batch(path, path.shard, seeds, tr.caps, fanouts, grids)
    ps = _one_batch(psum, path.shard, seeds, tr.caps, fanouts, grids)
    dcaps = res["dist_caps"]
    want = sum(comm.halo_exact_hop_bytes(dcaps, f)["collective-permute"]
               for f in fanouts) + comm.halo_exact_fetch_bytes(
                   dcaps, data.feature_dim)["collective-permute"]
    out["one_batch"] = {
        "draws_equal": all(torch.equal(a, b) for a, b in zip(ex[0], ps[0])),
        "x_equal": bool(torch.equal(ex[1], ps[1])),
        "num_frontier": int((ex[0][0] >= 0).sum()),
        "exact_bytes": ex[2], "closed_form_bytes": {
            "collective-permute": want} if world > 1 else {},
        "psum_bytes": ps[2], "overflow": ex[3]}
    gathered = comm.all_gather_object(out)
    if rank == 0:
        cut = {"greedy": res["edge_cut"], "hash": edge_cut_fraction(
            data, partition_graph(data, world, "hash"))}
        with open(out_path, "w") as f:
            json.dump({"world": world, "ranks": gathered, "edge_cut": cut,
                       "size": size, "device": str(device)}, f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("partition_cell")
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    share = args.device == "cuda" and torch.cuda.device_count() < 2
    threads = 1 if args.device == "cpu" else None
    runs = {}
    for world in (2, 1):
        part = f"{args.out}.world{world}"
        launch.run_ranks(run_rank, world, args.device,
                         (part, args.small), threads=threads,
                         share_device=share and world > 1)
        with open(part) as f:
            runs[f"world{world}"] = json.load(f)
        os.remove(part)
    with open(args.out, "w") as f:
        json.dump(runs, f)


if __name__ == "__main__":
    main()
