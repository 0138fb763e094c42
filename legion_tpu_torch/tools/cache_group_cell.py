"""The three cache-group paths at cache axis 2 against cache axis 1, on two
ranks of one machine: ``MeshTrainer`` on ``feature_placement="hbm_sharded"``,
``run_cached_training`` and ``run_hybrid_training`` on a mesh.

    python -m legion_tpu_torch.tools.cache_group_cell OUT.json
    python -m legion_tpu_torch.tools.cache_group_cell OUT.json --device cpu --small

Two ranks run each path twice with the same seeds: as data 2 x cache 1 and
as data 1 x cache 2, the per-device cache budget halved at cache 2 so that
the group's budget, and so the hot sets, stay the same. On a machine with
one card the ranks share it (``parallel.mesh``'s share-device mode: gloo,
every collective staged through host memory), which shows the behaviour
across ranks, not their speed. Each rank then builds the feature matrix of
one batch's frontier through both layouts of each path (and, for the hybrid
path, one hop's hot draws), checks they are bitwise equal, and counts the
bytes of one exchange against the closed forms of ``utils.comm``. Rank 0
writes one JSON object to OUT.json: per path and cache axis the losses,
validation figures and statistics, the comparisons, and the kernel launches
of each run (counted in rank 0).

The graph is the learning smoke's (``random_power_law_graph(50_000, 15,
100, 47)``, SAGE-256, fanout [25,10], batch 1024 a rank); ``--small``
cuts it to 3000 nodes, batch 128 and hidden 32 for a run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                     ModelConfig, ParallelConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.parallel import mesh
from legion_tpu_torch.parallel.feature_exchange import sharded_row_fetch_stats
from legion_tpu_torch.parallel.trainer import MeshTrainer
from legion_tpu_torch.sampling.sampler import sample_batch
from legion_tpu_torch.train.cached_driver import run_cached_training
from legion_tpu_torch.train.hybrid_driver import run_hybrid_training
from legion_tpu_torch.utils import comm

CLASSES = 47
FULL = dict(nodes=50_000, batch=1024, hidden=256)
SMALL = dict(nodes=3000, batch=128, hidden=32)


def graph(size: Dict):
    return random_power_law_graph(num_nodes=size["nodes"], avg_degree=15,
                                  feature_dim=100, num_classes=CLASSES,
                                  seed=0)


def configs(size: Dict, data, k: int) -> Dict[str, Config]:
    """Each path's config at cache axis k (the cache budgets per device:
    the group's over k)."""
    base = dict(
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=size["batch"],
                              dedup_last=True),
        model=ModelConfig(arch="sage", hidden_dim=size["hidden"],
                          num_layers=2),
        parallel=ParallelConfig(num_devices=2))
    feat_budget = data.num_nodes // 4 * data.feature_dim * 4
    hybrid_budget = (data.num_nodes // 4 * (data.feature_dim * 4 + 8)
                     + data.num_edges)
    return {
        "sharded": Config(dataset=DatasetConfig(
            num_classes=CLASSES, feature_placement="hbm_sharded"),
            train=TrainConfig(epochs=1), cache=CacheConfig(group_size=k),
            **base),
        "cached": Config(dataset=DatasetConfig(
            num_classes=CLASSES, feature_placement="host"),
            train=TrainConfig(epochs=2),
            cache=CacheConfig(enabled=True, budget_bytes=feat_budget // k,
                              group_size=k), **base),
        "hybrid": Config(dataset=DatasetConfig(
            num_classes=CLASSES, feature_placement="host",
            topology_placement="host"), train=TrainConfig(epochs=1),
            cache=CacheConfig(enabled=True, budget_bytes=hybrid_budget // k,
                              group_size=k), **base)}


def _launches():
    from legion_tpu_torch.train.graphed import COUNTED
    return COUNTED


def _reset():
    for fn in _launches():
        fn.launches = 0


def _read(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {fn.__name__: fn.launches for fn in _launches()}


def _one_batch(data, graph_d, cfg, caps, device):
    """One batch of rank-independent seeds at the path's caps."""
    b = cfg.sampler.batch_size
    ids = torch.from_numpy(np.asarray(data.train_ids[:b], np.int32)).to(
        device)
    return sample_batch(graph_d, ids, torch.tensor(b, dtype=torch.int32,
                                                   device=device),
                        torch.zeros_like(ids), cfg.sampler.fanouts, caps,
                        dedup_last=cfg.sampler.dedup_last,
                        generator=torch.Generator(device=device).manual_seed(
                            77))


def _history(h):
    keep = ("losses", "valid", "cache_hit_rate", "feat_hit_rate",
            "topo_hot_fraction", "staging_overflow", "exchange_overflow",
            "host_gb", "host_feat_gb", "host_topo_gb", "fetches", "steps",
            "seconds", "owner_cap", "topo_owner_caps", "feat_owner_cap",
            "miss_cap", "caps", "cap_overflow")
    return [{k: v for k, v in r.items() if k in keep} for r in h]


def run_rank(device: torch.device, out_path: str, small: bool) -> None:
    """One rank's whole run (``parallel.mesh.spawn`` calls it)."""
    size = SMALL if small else FULL
    rank = dist.get_rank()
    data = graph(size)
    out: Dict = {"launches": {}}
    meshes = {k: mesh.make_mesh(k) for k in (1, 2)}
    q = (lambda s: None)
    x_by_k: Dict = {"sharded": {}, "cached": {}, "hybrid": {},
                    "hot_draws": {}}
    bytes_by_k: Dict = {}

    for k in (1, 2):
        cfgs = configs(size, data, k)
        m = meshes[k]
        # MeshTrainer, the table striped over the cache group
        _reset()
        t0 = time.perf_counter()
        mt = MeshTrainer(cfgs["sharded"], data, device, mesh=m)
        rec = mt.train_one_epoch(0)
        valid = mt.evaluate("valid")
        out["launches"][f"sharded_k{k}"] = _read(device)
        out[f"sharded_k{k}"] = {"losses": rec["losses"], "valid": valid,
                                "cap_overflow": rec["cap_overflow"],
                                "stripe_rows": mt.features.shape[0],
                                "seconds": time.perf_counter() - t0}
        batch = _one_batch(data, mt.graph, cfgs["sharded"], mt.caps, device)
        comm.reset_counts()
        x_by_k["sharded"][k] = sharded_row_fetch_stats(
            mt.features, batch.frontier, m.group)[0].cpu()
        bytes_by_k[("sharded", k)] = (
            comm.read_counts(), comm.exact_exchange_bytes(
                batch.frontier.shape[0], k, mt.features.shape[1],
                mt.features.element_size()))
        del mt, batch

        # striped cached training
        _reset()
        res = run_cached_training(cfgs["cached"], data, device, mesh=m,
                                  log=q)
        out["launches"][f"cached_k{k}"] = _read(device)
        tr = res["trainer"]
        out[f"cached_k{k}"] = {"history": _history(res["history"]),
                               "test_acc": res["test_acc"],
                               "feat_capacity": res["cost"].feat_capacity}
        frontier = _one_batch(data, tr.graph, cfgs["cached"], tr.caps,
                              device).frontier
        x_by_k["cached"][k], bytes_by_k[("cached", k)] = _combine(
            tr.cache, frontier, device)
        del res, tr

        # striped hybrid training
        _reset()
        res = run_hybrid_training(cfgs["hybrid"], data, device, mesh=m,
                                  log=q)
        out["launches"][f"hybrid_k{k}"] = _read(device)
        tr = res["trainer"]
        out[f"hybrid_k{k}"] = {"history": _history(res["history"]),
                               "test_acc": res["test_acc"],
                               "alpha": res["cost"].alpha,
                               "topo_capacity": res["cost"].topo_capacity}
        # the cached batch's frontier through the hybrid feature cache, and
        # its first batch-size ids as one hop, each rank's own grid rows
        x_by_k["hybrid"][k], _ = _combine(tr.fcache, frontier, device)
        hop = frontier[: cfgs["hybrid"].sampler.batch_size]
        gens = [torch.Generator(device=device).manual_seed(500 + g)
                for g in range(m.data_rank * k, (m.data_rank + 1) * k)]
        grid = torch.cat([torch.rand((hop.shape[0], 10), generator=g,
                                     device=device) for g in gens])
        comm.reset_counts()
        draws, hit = tr.topo.sample_hot(hop, grid)
        bytes_by_k[("hybrid", k)] = (comm.read_counts(),
                                     comm.exact_exchange_bytes(
            hop.shape[0], k, 10, 4, payload=True))
        x_by_k["hot_draws"][k] = (draws.cpu(), hit.cpu())
        del res, tr

    out["x_equal"] = {p: bool(torch.equal(x_by_k[p][1], x_by_k[p][2]))
                      for p in ("sharded", "cached", "hybrid")}
    out["hot_draws_equal"] = all(
        torch.equal(a, b) for a, b in zip(x_by_k["hot_draws"][1],
                                          x_by_k["hot_draws"][2]))
    out["bytes"] = {f"{p}_k{k}": {"counted": c, "closed_form": w}
                    for (p, k), (c, w) in bytes_by_k.items()}
    out["rank"] = rank
    gathered = comm.all_gather_object(out)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"ranks": gathered, "size": size,
                       "device": str(device)}, f)


def _combine(cache, frontier, device):
    """(the frontier's feature matrix through ``cache`` on the host, (the
    bytes the exchange counted, the closed form's))."""
    plan = cache.plan(frontier)
    staged = cache.stage_to(device, plan.miss_ids.cpu().numpy())
    comm.reset_counts()
    x = cache.combine(plan, staged, frontier)
    want = comm.exact_exchange_bytes(
        frontier.shape[0], cache.group_size, cache.rows.shape[1],
        cache.rows.element_size(), cap=cache.owner_cap_rows)
    return x.cpu(), (comm.read_counts(), want)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("cache_group_cell")
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    share = args.device == "cuda" and torch.cuda.device_count() < 2
    mesh.spawn(run_rank, 2, args.device, args=(args.out, args.small),
               threads=1 if args.device == "cpu" else None,
               share_device=share)


if __name__ == "__main__":
    main()
