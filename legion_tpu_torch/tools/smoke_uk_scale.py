"""The uk-union class at full size: a host CSR past edge 2^31 through the
hybrid driver on one card (counterpart of ``tools/smoke_uk_scale.py``).

    python -m legion_tpu_torch.tools.smoke_uk_scale [steps=6] [--mesh]
    python -m legion_tpu_torch.tools.smoke_uk_scale --probe

from the repository root. The graph is the reference's: 133,633,040
nodes (uk-union's row count), average degree 41.3 (~5.52B edges), 32
features, 100 classes, seed 7, streamed with bounded RAM into
``.bench_cache/synth_uk_torch_*`` (``pa_cell.streamed_dataset``'s hashed
name; ~40 GB) and loaded by mmap, so the CSR stays in host memory and
every adjacency run past edge 2^31 is read there at int64 offsets.

``run_hybrid_training`` runs the reference's configuration (SAGE-256 bf16,
dropout 0.5, lr 0.003, fanout [25,10], batch 8000, eval batches of 8000,
host features and topology, budget 2 GiB, 3 presample steps) for two
epochs of ``steps`` steps each (``steps`` x 8000 + 1 train seeds: the
drop-last rule takes (n - 1) // batch steps), valid and test trimmed to
8000 seeds each: epoch 0 holds the warm-ups, the captures and the first
touches of the mapped files (in a fresh checkout's first process also
the kernels' build), epoch 1 is the steady state. It prints one JSON
line: the generation, load and set-up seconds, the last epoch's ms/step
(epoch 0's as ``first_epoch_ms_per_step``), its hit rate, hot fraction,
host feature and topology GB (useful and copied), staging overflow, host
sampler seconds and loss, the peak host resident set, the peak device
memory and the card's name and power limit.

``--mesh`` runs the hybrid driver on a mesh, on the same graph with the
reference's mesh settings instead (fanouts (5, 4), batch 64, hidden 32,
float32, budget 256 MiB, 2 presample steps, cache group 2, one epoch of
two steps a rank): the reference ran it on a virtual CPU mesh; here two
gloo ranks share the card (``mesh.spawn(..., share_device=True)``).

``--probe`` measures what decides whether the full size fits a machine:
its RAM, the disk under ``.bench_cache``, its cores, whether an earlier
probe's marker survived there, whether that disk keeps a 64 MiB hole
unwritten (``scale.hole_bytes``), and the generator's rate at 1/8 of the
node count (the graph is deleted after).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from legion_tpu_torch.cache.hybrid import HybridTrainer
from legion_tpu_torch.config import (CacheConfig, Config, ModelConfig,
                                     SamplerConfig)
from legion_tpu_torch.data import format as data_format
from legion_tpu_torch.data import synthetic
from legion_tpu_torch.parallel import mesh
from legion_tpu_torch.tools import hybrid_cell, pa_cell, scale
from legion_tpu_torch.train.hybrid_driver import run_hybrid_training

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PREFIX = "synth_uk_torch_"
FULL_NODES = 133_633_040                    # uk-union's rows
NODES, AVG_DEG, CLASSES = FULL_NODES, 41.3, 100
EPOCHS, BUDGET = 2, 2 << 30
MESH_BATCH, MESH_RANKS, MESH_GROUP, MESH_STEPS = 64, 2, 2, 2
MESH_BUDGET = 256 << 20


def graph_args(steps: int) -> dict:
    batch = pa_cell.BATCH
    return dict(num_nodes=NODES, avg_degree=AVG_DEG, feature_dim=32,
                num_classes=CLASSES, seed=7,
                train_num=max(steps, 20) * batch, valid_num=2 * batch,
                test_num=2 * batch)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m legion_tpu_torch.tools.smoke_uk_scale",
        description="the uk-union class at full size through the hybrid "
                    "driver")
    p.add_argument("steps", nargs="?", type=int, default=6,
                   help="training steps of each epoch")
    p.add_argument("--mesh", action="store_true",
                   help="the hybrid driver on a two-rank mesh instead")
    p.add_argument("--probe", action="store_true",
                   help="the machine's RAM, disk, cores and generator rate")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--root", default=ROOT,
                   help="the directory whose .bench_cache/ holds the graph")
    return p.parse_args(argv)


def dataset(root: str, steps: int = 6, log=print):
    """(data, seconds generating, seconds loading) of the full-size graph
    for runs of up to ``max(steps, 20)`` steps, generated into
    ``<root>/.bench_cache/`` on first use."""
    return pa_cell.streamed_dataset(root, PREFIX, graph_args(steps), log)


def config(epochs: int = EPOCHS) -> Config:
    return hybrid_cell.config(epochs=epochs, budget=BUDGET,
                              num_classes=CLASSES)


def mesh_config() -> Config:
    cfg = config(epochs=1)
    return dataclasses.replace(
        cfg,
        sampler=SamplerConfig(fanouts=(5, 4), batch_size=MESH_BATCH,
                              eval_batch_size=MESH_BATCH, dedup_last=True),
        model=ModelConfig(arch="sage", hidden_dim=32, num_layers=2,
                          dtype="float32"),
        cache=CacheConfig(enabled=True, budget_bytes=MESH_BUDGET,
                          presample_steps=2, group_size=MESH_GROUP))


def _mesh_rank(device, cfg_json: str, path: str, out_dir: str) -> None:
    cfg = Config.from_json(cfg_json)
    data = scale.trim(data_format.load_dataset(path, mmap=True), None,
                      MESH_RANKS * MESH_BATCH)
    # MESH_STEPS steps on every rank: each rank's shard (id % ranks) gets
    # MESH_STEPS x batch + 1 ids (the drop-last rule)
    ids = data.train_ids
    data.train_ids = np.concatenate([
        ids[ids % MESH_RANKS == r][: MESH_STEPS * MESH_BATCH + 1]
        for r in range(MESH_RANKS)])
    t0 = time.perf_counter()
    res = run_hybrid_training(cfg, data, device,
                              mesh=mesh.make_mesh(cfg.cache.group_size),
                              log=lambda s: None)
    tr = res["trainer"]
    scale.shares(tr.host_indices, data.indices, "the host CSR's indices")
    h = res["history"][-1]
    out = {"run_s": time.perf_counter() - t0, "loss": h["loss"],
           "losses": h["losses"], "steps": h["steps"],
           "topo_hot_fraction": h["topo_hot_fraction"],
           "feat_hit_rate": h["feat_hit_rate"],
           "exchange_overflow": h["exchange_overflow"],
           "staging_overflow": h["staging_overflow"],
           "host_topo_gb": h["host_topo_gb"], "valid": h["valid"],
           "test_acc": res["test_acc"], "mesh": res["mesh"],
           "topo_capacity": res["cost"].topo_capacity,
           "feat_capacity": res["cost"].feat_capacity,
           "stripe_edges": int(tr.topo.sub_indptr[-1])}
    with open(os.path.join(out_dir, f"rank{torch.distributed.get_rank()}"
                           ".json"), "w") as f:
        json.dump(out, f)


def run_mesh(args, data, path: str) -> dict:
    """Two ranks of the hybrid driver on a mesh, each loading the graph by
    mmap; on the card both share it over gloo."""
    cfg = mesh_config()
    with tempfile.TemporaryDirectory() as d:
        mesh.spawn(_mesh_rank, MESH_RANKS, args.device,
                   args=(cfg.to_json(), path, d),
                   threads=None if args.device == "cuda" else 1,
                   share_device=args.device == "cuda")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return {"mode": "mesh", "ranks": ranks,
            "config": {"fanouts": list(cfg.sampler.fanouts),
                       "batch": MESH_BATCH, "hidden": 32,
                       "dtype": "float32", "budget_bytes": MESH_BUDGET,
                       "group_size": MESH_GROUP, "ranks": MESH_RANKS}}


def run_single(args, data) -> dict:
    device = scale.device_of(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    data = scale.trim(data, args.steps * pa_cell.BATCH + 1, pa_cell.BATCH)
    t_run = time.perf_counter()
    with scale.first_epoch_clock(HybridTrainer) as clock:
        res = run_hybrid_training(config(), data, device, log=print)
    run_s = time.perf_counter() - t_run
    tr = res["trainer"]
    scale.shares(tr.host_indices, data.indices, "the host CSR's indices")
    scale.shares(tr.fcache.host_features, data.features,
                 "the feature cache's host table")
    first, h = res["history"][0], res["history"][-1]
    return {
        "mode": "single", "budget_bytes": BUDGET,
        "setup_s": clock["at"] - t_run, "run_s": run_s,
        "presample_s": h["presample_s"], "epochs": len(res["history"]),
        "steps": h["steps"],
        "ms_per_step": 1e3 * h["seconds"] / h["steps"],
        "first_epoch_ms_per_step": 1e3 * first["seconds"] / first["steps"],
        "edges_per_s": h["edges_per_s"],
        "hit_rate": h["feat_hit_rate"],
        "hot_fraction": h["topo_hot_fraction"],
        "host_gb": h["host_feat_gb"], "host_topo_gb": h["host_topo_gb"],
        "host_topo_copied_gb": h["host_topo_copied_gb"],
        "staging_overflow": h["staging_overflow"],
        "host_sample_s": h["host_sample_s"], "fetch_s": h["fetch_s"],
        "stage_s": h["stage_s"], "fetches": h["fetches"],
        "alpha": res["cost"].alpha,
        "feat_capacity": res["cost"].feat_capacity,
        "topo_capacity": res["cost"].topo_capacity,
        "sub_csr_edges": int(tr.topo.sub_indptr[-1]),
        "caps": h["caps"], "miss_cap": h["miss_cap"],
        "loss": h["loss"], "losses": h["losses"], "valid_acc": h["valid"],
        "test_acc": res["test_acc"],
        "max_memory_allocated_gb": (torch.cuda.max_memory_allocated()
                                    / 2 ** 30 if device.type == "cuda"
                                    else None)}


def probe(args) -> dict:
    """The machine's facts and the generator's rate at 1/8 of the nodes."""
    cache = os.path.join(args.root, ".bench_cache")
    facts = scale.disk_facts(cache)
    marker = os.path.join(cache, "probe_marker")
    facts["marker_survived"] = os.path.exists(marker)
    with open(marker, "w") as f:
        f.write(str(time.time()))
    n = NODES // 8
    kw = graph_args(args.steps)
    kw.update(num_nodes=n, **{k: min(kw[k], n // 4) for k in (
        "train_num", "valid_num", "test_num")})
    path = os.path.join(cache, "uk_probe.tmp")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    synthetic.streaming_power_law_graph(path, log=lambda s: None, **kw)
    gen_s = time.perf_counter() - t0
    with open(os.path.join(path, "meta.json")) as f:
        edges = json.load(f)["num_edges"]
    written = sum(os.path.getsize(os.path.join(path, n))
                  for n in os.listdir(path))
    shutil.rmtree(path)
    facts["hole_probe_bytes"] = scale.HOLE_PROBE
    facts["hole_allocated_bytes"] = scale.hole_bytes(cache)
    facts["keeps_holes"] = facts["hole_allocated_bytes"] < scale.HOLE_PROBE
    full_edges = edges * 8
    return {"mode": "probe", **facts, "probe_nodes": kw["num_nodes"],
            "probe_edges": edges, "probe_gen_s": gen_s,
            "edges_per_s": edges / gen_s,
            "probe_bytes": written, "full_bytes_estimate": written * 8,
            "full_gen_s_estimate": full_edges / (edges / gen_s)}


def main(argv=None) -> dict:
    args = parse(argv)

    def go():
        if args.probe:
            return probe(args)
        scale.device_of(args.device)
        t0 = time.perf_counter()
        data, gen_s, load_s = dataset(args.root, args.steps)
        if NODES == FULL_NODES and data.num_edges <= 1 << 31:
            raise RuntimeError(f"{data.num_edges} edges: the host CSR must "
                               "pass 2^31")
        head = {"nodes": data.num_nodes, "edges": data.num_edges,
                "features": data.feature_dim, "gen_s": gen_s,
                "load_s": load_s}
        out = (run_mesh(args, data, pa_cell.streamed_dir(
            args.root, PREFIX, graph_args(args.steps))) if args.mesh
            else run_single(args, data))
        return {**head, **out, "total_s": time.perf_counter() - t0}

    out, peak = scale.with_peak_rss(go)
    out.update(tool="smoke_uk_scale", device=args.device,
               nvidia_smi=scale.card_line(), peak_host_rss_gb=peak)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
