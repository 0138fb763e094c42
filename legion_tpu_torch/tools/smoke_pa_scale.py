"""The papers100M class at full size, end to end on one card (counterpart
of ``tools/smoke_pa_scale.py``).

    python -m legion_tpu_torch.tools.smoke_pa_scale [steps=10] [--device cpu]

from the repository root. ``run_cached_training`` runs the reference's
configuration (``pa_cell.config``: SAGE-256 bf16, dropout 0.5, lr 0.003,
fanout [25,10], batch 8000, host-resident features, 6 presample steps)
at its full budget of 1 GiB on a streamed power-law graph of
ogbn-papers100M's 111,059,956 nodes, average degree 14 (~1.55B edges), 32
features and 172 classes, with the set sizes ``bench_graph``'s
``train_frac=0.002`` gives. Two epochs of ``steps`` steps each (``steps``
x 8000 + 1 train seeds: the drop-last rule takes (n - 1) // batch
steps), valid and test trimmed to 2 x 8000 seeds each: epoch 0 holds the
warm-ups, the captures and the first touches of the mapped files (in a
fresh checkout's first process also the kernels' build), epoch 1 is the
steady state.

The graph (~21 GB) is generated once, with bounded RAM, into
``.bench_cache/synth_pa_full_torch_*`` (``pa_cell.streamed_dataset``'s
hashed name) and loaded by mmap. The device CSR stays under 2^31 edges,
the sampler's contract in both packages, and the node ids pass 2^24.

It prints one JSON line: the generation, load and driver set-up seconds,
the last epoch's ms/step (epoch 0's as ``first_epoch_ms_per_step``),
hit rate, host GB and loss, the peak host resident set, the
peak device memory (``torch.cuda.max_memory_allocated``) and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from legion_tpu_torch.cache.pipeline import CachedTrainer
from legion_tpu_torch.tools import pa_cell, scale
from legion_tpu_torch.train.cached_driver import run_cached_training

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PREFIX = "synth_pa_full_torch_"
EPOCHS, BUDGET = 2, 1 << 30
GRAPH_ARGS = dict(num_nodes=pa_cell.FULL_NODES, avg_degree=14,
                  feature_dim=32, num_classes=pa_cell.CLASSES, seed=0,
                  train_num=222_119, valid_num=55_529, test_num=55_529)


def dataset(root: str, log=print):
    """(data, seconds generating, seconds loading) of the full-size graph,
    generated into ``<root>/.bench_cache/`` on first use."""
    return pa_cell.streamed_dataset(root, PREFIX, GRAPH_ARGS, log)


def config(epochs: int = EPOCHS):
    return pa_cell.config(epochs=epochs, budget=BUDGET)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m legion_tpu_torch.tools.smoke_pa_scale",
        description="the papers100M class at full size on one card")
    p.add_argument("steps", nargs="?", type=int, default=10,
                   help="training steps of each epoch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--root", default=ROOT,
                   help="the directory whose .bench_cache/ holds the graph")
    return p.parse_args(argv)


def run(args: argparse.Namespace, log=print) -> dict:
    device = scale.device_of(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data, gen_s, load_s = dataset(args.root, log)
    batch = pa_cell.BATCH
    data = scale.trim(data, args.steps * batch + 1, 2 * batch)
    if data.num_edges >= 1 << 31:
        raise RuntimeError(f"{data.num_edges} edges: the device CSR needs "
                           "fewer than 2^31")
    if GRAPH_ARGS["num_nodes"] >= 1 << 24 > data.num_nodes:
        raise RuntimeError(f"{data.num_nodes} nodes: ids must pass 2^24")
    t_run = time.perf_counter()
    with scale.first_epoch_clock(CachedTrainer) as clock:
        res = run_cached_training(config(), data, device, log=log)
    run_s = time.perf_counter() - t_run
    scale.shares(clock["trainer"].cache.host_features, data.features,
                 "the feature cache's host table")
    first, h = res["history"][0], res["history"][-1]
    return {
        "tool": "smoke_pa_scale", "device": str(device),
        "nvidia_smi": scale.card_line(),
        "nodes": data.num_nodes, "edges": data.num_edges,
        "features": data.feature_dim, "budget_bytes": BUDGET,
        "gen_s": gen_s, "load_s": load_s,
        "setup_s": clock["at"] - t_run, "run_s": run_s,
        "total_s": time.perf_counter() - t0,
        "presample_s": h["presample_s"], "epochs": len(res["history"]),
        "steps": h["steps"],
        "ms_per_step": 1e3 * h["seconds"] / h["steps"],
        "first_epoch_ms_per_step": 1e3 * first["seconds"] / first["steps"],
        "edges_per_s": h["edges_per_s"],
        "hit_rate": h["cache_hit_rate"], "host_gb": h["host_gb"],
        "staging_overflow": h["staging_overflow"],
        "feat_capacity": res["cost"].feat_capacity,
        "caps": h["caps"], "miss_cap": h["miss_cap"],
        "loss": h["loss"], "losses": h["losses"], "valid_acc": h["valid"],
        "test_acc": res["test_acc"],
        "max_memory_allocated_gb": (torch.cuda.max_memory_allocated()
                                    / 2 ** 30 if device.type == "cuda"
                                    else None)}


def main(argv=None) -> dict:
    args = parse(argv)
    out, peak = scale.with_peak_rss(lambda: run(args))
    out["peak_host_rss_gb"] = peak
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
