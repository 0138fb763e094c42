"""Command line of the port (counterpart of ``train.py``): one command
builds the whole ``Config`` and runs the driver that config selects.

    python -m legion_tpu_torch.train --synthetic 50000 --epochs 2
    python -m legion_tpu_torch.train --dataset PR --data-dir /data/products
    python -m legion_tpu_torch.train --config run.json      # full Config JSON
    python -m legion_tpu_torch.train --device cpu --devices 2 --synthetic 3000

The flags are ``train.py``'s, with its names and defaults, plus
``--device {cuda,cpu}`` (default ``cuda``; nothing falls back to the CPU)
and GAT's ``--arch gat --num-heads N`` (``--hidden-dim`` is then a head's
width, and every hop is deduplicated).
It prints the config JSON before it trains, warns about every flag the
chosen driver cannot honour, and dispatches as ``train.py`` does: to
``Trainer``, ``run_cached_training``, ``run_hybrid_training``, or, with
``--devices`` other than 1, on that many ranks (one card each; gloo ranks
with ``--device cpu``; 0 = every card this process sees) to
``MeshTrainer`` (``--features hbm_sharded`` stripes the table over each
cache group of ``--cache-group`` ranks), ``run_cached_training`` (with
``--cache-budget-gb``) or ``run_hybrid_training`` (with ``--topology
host``), each given the mesh of ``--cache-group``-rank cache groups.
``--partitioned`` runs ``run_partitioned_training`` on ``--devices``
ranks (world size 1 in this process; under torchrun, on the ranks
torchrun started: ``parallel/launch.py``), with a dataset directory's
``partition_<devices>_bn`` where it has one.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from legion_tpu_torch.config import (DATASET_REGISTRY, CacheConfig, Config,
                                     DatasetConfig, ModelConfig,
                                     ParallelConfig, SamplerConfig,
                                     TrainConfig)
from legion_tpu_torch.data.format import load_dataset
from legion_tpu_torch.data.synthetic import random_power_law_graph

# the tuning flags whose explicit values --config ignores (train.py's list)
TUNING_FLAGS = ("arch", "num_heads", "hidden_dim", "dropout", "dtype",
                "fanouts", "batch_size", "lr", "epochs", "seed",
                "cache_budget_gb", "cache_group", "features", "topology",
                "halo_exchange", "halo_cap_slack", "checkpoint_dir",
                "profile_dir", "devices", "dataset", "data_dir", "synthetic")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("legion_tpu_torch trainer")
    ap.add_argument("--config", help="Config JSON file (overrides flags)")
    ap.add_argument("--dataset", default=None,
                    help="registry code (PR/PA/CO/UKS/UKL/CL/AX)")
    ap.add_argument("--data-dir", default=None, help="packed dataset dir")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate a synthetic graph with N nodes")
    ap.add_argument("--arch", default="sage",
                    choices=["sage", "gcn", "lp_sage", "gat"],
                    help="gat: PyG's GATConv stack (--hidden-dim is a "
                         "head's width; every hop deduplicated)")
    ap.add_argument("--num-heads", type=int, default=1,
                    help="attention heads (gat only)")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--fanouts", default="25,10")
    ap.add_argument("--hidden-dim", type=int, default=256)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=0.003)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--profile-dir", default=None,
                    help="trace an epoch with torch.profiler into DIR as "
                         "epoch_<n>.pt.trace.json, with the program's "
                         "spans on its host rows (device-memory Trainer: "
                         "epoch 0; cached driver: its first epoch after "
                         "the capturing one)")
    ap.add_argument("--cache-budget-gb", type=float, default=0.0,
                    help=">0 enables the hotness cache (host features)")
    ap.add_argument("--topology", default="hbm", choices=["hbm", "host"],
                    help="'host' = host CSR + device hot sub-CSR (hybrid "
                         "sampling; graphs beyond device memory)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks, one device each (0 = every card this "
                         "process sees; 1 = single-device drivers)")
    ap.add_argument("--cache-group", type=int, default=None,
                    help="cache group size Kg: ranks jointly holding one "
                         "striped hot-cache copy. Default: auto, the "
                         "largest divisor of the rank count that fits in "
                         "this host's cards")
    ap.add_argument("--features", default="hbm",
                    choices=["hbm", "hbm_sharded"],
                    help="multi-device feature placement: replicated per "
                         "device or row-striped over the cache axis")
    ap.add_argument("--partitioned", action="store_true",
                    help="edge-partitioned multi-host training with halo "
                         "exchange")
    ap.add_argument("--halo-exchange", default="exact",
                    choices=["exact", "psum"],
                    help="partitioned-path halo strategy")
    ap.add_argument("--halo-cap-slack", type=float, default=1.3,
                    help="slack over observed per-distance request maxima "
                         "when probing the exact halo caps")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every rank runs (no fallback)")
    return ap


def _warn(msg: str) -> None:
    print(f"WARNING: {msg}", file=sys.stderr, flush=True)


def _local_devices(args) -> int:
    """Devices on this host: the cards, or for CPU ranks the ranks."""
    if args.device == "cuda":
        return torch.cuda.device_count()
    return max(args.devices, 1)


def setup(args, ap):
    """The config, the dataset and how a rank loads it again
    (``(load, load_kwargs)``), and whether the topology is on the host:
    ``train.py:92-229`` with the port's modules."""
    non_default = [n for n in TUNING_FLAGS
                   if getattr(args, n, None) != ap.get_default(n)]
    if args.cache_group is None:
        args.cache_group = 1
        if args.cache_budget_gb > 0 and args.devices != 1:
            local = _local_devices(args)
            total = args.devices if args.devices > 0 else local
            args.cache_group = max(
                d for d in range(1, min(local, total) + 1)
                if total % d == 0)
            print(f"auto --cache-group {args.cache_group} "
                  f"({total}-device mesh, {local} local devices)",
                  file=sys.stderr, flush=True)
    elif (args.cache_group > 1 and args.cache_budget_gb > 0
          and args.cache_group > _local_devices(args)):
        _warn(f"--cache-group {args.cache_group} exceeds the "
              f"{_local_devices(args)} local devices: stripe exchange will "
              "cross process boundaries")

    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
        # --partitioned uses a precomputed k-way partition file of the
        # dataset directory where it has one
        load, load_kwargs = load_dataset, {
            "path": cfg.dataset.path,
            "partition_count": (cfg.parallel.num_devices
                                if args.partitioned
                                and cfg.parallel.num_devices > 1 else None)}
        data = load(**load_kwargs)
        if non_default:
            _warn("--config supplies the whole Config; these command-line "
                  "flags are ignored: "
                  + ", ".join("--" + n.replace("_", "-")
                              for n in non_default))
    else:
        fanouts = tuple(int(x) for x in args.fanouts.split(","))
        placement = "host" if args.cache_budget_gb > 0 else args.features
        if args.synthetic:
            load = random_power_law_graph
            load_kwargs = dict(num_nodes=args.synthetic, avg_degree=15,
                               feature_dim=100, num_classes=47,
                               seed=args.seed)
            data = load(**load_kwargs)
            dcfg = DatasetConfig(name="synthetic", num_classes=47,
                                 feature_placement=placement)
        else:
            dcfg = (DATASET_REGISTRY[args.dataset] if args.dataset
                    else DatasetConfig())
            if not args.data_dir:
                ap.error("--data-dir (or --synthetic) required")
            load, load_kwargs = load_dataset, {
                "path": args.data_dir,
                "partition_count": (args.devices if args.partitioned
                                    and args.devices > 1 else None)}
            data = load(**load_kwargs)
            # the registry's shapes and meta.json must agree: a mismatch
            # means the wrong directory or a bad conversion
            for field, got in (("num_nodes", data.num_nodes),
                               ("num_edges", data.num_edges),
                               ("feature_dim", data.feature_dim)):
                want = getattr(dcfg, field)
                if want and want != got:
                    ap.error(
                        f"--dataset {args.dataset} registry expects "
                        f"{field}={want} but {args.data_dir}/meta.json "
                        f"has {got}: wrong directory or bad conversion")
            dcfg = DatasetConfig(
                name=dcfg.name, path=args.data_dir,
                num_nodes=data.num_nodes, num_edges=data.num_edges,
                feature_dim=data.feature_dim,
                num_classes=dcfg.num_classes or data.num_classes,
                feature_placement=placement,
                topology_placement=("host" if args.topology == "host"
                                    else dcfg.topology_placement))
        cfg = Config(
            dataset=dcfg,
            # GAT reads a slot that names its own dst row, which only a
            # deduplicated hop shows
            sampler=SamplerConfig(fanouts=fanouts,
                                  batch_size=args.batch_size,
                                  dedup_last=args.arch == "gat"),
            model=ModelConfig(arch=args.arch, hidden_dim=args.hidden_dim,
                              num_layers=len(fanouts),
                              dropout=args.dropout, dtype=args.dtype,
                              num_heads=args.num_heads),
            train=TrainConfig(learning_rate=args.lr, epochs=args.epochs,
                              seed=args.seed,
                              checkpoint_dir=args.checkpoint_dir,
                              profile_dir=args.profile_dir),
            cache=CacheConfig(enabled=args.cache_budget_gb > 0,
                              budget_bytes=int(args.cache_budget_gb * 2**30),
                              group_size=args.cache_group),
            parallel=ParallelConfig(num_devices=args.devices,
                                    halo_exchange=args.halo_exchange,
                                    halo_cap_slack=args.halo_cap_slack))
    # --config supplies the whole Config: only its own topology placement
    # drives dispatch on that path
    topo_host = ((not args.config and args.topology == "host")
                 or cfg.dataset.topology_placement == "host")
    return cfg, data, (load, load_kwargs), topo_host


def _world(args) -> int:
    """The rank count of a multi-device run."""
    if args.devices > 0:
        return args.devices
    if args.device == "cpu":
        raise ValueError("--devices 0 means every card this process sees; "
                         "with --device cpu give a rank count")
    return torch.cuda.device_count()


def _spawn(rank_fn, args, cfg: Config, source, runner=None) -> None:
    """Run ``rank_fn(device, cfg_json, load, load_kwargs)`` on every rank
    of a multi-device run: one card each, or gloo ranks on the CPU.
    ``runner`` starts them (default ``parallel.mesh.spawn``)."""
    from legion_tpu_torch.parallel.mesh import spawn
    load, load_kwargs = source
    world = _world(args)
    # CPU ranks share this host's cores
    threads = (max(1, (os.cpu_count() or 1) // world)
               if args.device == "cpu" else None)
    (runner or spawn)(rank_fn, world, args.device,
                      args=(cfg.to_json(), load, load_kwargs),
                      threads=threads)


def dispatch(args, ap, cfg: Config, data, source, topo_host: bool) -> None:
    """``train.py:233-290``: warn about what the chosen driver ignores,
    then run it."""
    multi = cfg.parallel.num_devices != 1
    partitioned = args.partitioned
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False; pass --device cpu to run on the CPU")
    device = torch.device(args.device)

    if not partitioned and not args.config and (
            args.halo_exchange != ap.get_default("halo_exchange")
            or args.halo_cap_slack != ap.get_default("halo_cap_slack")):
        _warn("--halo-exchange/--halo-cap-slack apply only to "
              "--partitioned (ignored by this driver)")
    if cfg.train.profile_dir and (partitioned or topo_host or multi):
        _warn("--profile-dir applies to the single-device Trainer and "
              "cached driver only (ignored by this driver)")
    if partitioned:
        if cfg.cache.enabled:
            _warn("--partitioned ignores --cache-budget-gb/--cache-group "
                  "(the partitioned driver shards features per host; no "
                  "hotness cache)")
        if topo_host:
            _warn("--partitioned ignores --topology host (each host holds "
                  "its own partition's CSR in device memory)")
        from legion_tpu_torch.parallel.launch import run_ranks
        from legion_tpu_torch.train.partitioned_driver import (
            partitioned_rank)
        _spawn(partitioned_rank, args, cfg, source, runner=run_ranks)
    elif topo_host and multi:
        if not cfg.cache.enabled:
            _warn("--topology host without --cache-budget-gb: zero hot "
                  "cache, every hop/feature is host-served")
        from legion_tpu_torch.train.hybrid_driver import hybrid_rank
        _spawn(hybrid_rank, args, cfg, source)
    elif topo_host:
        if cfg.cache.group_size > 1:
            _warn("--cache-group > 1 needs --devices > 1; running "
                  "single-device with an unstriped cache")
        if not cfg.cache.enabled:
            _warn("--topology host without --cache-budget-gb: zero hot "
                  "cache, every hop/feature is host-served")
        from legion_tpu_torch.train.hybrid_driver import run_hybrid_training
        run_hybrid_training(cfg, data, device)
    elif cfg.cache.enabled and multi:
        from legion_tpu_torch.train.cached_driver import cached_rank
        _spawn(cached_rank, args, cfg, source)
    elif cfg.cache.enabled:
        if cfg.cache.group_size > 1:
            _warn("--cache-group > 1 needs --devices > 1; running "
                  "single-device with an unstriped cache")
        from legion_tpu_torch.train.cached_driver import run_cached_training
        run_cached_training(cfg, data, device)
    elif multi:
        if (cfg.cache.group_size > 1
                and cfg.dataset.feature_placement != "hbm_sharded"):
            _warn("--cache-group is meaningless without --cache-budget-gb "
                  "or --features hbm_sharded (nothing to stripe)")
        from legion_tpu_torch.parallel.trainer import fit_rank
        _spawn(fit_rank, args, cfg, source)
    else:
        if cfg.cache.group_size > 1:
            _warn("--cache-group is meaningless without --cache-budget-gb "
                  "(no cache to stripe)")
        from legion_tpu_torch.train.loop import Trainer
        Trainer(cfg, data, device).fit()


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg, data, source, topo_host = setup(args, ap)
    print(cfg.to_json(), flush=True)
    dispatch(args, ap, cfg, data, source, topo_host)


if __name__ == "__main__":
    main()
