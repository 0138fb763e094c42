"""One-command OGB accuracy-parity harness of the port (counterpart of
``tools/parity_ogb.py``, with its flags and defaults plus ``--device``).

    python -m legion_tpu_torch.tools.parity_ogb --name ogbn-products --ogb-root /data/ogb
    python -m legion_tpu_torch.tools.parity_ogb --device cpu ...    # plain versions

converts the dataset (``legion_tpu_torch.data.ogb``; skipped when the
packed directory already holds ``meta.json``), trains with the reference
client's hyperparameters (hidden 256, fanout [25,10], batch 8000, lr 0.003,
dropout 0.5, Adam, 10 epochs) through ``Trainer``, or through
``run_cached_training`` with ``--cache-budget-gb > 0``, compares the test
accuracy with the pinned target of ``docs/PARITY.md``, prints one JSON
verdict line and exits 1 when the gap exceeds ``--tolerance``.
``--device`` is ``cuda`` by default; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

# Pinned parity targets (docs/PARITY.md "Accuracy-parity plan"): the
# standard DGL neighbor-sampling baselines the reference client
# reproduces, at its default hyperparameters.
TARGETS = {
    ("ogbn-products", "sage"): 0.78,
    ("ogbn-products", "gcn"): 0.75,
    ("ogbn-papers100M", "sage"): 0.64,
    ("ogbn-arxiv", "sage"): 0.70,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("OGB accuracy-parity harness")
    ap.add_argument("--name", default="ogbn-products",
                    help="OGB dataset name (ogbn-products / "
                         "ogbn-papers100M / ogbn-arxiv)")
    ap.add_argument("--ogb-root", required=True,
                    help="directory containing the downloaded OGB "
                         "dataset (NodePropPredDataset root)")
    ap.add_argument("--out", default=None,
                    help="packed-dataset output dir (default "
                         "<ogb-root>/<name>_packed); conversion is "
                         "skipped when meta.json already exists there")
    ap.add_argument("--arch", default="sage", choices=["sage", "gcn"])
    # the reference client's hyperparameters
    ap.add_argument("--batch-size", type=int, default=8000)
    ap.add_argument("--fanouts", default="25,10")
    ap.add_argument("--hidden-dim", type=int, default=256)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=0.003)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--cache-budget-gb", type=float, default=0.0,
                    help=">0: host-resident features behind the hotness "
                         "cache (papers100M-class; 0 = device features)")
    ap.add_argument("--target", type=float, default=None,
                    help="override the pinned test-accuracy target")
    ap.add_argument("--tolerance", type=float, default=0.01,
                    help="max allowed (target - test_acc) before "
                         "exiting nonzero")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (no fallback: cuda without a "
                         "card raises)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    out = args.out or os.path.join(args.ogb_root,
                                   args.name.replace("-", "_") + "_packed")
    target = args.target
    if target is None:
        target = TARGETS.get((args.name, args.arch))
        if target is None:
            ap.error(f"no pinned target for ({args.name}, {args.arch}); "
                     "pass --target explicitly")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False; pass --device cpu to run on the CPU")

    from legion_tpu_torch.data.format import load_dataset

    if os.path.exists(os.path.join(out, "meta.json")):
        print(f"packed dataset found at {out}; skipping conversion",
              file=sys.stderr, flush=True)
    else:
        from legion_tpu_torch.data.ogb import convert_ogb_node_dataset
        print(f"converting {args.name} from {args.ogb_root} -> {out}",
              file=sys.stderr, flush=True)
        convert_ogb_node_dataset(args.name, args.ogb_root, out)
    data = load_dataset(out)

    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                         ModelConfig, SamplerConfig,
                                         TrainConfig)
    cfg = Config(
        dataset=DatasetConfig(
            name=args.name, path=out, num_nodes=data.num_nodes,
            num_edges=data.num_edges, feature_dim=data.feature_dim,
            num_classes=data.num_classes,
            feature_placement=("host" if args.cache_budget_gb > 0
                               else "hbm")),
        sampler=SamplerConfig(fanouts=fanouts,
                              batch_size=args.batch_size),
        model=ModelConfig(arch=args.arch, hidden_dim=args.hidden_dim,
                          num_layers=len(fanouts),
                          dropout=args.dropout, dtype=args.dtype),
        train=TrainConfig(learning_rate=args.lr, epochs=args.epochs,
                          seed=args.seed),
        cache=CacheConfig(enabled=args.cache_budget_gb > 0,
                          budget_bytes=int(args.cache_budget_gb * 2**30)))

    if cfg.cache.enabled:
        from legion_tpu_torch.train.cached_driver import run_cached_training
        res = run_cached_training(cfg, data, args.device)
        test_acc = float(res["test_acc"])
        valid_acc = float(res["history"][-1].get("valid", float("nan")))
    else:
        from legion_tpu_torch.train.loop import Trainer
        tr = Trainer(cfg, data, args.device)
        res = tr.fit()
        test_acc = float(res["test_acc"])
        valid_acc = float(tr.evaluate("valid"))

    gap = target - test_acc
    ok = gap <= args.tolerance
    print(json.dumps({
        "dataset": args.name, "arch": args.arch,
        "valid_acc": round(valid_acc, 4),
        "test_acc": round(test_acc, 4),
        "target": target, "gap": round(gap, 4),
        "tolerance": args.tolerance,
        "parity": "PASS" if ok else "FAIL",
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
