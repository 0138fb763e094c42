"""Main-path A/B: the ``Trainer`` of the port found in another checkout.

    python legion_tpu_torch/tools/ab_trainer.py --gen        # once
    python legion_tpu_torch/tools/ab_trainer.py TREE

Run as a script from a repository root on a machine with the card. With
``--gen`` it saves ``bench_graph()``'s full-size arrays to
``.bench_cache/ab_trainer/`` in the working directory. With ``TREE`` (a
checkout, e.g. a ``git archive`` of another commit unpacked into a
gitignored directory) it imports that tree's ``legion_tpu_torch``, trains
its ``Trainer`` on the saved arrays with ``chip_smoke.py``'s main-path
configuration (SAGE-256 bf16, fanout [25,10], batch 8000, cap slack 1.03)
for four epochs and prints one JSON line with the caps and each epoch's
ms/step and edges/s. Compare two trees in one call, in the order A, B,
B, A; epoch 0 carries warm-up.
"""

import argparse
import json
import os
import sys

import numpy as np

EPOCHS = 4
NAMES = ("indptr", "indices", "features", "labels", "train_ids",
         "valid_ids", "test_ids")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?")
    ap.add_argument("--gen", action="store_true")
    args = ap.parse_args()
    cache = os.path.join(os.getcwd(), ".bench_cache", "ab_trainer")
    tree = os.path.abspath(args.tree or os.getcwd())
    sys.path.insert(0, tree)
    import legion_tpu_torch
    got = os.path.dirname(os.path.dirname(os.path.abspath(
        legion_tpu_torch.__file__)))
    if got != tree:
        raise SystemExit(f"imported legion_tpu_torch from {got}, not {tree}")
    if args.gen:
        from legion_tpu_torch.data.synthetic import bench_graph
        g = bench_graph()
        os.makedirs(cache, exist_ok=True)
        for n in NAMES:
            np.save(os.path.join(cache, n + ".npy"), getattr(g, n))
        return
    from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                         SamplerConfig, TrainConfig)
    from legion_tpu_torch.data.format import GraphData
    from legion_tpu_torch.train.loop import Trainer
    g = GraphData(**{n: np.load(os.path.join(cache, n + ".npy"))
                     for n in NAMES})
    cfg = Config(dataset=DatasetConfig(num_classes=47),
                 sampler=SamplerConfig(fanouts=(25, 10), batch_size=8000,
                                       observed_cap_slack=1.03),
                 model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                                   dropout=0.5, dtype="bfloat16"),
                 train=TrainConfig(learning_rate=0.003))
    tr = Trainer(cfg, g, device="cuda")
    recs = [tr.train_one_epoch(e) for e in range(EPOCHS)]
    print(json.dumps({
        "tree": args.tree, "caps": list(tr.caps),
        "ms_per_step": [1e3 * r["epoch_s"] / r["steps"] for r in recs],
        "edges_per_s": [r["edges_per_s"] for r in recs]}), flush=True)


if __name__ == "__main__":
    main()
