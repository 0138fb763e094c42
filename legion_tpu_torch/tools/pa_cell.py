"""The cached path at papers100M class: its configuration and its dataset.

``tools/smoke_pa_scale.py``'s configuration (SAGE-256 bf16, dropout 0.5,
lr 0.003, fanout [25,10], batch 8000, host-resident features, 6 presample
steps) on a streamed power-law graph of 2^24 + 2^20 nodes, cut from
ogbn-papers100M's 111,059,956 so that node ids pass the 2^24 the TPU's
f32 lane select was exact to, with the 1 GiB cache budget scaled by the
same cut (164 MiB: the cache holds the same ~15 % of rows).

The graph is generated once into ``<root>/.bench_cache/`` and loaded by
mmap. Its directory is named by a hash of the generator's arguments and
of the generator's and the format's sources, so a change to either makes
a new dataset instead of reusing a stale one.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                     ModelConfig, SamplerConfig, TrainConfig)
from legion_tpu_torch.data import format as data_format
from legion_tpu_torch.data import synthetic

FULL_NODES = 111_059_956                    # ogbn-papers100M
NODES = (1 << 24) + (1 << 20)
BUDGET = 164 << 20                          # 1 GiB x NODES / FULL_NODES
CLASSES, BATCH, STEPS = 172, 8000, 10       # STEPS training steps an epoch
GRAPH_ARGS = dict(num_nodes=NODES, avg_degree=14, feature_dim=32,
                  num_classes=CLASSES, seed=0, train_num=STEPS * BATCH + 1,
                  valid_num=2 * BATCH, test_num=2 * BATCH)
_PREFIX = "synth_pa_torch_"


def config(epochs: int, budget: int = BUDGET) -> Config:
    return Config(
        dataset=DatasetConfig(num_classes=CLASSES, feature_placement="host"),
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=BATCH,
                              dedup_last=True),
        model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype="bfloat16"),
        train=TrainConfig(learning_rate=0.003, epochs=epochs),
        cache=CacheConfig(enabled=True, budget_bytes=budget,
                          presample_steps=6))


def streamed_dir(root: str, prefix: str, args: dict) -> str:
    """The cache directory of ``streaming_power_law_graph(**args)``:
    ``<root>/.bench_cache/<prefix><nodes>_<hash>``, the hash over the
    arguments and the generator's and the format's sources."""
    h = hashlib.sha256(json.dumps(args, sort_keys=True).encode())
    for mod in (synthetic, data_format):
        with open(mod.__file__, "rb") as f:
            h.update(f.read())
    return os.path.join(root, ".bench_cache",
                        f"{prefix}{args['num_nodes']}_{h.hexdigest()[:12]}")


def streamed_dataset(root: str, prefix: str, args: dict, log=print):
    """(data, seconds generating, seconds loading) of the graph in
    ``streamed_dir``. Generates it unless a complete copy (one with
    ``meta.json``) is cached; other ``<prefix>*`` directories under
    ``<root>/.bench_cache`` are stale ones and are removed first."""
    path = streamed_dir(root, prefix, args)
    gen_s = 0.0
    if not os.path.exists(os.path.join(path, "meta.json")):
        cache = os.path.dirname(path)
        os.makedirs(cache, exist_ok=True)
        for name in os.listdir(cache):
            if name.startswith(prefix):
                shutil.rmtree(os.path.join(cache, name))
        t0 = time.perf_counter()
        synthetic.streaming_power_law_graph(path + ".tmp", log=log, **args)
        os.replace(path + ".tmp", path)
        gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = data_format.load_dataset(path, mmap=True)
    return data, gen_s, time.perf_counter() - t0


def dataset_dir(root: str) -> str:
    return streamed_dir(root, _PREFIX, GRAPH_ARGS)


def dataset(root: str, log=print):
    """This cell's graph: ``streamed_dataset`` of ``GRAPH_ARGS``."""
    return streamed_dataset(root, _PREFIX, GRAPH_ARGS, log)
