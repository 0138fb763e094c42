"""A cell by name: its workload file, the configuration and the traffic
mix it names, each a JSON file of its own under this folder, found by the
names ``BENCHMARK.json`` gives.

* ``workloads/<cell>.json``: ``config``, ``traffic``, ``chips``, ``why``;
* ``configs/<config>.json``: the graph's sizes (top-level numbers), the
  model (``model``: its ``arch`` names a module of ``models/``), the
  placement of features and topology, and the driver that runs it
  (``driver``: a module of ``drivers/``); a typed graph's optional
  ``node_types``, ``relations`` and ``feature_dtype`` (``check_schema``);
* ``traffic/<traffic>.json``: the mini-batches (batch, fanouts), the
  cache budget as a share of the feature table, and the driver's warm-up
  epochs before the window.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts: str) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(name: str) -> Dict:
    """The workload ``name`` with its ``configuration`` and ``traffic``."""
    cell = load_json("workloads", f"{name}.json")
    cell["name"] = name
    cell["configuration"] = load_json("configs", f"{cell['config']}.json")
    check_schema(cell["configuration"])
    cell["traffic_mix"] = load_json("traffic", f"{cell['traffic']}.json")
    return cell


# relation ids fit a signed byte
MAX_RELATIONS = 127
FEATURE_DTYPES = ("float32", "float16")


def check_schema(conf: Dict) -> None:
    """Refuse, naming the fault, a configuration whose typed graph does not
    hold together. A typed graph lists ``node_types`` (``name``,
    ``num_nodes``, in id order; type 0 holds the labelled nodes) whose
    counts sum to ``num_nodes``, and ``relations`` (``name``, ``src``,
    ``dst``, ``avg_in_degree``, ``zipf_alpha``) between known types, at
    most ``MAX_RELATIONS`` of them and no two on one (src, dst) pair, so
    that an edge's endpoints fix its relation. ``feature_dtype`` is one of
    ``FEATURE_DTYPES``. A homogeneous configuration has neither list."""
    name = conf.get("name")
    dtype = conf.get("feature_dtype", "float32")
    if dtype not in FEATURE_DTYPES:
        raise ValueError(f"configuration {name!r}: feature_dtype {dtype!r} "
                         f"is not one of {FEATURE_DTYPES}")
    types, rels = conf.get("node_types"), conf.get("relations")
    if types is None and rels is None:
        return
    if not types or not rels:
        raise ValueError(f"configuration {name!r}: a typed graph needs both "
                         "node_types and relations")
    names = [t["name"] for t in types]
    if len(set(names)) != len(names):
        raise ValueError(f"configuration {name!r}: node type names "
                         f"{names} repeat")
    total = sum(int(t["num_nodes"]) for t in types)
    if total != int(conf["num_nodes"]):
        raise ValueError(f"configuration {name!r}: num_nodes "
                         f"{conf['num_nodes']} is not the node types' sum "
                         f"{total}")
    if len(rels) > MAX_RELATIONS:
        raise ValueError(f"configuration {name!r}: {len(rels)} relations, "
                         f"more than {MAX_RELATIONS}")
    pairs: Dict = {}
    for r in rels:
        for end in ("src", "dst"):
            if r[end] not in names:
                raise ValueError(f"configuration {name!r}: relation "
                                 f"{r['name']!r} names unknown {end} type "
                                 f"{r[end]!r}")
        pair = (r["src"], r["dst"])
        if pair in pairs:
            raise ValueError(f"configuration {name!r}: relations "
                             f"{pairs[pair]!r} and {r['name']!r} share the "
                             f"(src, dst) types {pair}")
        pairs[pair] = r["name"]


def benchmark() -> Dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def row_bytes(cell: Dict) -> int:
    """Bytes of a feature row as the cache holds it (the compute dtype)."""
    m = cell["configuration"]["model"]
    size = 2 if m["dtype"] == "bfloat16" else 4
    return cell["configuration"]["feature_dim"] * size


# keys of a configuration's ``model`` that the harness reads itself: the
# parameters' dtype, and the optimizer the reference follows
HARNESS_MODEL_KEYS = ("param_dtype", "learning_rate", "adam_betas",
                      "adam_eps")


def model_keys() -> List[str]:
    """The keys of a configuration's ``model`` that the port's
    ``ModelConfig`` declares (imports the port)."""
    from legion_tpu_torch.config import ModelConfig
    return [f.name for f in dataclasses.fields(ModelConfig)]


def port_config(cell: Dict, seed: int, epochs: int):
    """The port's ``Config`` for ``cell`` (imports the port)."""
    from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                         ModelConfig, SamplerConfig,
                                         TrainConfig)
    conf, mix = cell["configuration"], cell["traffic_mix"]
    g, m = conf, conf["model"]
    unknown = set(m) - set(model_keys()) - set(HARNESS_MODEL_KEYS)
    if unknown:
        raise ValueError(f"configuration {conf['name']!r}: model keys "
                         f"{sorted(unknown)} are neither ModelConfig "
                         "fields nor the harness's")
    share = mix.get("cache_share")
    cache = CacheConfig()
    if share is not None:
        cache = CacheConfig(
            enabled=True,
            budget_bytes=int(math.ceil(share * g["num_nodes"]
                                       * row_bytes(cell))),
            presample_steps=mix.get("presample_steps", 0))
    return Config(
        dataset=DatasetConfig(
            name=conf["name"], num_nodes=g["num_nodes"],
            feature_dim=g["feature_dim"], num_classes=g["num_classes"],
            feature_placement=conf["feature_placement"],
            topology_placement=conf["topology_placement"]),
        sampler=SamplerConfig(
            fanouts=tuple(mix["fanouts"]), batch_size=mix["batch_size"],
            eval_batch_size=mix["batch_size"],
            dedup_last=conf["dedup_last"]),
        model=ModelConfig(**{k: m[k] for k in model_keys() if k in m}),
        train=TrainConfig(learning_rate=m["learning_rate"], epochs=epochs,
                          seed=int(seed)),
        cache=cache)
