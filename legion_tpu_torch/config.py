"""Configuration of the port (counterpart of ``legion_tpu/config.py``).

The reference's dataclass tree with its names, defaults and field order,
so that a JSON file written by either package loads in the other.
``legion_tpu.config`` is not imported: the port and its smoke script load
nothing of the JAX package. ``ModelConfig.num_heads`` (GAT's heads) is the
port's own field: ``to_json`` writes it only where it is not 1, so every
config the reference can express round-trips through both.
``TrainConfig.scan_unroll`` is not a field (it tunes ``lax.scan``; the
port's epoch is a Python loop) and is one of the removed keys
``Config.from_json`` tolerates.

Which path reads each field:

* ``dataset``: ``name``, ``path``, ``num_nodes``, ``num_edges`` and
  ``feature_dim`` are read by the command line (``train/__main__.py``: the
  registry check and ``--config``'s dataset directory);
  ``num_classes`` and ``feature_pad_align`` by every driver;
  ``topology_placement`` and ``feature_placement`` by the command line's
  dispatch, ``feature_placement="hbm_sharded"`` also by ``MeshTrainer``
  (the table striped over each cache group, the rows fetched through the
  exchange of ``parallel/feature_exchange.py``).
* ``sampler``, ``model``: every driver. ``train``: every driver;
  ``pipeline_depth`` the cached trainers (single-device and striped),
  ``profile_dir`` the ``Trainer`` (epoch 0 under ``torch.profiler``: on a
  card its first step, run eagerly as the capture's warm-up, the capture
  and the replays of the other steps) and ``run_cached_training`` (its
  first epoch after the capturing one, the steady state), each trace
  written by ``utils.trace.profiled`` with the spans of
  ``utils/trace.py`` on its host rows; the other drivers accept it and do
  not read it.
* ``cache``: ``enabled`` the dispatch; ``budget_bytes`` and
  ``cost_model_granularity`` the cost model of the cached and hybrid
  drivers; ``presample_steps`` their presample. ``group_size``: the
  ranks of a cache group, read by ``parallel.mesh.make_mesh`` for
  ``MeshTrainer`` and for the cached and hybrid drivers on a mesh
  (``train/cached_driver.py``, ``train/hybrid_driver.py``), whose cost
  model takes the group's budget (``group_size`` x a device's); without
  a mesh they pass it to their cost model too.
* ``parallel``: ``num_devices`` the dispatch, ``MeshTrainer`` and the
  edge-partitioned driver; the ``halo_*`` fields that driver
  (``train/partitioned_driver.py``: the exchange, and the slack and
  batches of its cap probe).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

FEATURE_PLACEMENTS = ("hbm", "hbm_sharded", "host")
TOPOLOGY_PLACEMENTS = ("hbm", "host")


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Where the graph lives and its shape (the reference registry's
    entries, ``legion_server.py:6-53``)."""

    name: str = "synthetic"
    path: Optional[str] = None          # directory with packed binary files
    num_nodes: int = 0
    num_edges: int = 0
    feature_dim: int = 0
    num_classes: int = 0                # 0: one more than the largest label
    # Where features live: "hbm" (the whole table on each device),
    # "hbm_sharded" (rows striped over the cache axis of a mesh; the whole
    # table on one device) or "host" (host RAM behind the hot-row cache).
    feature_placement: str = "hbm"
    # Where the CSR lives: "hbm" (whole in device memory) or "host" (host
    # RAM, a hot sub-CSR on the device and a host sampler for the misses).
    topology_placement: str = "hbm"
    # Zero-pad the feature dim to this column multiple before device
    # placement (0 = off). Inert for numerics; 128 f32 columns make
    # 512-byte rows, which the gather kernel moves in 16-byte words.
    feature_pad_align: int = 128

    def __post_init__(self):
        if self.feature_placement not in FEATURE_PLACEMENTS:
            raise ValueError(f"feature_placement must be one of "
                             f"{FEATURE_PLACEMENTS}, got "
                             f"{self.feature_placement!r}")
        if self.topology_placement not in TOPOLOGY_PLACEMENTS:
            raise ValueError(f"topology_placement must be one of "
                             f"{TOPOLOGY_PLACEMENTS}, got "
                             f"{self.topology_placement!r}")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """fanouts[0] is sampled from the seed batch (used by the model's last
    layer), fanouts[k] from the hop-k frontier."""

    fanouts: Sequence[int] = (25, 10)
    batch_size: int = 1024
    eval_batch_size: int = 512
    # Slack multiplier over observed frontier sizes when probing caps.
    observed_cap_slack: float = 1.2
    # Probe realized frontier sizes at Trainer init and tighten the static
    # caps; skipped when the loose last cap is below probe_caps_min_cap.
    # MeshTrainer never probes (the reference's loose caps).
    probe_caps: bool = True
    probe_caps_min_cap: int = 262144
    probe_caps_batches: int = 3
    # Dedup the final hop's frontier (False: identity-append it, K1's
    # layout). The cached path always dedups.
    dedup_last: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "sage"                  # sage | gcn | lp_sage | gat
    hidden_dim: int = 256               # gat: the width of one head
    num_layers: int = 2
    dropout: float = 0.5
    # Compute dtype for dense layers; params stay float32.
    dtype: str = "float32"
    # gat's attention heads (the other archs have none: 1). Not a field of
    # the reference's ModelConfig: to_json leaves it out while it is 1.
    num_heads: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 0.003
    epochs: int = 10
    seed: int = 0
    # Steps of sample + cache plan the cached trainer enqueues ahead of
    # the one it trains (the reference's PIPELINE_DEPTH 2,
    # src/Server.cu:15).
    pipeline_depth: int = 2
    # Every driver restores the latest checkpoint of this directory at
    # start and saves after every epoch.
    checkpoint_dir: Optional[str] = None
    # > 0: the cached and hybrid trainers also save every N steps within
    # an epoch.
    checkpoint_every_steps: int = 0
    # When set, the Trainer runs epoch 0 under torch.profiler and writes
    # its trace into this directory (on a card: its first step, the
    # capture, then the replays of the other steps).
    profile_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Hotness-aware cache (reference ``src/GPUCache.cu``).

    ``budget_bytes`` is one card's device-memory budget
    (``src/GPUCache.cu:661-767``); the cost model plans for ``group_size``
    cards, the reference's cache group (one in the single-device drivers,
    which plan for the group's whole budget as the reference's do). The
    cached driver gives all of it to the feature cache (its topology is
    whole in device memory), the hybrid driver lets the cost model split
    it between the feature cache and the topology cache in
    ``cost_model_granularity`` steps."""

    enabled: bool = False
    budget_bytes: int = 4 << 30
    group_size: int = 1
    cost_model_granularity: float = 0.01  # MIN_INTERVAL, src/GPUCache.cu:30
    presample_steps: int = 0            # 0 = one full epoch


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The rank layout: ``num_devices`` ranks (0 = every card this process
    sees) as a (data x cache) grid with cache groups of
    ``CacheConfig.group_size`` consecutive ranks (``parallel/mesh.py``)."""

    num_devices: int = 0
    # The edge-partitioned path's halo exchange: "exact" (per-ring-distance
    # sends at probed caps) or "psum" (the cap-free oracle), the slack over
    # the probed request maxima, and the probe's batches.
    halo_exchange: str = "exact"
    halo_cap_slack: float = 1.3
    halo_probe_batches: int = 2


@dataclasses.dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d["model"]["num_heads"] == 1:
            # the reference's JSON, which has no head count
            del d["model"]["num_heads"]
        return json.dumps(d, indent=2)

    # keys of older config versions, and the reference's scan_unroll: the
    # only unknown keys from_json tolerates; anything else (a typo such as
    # "learning_rat") raises rather than training with a default
    _REMOVED_KEYS = {"drop_last", "payload_bytes", "data_axis",
                     "donate_state", "log_every_steps", "scan_unroll"}

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)

        def mk(cls, sub):
            names = {f.name for f in dataclasses.fields(cls)}
            unknown = set(sub) - names - Config._REMOVED_KEYS
            if unknown:
                raise ValueError(
                    f"unknown {cls.__name__} key(s) {sorted(unknown)}; "
                    f"valid keys: {sorted(names)}")
            return cls(**{k: v for k, v in sub.items() if k in names})

        sampler = dict(d.get("sampler", {}))
        if "fanouts" in sampler:
            sampler["fanouts"] = tuple(sampler["fanouts"])
        return Config(
            dataset=mk(DatasetConfig, d.get("dataset", {})),
            sampler=mk(SamplerConfig, sampler),
            model=mk(ModelConfig, d.get("model", {})),
            train=mk(TrainConfig, d.get("train", {})),
            cache=mk(CacheConfig, d.get("cache", {})),
            parallel=mk(ParallelConfig, d.get("parallel", {})),
        )


# Known datasets (the reference registry, legion_server.py:6-53): shapes
# only; nothing is downloaded, and a dataset directory is checked against
# its entry by the command line.
DATASET_REGISTRY = {
    "PR": DatasetConfig(name="ogbn-products", num_nodes=2_449_029,
                        num_edges=123_718_280, feature_dim=100,
                        num_classes=47),
    "PA": DatasetConfig(name="ogbn-papers100M", num_nodes=111_059_956,
                        num_edges=1_615_685_872, feature_dim=128,
                        num_classes=172, feature_placement="host",
                        topology_placement="hbm"),
    "CO": DatasetConfig(name="com-friendster", num_nodes=65_608_366,
                        num_edges=1_806_067_135, feature_dim=256,
                        num_classes=100, feature_placement="host",
                        topology_placement="hbm"),
    "UKS": DatasetConfig(name="uk-union", num_nodes=133_633_040,
                         num_edges=5_507_679_822, feature_dim=256,
                         num_classes=100, feature_placement="host",
                         topology_placement="host"),
    "UKL": DatasetConfig(name="uk2014", num_nodes=787_801_471,
                         num_edges=47_284_178_505, feature_dim=128,
                         num_classes=100, feature_placement="host",
                         topology_placement="host"),
    "CL": DatasetConfig(name="clueweb", num_nodes=955_207_488,
                        num_edges=42_574_107_469, feature_dim=128,
                        num_classes=100, feature_placement="host",
                        topology_placement="host"),
    "AX": DatasetConfig(name="ogbn-arxiv", num_nodes=169_343,
                        num_edges=1_166_243, feature_dim=128,
                        num_classes=40),
}
