"""Configuration of the port (counterpart of ``legion_tpu/config.py``).

The fields the port's drivers act on, with the reference's names and
defaults, so they mean the same here. ``legion_tpu.config`` is not
imported: the port and its smoke script load nothing of the JAX package.
Fields of paths not ported yet (the parallel section, the JAX program's
tuning, the dataset registry, the striped cache's ``group_size`` and the
cost model's ``cost_model_granularity``) are left out, so setting one
fails instead of being ignored; ``profile_dir`` is kept because the
drivers raise when it is set, and so do the values of a kept field that
name an unported path (``feature_placement="hbm_sharded"``).
``topology_placement``, ``feature_placement`` and ``CacheConfig.enabled``
choose the driver, and each driver raises on a config that names another:
``Trainer`` wants topology and features in device memory with the cache
off, ``run_cached_training`` the topology in device memory and the
features in host memory with the cache on, ``run_hybrid_training`` both in
host memory with the cache on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

FEATURE_PLACEMENTS = ("hbm", "host")
TOPOLOGY_PLACEMENTS = ("hbm", "host")


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    num_classes: int = 0                # 0: one more than the largest label
    # Where features live: "hbm" (the whole table in device memory,
    # train.loop.Trainer) or "host" (host RAM behind the hot-row cache,
    # train.cached_driver.run_cached_training).
    feature_placement: str = "hbm"
    # Where the CSR lives: "hbm" (whole in device memory) or "host" (host
    # RAM, a hot sub-CSR on the device and a host sampler for the misses:
    # train.hybrid_driver.run_hybrid_training).
    topology_placement: str = "hbm"
    # Zero-pad the feature dim to this column multiple before device
    # placement (0 = off). Inert for numerics; 128 f32 columns make
    # 512-byte rows, which the gather kernel moves in 16-byte words.
    feature_pad_align: int = 128

    def __post_init__(self):
        if self.feature_placement == "hbm_sharded":
            raise NotImplementedError(
                "feature_placement='hbm_sharded' (the multi-device drivers) "
                "is not ported to legion_tpu_torch yet (queued in ROADMAP.md)")
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
    probe_caps: bool = True
    probe_caps_min_cap: int = 262144
    probe_caps_batches: int = 3
    # Dedup the final hop's frontier (False: identity-append it, K1's
    # layout). The cached path always dedups.
    dedup_last: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "sage"                  # sage | gcn | lp_sage
    hidden_dim: int = 256
    num_layers: int = 2
    dropout: float = 0.5
    # Compute dtype for dense layers; params stay float32.
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 0.003
    epochs: int = 10
    seed: int = 0
    # Steps of sample + cache plan the cached trainer enqueues ahead of
    # the one it trains (the reference's PIPELINE_DEPTH 2,
    # src/Server.cu:15).
    pipeline_depth: int = 2
    # Both drivers restore the latest checkpoint of this directory at
    # start and save after every epoch.
    checkpoint_dir: Optional[str] = None
    # > 0: the cached trainer also saves every N steps within an epoch.
    checkpoint_every_steps: int = 0
    profile_dir: Optional[str] = None       # not ported: drivers raise


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Hotness-aware feature cache (reference ``src/GPUCache.cu``).

    ``budget_bytes`` is the one card's device-memory budget
    (``src/GPUCache.cu:661-767``): the cached driver gives all of it to
    the feature cache (its topology is whole in device memory), the hybrid
    driver lets the cost model split it between the feature cache and the
    topology cache."""

    enabled: bool = False       # True: run_cached_training, run_hybrid_training
    budget_bytes: int = 4 << 30
    presample_steps: int = 0            # 0 = one full epoch


@dataclasses.dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
