"""Configuration of the port (counterpart of ``legion_tpu/config.py``).

The fields the single-device trainer acts on, with the reference's names
and defaults, so they mean the same here. ``legion_tpu.config`` is not
imported: the port and its smoke script load nothing of the JAX package.
Fields of paths not ported yet (placements, the cache and parallel
sections, the JAX program's tuning, the dataset registry) are left out,
so setting one fails instead of being ignored; ``checkpoint_dir`` and
``profile_dir`` are kept because ``Trainer`` raises when they are set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    num_classes: int = 0                # 0: one more than the largest label
    # Zero-pad the feature dim to this column multiple before device
    # placement (0 = off). Inert for numerics; 128 f32 columns make
    # 512-byte rows, which the gather kernel moves in 16-byte words.
    feature_pad_align: int = 128


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
    # layout).
    dedup_last: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "sage"                  # the port builds "sage" only
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
    checkpoint_dir: Optional[str] = None    # not ported: Trainer raises
    profile_dir: Optional[str] = None       # not ported: Trainer raises


@dataclasses.dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
