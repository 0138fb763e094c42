"""Training state (port of ``legion_tpu/train/train_state.py``, without
checkpointing, which is queued in ROADMAP.md).

The model and the optimizer are updated in place; ``step`` and ``epoch``
are host integers, so reading them never waits for the device. One
device generator drives both sampling and dropout, as one PRNG key does
in the reference.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator      # sampler + dropout randomness
    step: int = 0
    epoch: int = 0


def create_train_state(model: torch.nn.Module, learning_rate: float,
                       seed: int, device: torch.device | str) -> TrainState:
    """Adam with optax.adam's update rule (b1 0.9, b2 0.999, eps 1e-8,
    bias-corrected), the reference optimizer at lr 0.003 by default."""
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(model=model, optimizer=opt, generator=gen)
