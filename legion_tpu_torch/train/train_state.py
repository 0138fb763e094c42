"""Training state with checkpoint and resume (port of
``legion_tpu/train/train_state.py``).

The model and the optimizer are updated in place; ``step`` and ``epoch``
are host integers, so reading them never waits for the device. One
device generator drives both sampling and dropout, as one PRNG key does
in the reference. The whole state (parameters, Adam moments, step and
epoch counters, the generator's state) round-trips through ``torch.save``
into ``<dir>/step_<n>``, so a run killed after a save resumes exactly
where the saved state stood. A data-parallel run saves every rank's
generator state (``generators``), and each rank restores its own.

On a CUDA device Adam is ``capturable``: its step counts and bias
corrections live on the device, so a captured step (``train/graphed.py``)
replays the whole update. A restore loads into the tensors the state
already holds wherever their shapes allow, so that a graph captured
before it goes on reading live buffers.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, List, Optional

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
    bias-corrected), the reference optimizer at lr 0.003 by default;
    ``capturable`` on a CUDA device (the same rule, computed on the
    device)."""
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8,
                           capturable=torch.device(device).type == "cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(model=model, optimizer=opt, generator=gen)


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    generators: Optional[List[torch.Tensor]] = None) -> str:
    """Write the state to ``<ckpt_dir>/step_<state.step>`` (replacing a
    file of that step) and return the path. The file appears whole or not
    at all: it is written beside its place and renamed. ``generators``:
    every rank's generator state, in rank order, where ranks share the
    model and the optimizer but each draws its own stream."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": state.step, "epoch": state.epoch,
               "generators": (generators if generators is not None
                              else [state.generator.get_state()])}
    path = os.path.join(ckpt_dir, f"step_{state.step}")
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``step_<n>`` of the highest n in ckpt_dir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in
             (re.fullmatch(r"step_(\d+)", d) for d in os.listdir(ckpt_dir))
             if m]
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}")


def restore_checkpoint(ckpt_dir: str, state: TrainState, rank: int = 0,
                       world: int = 1) -> Optional[TrainState]:
    """Load the latest checkpoint of ckpt_dir into ``state`` (its model,
    optimizer and rank ``rank``'s generator, in place, on their devices)
    and return it; None, with ``state`` untouched, when there is no
    checkpoint. A checkpoint resumes at the world size that wrote it."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    # a file written before data-parallel runs holds one "generator"
    generators = payload.get("generators") or [payload["generator"]]
    if len(generators) != world:
        raise ValueError(f"{path} holds the generator states of "
                         f"{len(generators)} rank(s); this run has {world}")
    state.model.load_state_dict(payload["model"])     # copies in place
    load_optimizer_in_place(state.optimizer, payload["optimizer"])
    state.generator.set_state(generators[rank].cpu())  # in place
    state.step = int(payload["step"])
    state.epoch = int(payload["epoch"])
    return state


def load_optimizer_in_place(opt: torch.optim.Optimizer, saved: dict) -> None:
    """``opt.load_state_dict(saved)``, keeping each state tensor ``opt``
    already holds where the loaded one has its shape, type and device
    (the value is copied into it), and keeping ``opt``'s own
    ``capturable`` flag: a checkpoint written with or without it loads
    into either (the step count goes where the flag wants it)."""
    saved = dict(saved, param_groups=[
        dict(g, capturable=cur.get("capturable", False))
        for g, cur in zip(saved["param_groups"], opt.param_groups)])
    held = {p: dict(s) for p, s in opt.state.items()}
    opt.load_state_dict(saved)
    with torch.no_grad():
        for p, s in opt.state.items():
            for k, new in s.items():
                old = held.get(p, {}).get(k)
                if (torch.is_tensor(old) and torch.is_tensor(new)
                        and old.shape == new.shape and old.dtype == new.dtype
                        and old.device == new.device):
                    old.copy_(new)
                    s[k] = old


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a train step updates in place: the parameters and
    the optimizer's state (Adam's moments and step counts, once its first
    step has made them)."""
    return [*state.model.parameters(),
            *(v for s in state.optimizer.state.values() for v in s.values()
              if torch.is_tensor(v))]


def maybe_checkpoint_step(train_cfg, state: TrainState, step_index: int,
                          save: Optional[Callable] = None) -> None:
    """Mid-epoch checkpoint cadence (``TrainConfig.checkpoint_every_steps``),
    shared by the pipelined trainers so the cadence cannot drift between
    drivers. ``save(ckpt_dir, state)`` writes it (default
    ``save_checkpoint``; the striped trainers write every rank's
    generator)."""
    if (train_cfg.checkpoint_dir and train_cfg.checkpoint_every_steps
            and (step_index + 1) % train_cfg.checkpoint_every_steps == 0):
        (save or save_checkpoint)(train_cfg.checkpoint_dir, state)
