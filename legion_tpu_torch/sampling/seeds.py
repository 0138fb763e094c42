"""Epoch seed scheduling (the reference's BatchGenerator + Coordinate).

A numpy-only copy of ``legion_tpu/sampling/seeds.py``: the port may not
import ``legion_tpu.sampling``, whose ``__init__`` loads JAX.
``tests/test_torch_sampler.py`` holds the two equal.

Mirrors the step accounting of ``CUDAIPCEnv::Coordinate``
(``src/CUDA_IPC_Service.cu:66-134``):

* train: ``steps = (min_shard_size - 1) // batch`` with the raw batch size
  on every shard (drop-last semantics);
* valid/test: raw batch 512, ``steps = ceil(max_shard_size / 512)``, and a
  per-shard batch of ``ceil(shard_size / steps)`` so all shards finish in
  lockstep — short shards pad with ``-1`` (the reference's
  ``batch_generator`` sentinel, ``src/Kernels.cu:81-87``).

Seed ids come from a per-epoch host permutation of each shard's node set;
batches are therefore unique-within-batch, the invariant the frontier
numbering relies on (see sampling.sampler).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SeedPlan:
    train_steps: int
    valid_steps: int
    test_steps: int
    train_batch: int
    valid_batch: Tuple[int, ...]    # per shard
    test_batch: Tuple[int, ...]


def make_seed_plan(train_counts: List[int], valid_counts: List[int],
                   test_counts: List[int], batch_size: int,
                   eval_batch_size: int = 512) -> SeedPlan:
    def eval_split(counts):
        mx = max(counts) if counts else 0
        steps = 0 if mx == 0 else (mx - 1) // eval_batch_size + 1
        per = tuple(0 if steps == 0 else (c - 1) // steps + 1 for c in counts)
        return steps, per

    min_train = min(train_counts)
    train_steps = max((min_train - 1) // batch_size, 0)
    if min_train > 0 and train_steps == 0:
        raise ValueError(
            f"batch_size {batch_size} too large: smallest train shard has "
            f"{min_train} seeds and drop-last scheduling yields 0 steps "
            "(reference rule train_steps=(min-1)//batch, "
            "src/CUDA_IPC_Service.cu:88)")
    valid_steps, valid_batch = eval_split(valid_counts)
    test_steps, test_batch = eval_split(test_counts)
    return SeedPlan(train_steps=train_steps, valid_steps=valid_steps,
                    test_steps=test_steps, train_batch=batch_size,
                    valid_batch=valid_batch, test_batch=test_batch)


def interleave_shards(per_shard: np.ndarray) -> np.ndarray:
    """(shards, steps, b) -> (steps, shards*b), shard s at columns
    [s*b, (s+1)*b) — the device-put layout every mesh driver feeds its
    step/epoch programs (sharded over the trailing batch dim)."""
    return np.ascontiguousarray(per_shard.swapaxes(0, 1).reshape(
        per_shard.shape[1], -1))


def shard_node_set(ids: np.ndarray, num_shards: int,
                   partition: np.ndarray | None = None) -> List[np.ndarray]:
    """Split a node-id set across DP shards: by partition file when
    available, else ``id % num_shards`` (``src/GPUGraphStore.cu:334-343``).
    """
    if partition is not None:
        return [ids[partition[ids] == s] for s in range(num_shards)]
    return [ids[ids % num_shards == s] for s in range(num_shards)]


def epoch_train_seeds(rng: np.random.Generator, shard_ids: List[np.ndarray],
                      plan: SeedPlan) -> Tuple[np.ndarray, np.ndarray]:
    """Permuted train seeds for one epoch.

    Returns (seeds, valid_counts): seeds (num_shards, steps, batch) int32,
    counts (num_shards, steps) int32 — always full batches (drop-last).
    """
    n = plan.train_steps * plan.train_batch
    out = np.empty((len(shard_ids), plan.train_steps, plan.train_batch),
                   dtype=np.int32)
    for s, ids in enumerate(shard_ids):
        perm = rng.permutation(ids.shape[0])[:n]
        out[s] = ids[perm].reshape(plan.train_steps, plan.train_batch)
    counts = np.full((len(shard_ids), plan.train_steps), plan.train_batch,
                     dtype=np.int32)
    return out, counts


def seeds_of_epoch(seed: int, epoch: int, shard_ids: List[np.ndarray],
                   plan: SeedPlan) -> np.ndarray:
    """Epoch ``epoch``'s (num_shards, steps, batch) train seeds of a run
    seeded ``seed``: ``epoch_train_seeds`` on a generator seeded from the
    two, the one rule of every driver."""
    return epoch_train_seeds(np.random.default_rng(seed * 100003 + epoch),
                             shard_ids, plan)[0]


def epoch_eval_seeds(shard_ids: List[np.ndarray], steps: int,
                     per_shard_batch: Tuple[int, ...], pad_batch: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic eval seeds padded with -1 to a common batch cap.

    pad_batch: the static batch capacity (>= max per-shard batch) so every
    shard/step has the same shape for jit.
    """
    num_shards = len(shard_ids)
    out = np.full((num_shards, steps, pad_batch), -1, dtype=np.int32)
    counts = np.zeros((num_shards, steps), dtype=np.int32)
    for s, ids in enumerate(shard_ids):
        b = per_shard_batch[s]
        for t in range(steps):
            chunk = ids[t * b:(t + 1) * b]
            out[s, t, :chunk.shape[0]] = chunk
            counts[s, t] = chunk.shape[0]
    return out, counts
