"""Data-parallel trainer: the full lifecycle (epochs, validation, test,
checkpoint and resume) over ranks of ``torch.distributed``, each with the
CSR in its device's memory and the whole feature table or, with
``feature_placement="hbm_sharded"``, its cache group's stripe of it
(counterpart of ``legion_tpu/parallel/trainer.py``; the reference's
per-GPU runners and DDP clients, ``src/Server.cu:116-133``,
``legion_graphsage.py:149-181``).

Run one ``MeshTrainer`` in every rank of an initialized process group
(``parallel.mesh.spawn`` starts them; ``fit_rank`` is the rank body the
command line uses). Each rank draws its own batch of
``cfg.sampler.batch_size`` seeds from its shard (``id % world``) in the
lockstep seed plan, trains it, and ``dp.GradMean`` averages the gradients
in one all-reduce a step. The caps are the loose ``frontier_caps``, as in
the reference (no probe). Rank r's generator draws its own stream
(``train.loop.rank_seed``: rank 0's is the ``Trainer``'s). The step
functions are ``dp.make_dp_epoch_fns``'. The step's metrics stay on the
device; one small all-reduce an epoch sums them over
the ranks (the loss is then divided by the world size), and one more an
evaluation sums the eval counts.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from legion_tpu_torch.config import Config
from legion_tpu_torch.data.format import GraphData
from legion_tpu_torch.parallel.dp import (make_dp_epoch_fns,
                                          put_striped_features,
                                          save_every_rank)
from legion_tpu_torch.parallel.mesh import Mesh, captures_steps, make_mesh
from legion_tpu_torch.train.loop import StepFns, Trainer, rank_seed
from legion_tpu_torch.utils import comm, trace


class MeshTrainer(Trainer):
    """Data-parallel trainer over the (data x cache) ranks of the process
    group, one rank per device; the global batch is world x
    ``cfg.sampler.batch_size``. ``feature_placement`` "hbm" (or any other
    value) puts the whole table on every device; "hbm_sharded" stripes it
    over the cache group (row r on its rank r % k, ``dp.put_striped_features``)
    and each step fetches the frontier's rows through the exact exchange
    (``parallel.feature_exchange.sharded_row_fetch_stats``, at the
    probe-free owner cap), whose capped requests count in
    ``cap_overflow``. On a cache axis of one the stripe is the whole
    table and the exchange runs through a group of one rank.

    On a NCCL group its train and eval steps are captured as CUDA graphs
    with their collectives inside (the gradient's all-reduce, the
    exchange's two all-to-alls), and every later step replays them, as
    the reference runs each epoch as one ``jit(shard_map(scan))``
    program (``make_dp_epoch_fns``); under gloo (the CPU, the
    share-device mode) the same static-buffer steps run eagerly. The
    epoch's metrics all-reduce and the eval counts' run outside the
    graphs, one each."""

    @property
    def capture_steps(self) -> bool:
        return captures_steps(self.device)

    def __init__(self, cfg: Config, data: GraphData,
                 device: torch.device | str, mesh: Optional[Mesh] = None):
        mesh = mesh if mesh is not None else make_mesh(cfg.cache.group_size)
        if cfg.parallel.num_devices not in (0, mesh.world):
            raise ValueError(
                f"ParallelConfig(num_devices={cfg.parallel.num_devices}) "
                f"but the process group has {mesh.world} ranks")
        self.mesh = mesh
        self.sharded_features = (
            cfg.dataset.feature_placement == "hbm_sharded")
        self.rank = mesh.rank
        self.log_suffix = f" [mesh {mesh.shape}]"
        self._setup(cfg, data, device, mesh.world, probe=False,
                    rank=mesh.rank, world=mesh.world)

    def _step_fns(self, caps, pool) -> StepFns:
        return make_dp_epoch_fns(self.cfg, self.model, caps, self.mesh,
                                 self.sharded_features, pool)

    def _place_features(self, feats: np.ndarray) -> torch.Tensor:
        if self.sharded_features:
            return put_striped_features(feats, self.mesh, self.device)
        return super()._place_features(feats)

    def train_one_epoch(self, epoch: int,
                        uniforms: Optional[Callable] = None) -> Dict:
        """One epoch of this rank's shard in lockstep with the others;
        the record holds the figures of all ranks (mean loss per step,
        summed edges and overflow)."""
        return self._train_epoch(epoch, self.shards_train, self.rank,
                                 uniforms)

    def _profiled(self, epoch: int):
        """Nothing: the ranks do not profile (``train.profile_dir`` is not
        read here)."""
        return contextlib.nullcontext()

    def _read_metrics(self, metrics: torch.Tensor) -> torch.Tensor:
        """The epoch's metrics summed over the ranks (one all-reduce), on
        the host, the loss the mean."""
        metrics = super()._read_metrics(comm.all_reduce(metrics))
        metrics[:, 0] /= self.mesh.world
        return metrics

    def evaluate(self, which: str = "valid",
                 uniforms: Optional[Callable] = None) -> float:
        """Accuracy (``lp_sage``: the mean LP loss per pair) over every
        rank's share of the valid or test seeds; ranks whose shard ran
        short evaluate -1 padding. Each rank's eval generator draws its
        own stream."""
        c, n = self.eval_counts(which, uniforms)
        return c / max(n, 1.0)

    def eval_counts(self, which: str = "valid",
                    uniforms: Optional[Callable] = None):
        """(correct, valid) counts of the valid or test set summed over
        the ranks (``lp_sage``: LP loss sum and valid pairs)."""
        with trace.epoch("eval") as root:
            with trace.span("epoch.seeds"):
                seeds, counts = self._eval_seeds(which)
            root.steps = seeds.shape[1]
            pair = self._eval_counts(seeds[self.rank], counts[self.rank],
                                     rank_seed(12345, self.rank), uniforms)
            with trace.span("epoch.read"):
                c, n = comm.all_reduce(pair.to(torch.float64)).tolist()
        return c, n

    def save_checkpoint(self) -> None:
        """Rank 0 writes the shared model and optimizer with every rank's
        generator state."""
        save_every_rank(self.cfg.train.checkpoint_dir, self.state)

    def fit(self, epochs: Optional[int] = None,
            log: Callable[[str], None] = print) -> Dict:
        """``Trainer.fit`` in every rank; rank 0 logs."""
        res = super().fit(epochs, log if self.rank == 0 else _quiet)
        return {**res, "mesh": self.mesh.shape}


def _quiet(_: str) -> None:
    pass


def fit_rank(device: torch.device, cfg_json: str, load: Callable,
             load_kwargs: Dict) -> None:
    """A rank's whole run, as ``parallel.mesh.spawn`` calls it: load the
    dataset here (``load(**load_kwargs)``: a packed directory by mmap, or
    a synthetic graph regenerated from its seed; nothing large crosses the
    spawn) and fit a ``MeshTrainer`` on it."""
    MeshTrainer(Config.from_json(cfg_json), load(**load_kwargs),
                device).fit()
