"""End-to-end training driver (port of ``legion_tpu/train/loop.py``, the
single-device path with every array in device memory).

The reference fuses a whole epoch into one ``lax.scan`` under
``jax.jit``; here ``make_step_fns`` returns the same two functions,
``epoch_scan`` and ``eval_scan`` (``train/graphed.py``), beside the
eager ``train_step`` and ``eval_step``. On a CUDA device the ``Trainer``
captures its train and eval steps as CUDA graphs and replays them, one
graph launch a step. Nothing inside a step reads a device value on the
host: the loss, edge count and cap overflow of every step stay on the
device and are fetched once per epoch.

Each epoch is an epoch root of ``utils/trace.py`` (``epoch.prepare``:
``epoch.seeds``, ``epoch.labels``, ``epoch.load``; ``epoch.steps``;
``epoch.prefetch``; ``epoch.read``; ``epoch.record``), and its record
carries the root's ``spans`` and ``counts``; an evaluation is an
``eval`` root. While an epoch's steps run on the device the host draws
the next epoch's seeds and labels (``epoch.prefetch``), which the next
call takes when it is that epoch of the same shard and plan (counter
``seeds_prefetched``) and draws afresh otherwise. With
``train.profile_dir`` set, epoch 0 runs under ``torch.profiler``
(``trace.profiled``) and its trace is written into that directory. On a
CUDA device that trace holds the epoch's first step (run eagerly, as the
capture's warm-up), the capture and the replays of the other steps, as
the reference's epoch-0 trace holds the compile of its jitted epoch.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from legion_tpu_torch.cache.hotness import (observed_caps,
                                            probe_frontier_maxima)
from legion_tpu_torch.config import Config
from legion_tpu_torch.data.format import GraphData, pad_feature_dim
from legion_tpu_torch.models import build_model, model_args
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import (DeviceGraph, gather_features,
                                               sample_batch)
from legion_tpu_torch.sampling.seeds import (epoch_eval_seeds,
                                             make_seed_plan, seeds_of_epoch,
                                             shard_node_set)
from legion_tpu_torch.train.graphed import (MODEL_COUNTS, EpochScan,
                                            EvalScan, GraphPool)
from legion_tpu_torch.train.train_state import (TrainState,
                                                create_train_state,
                                                restore_checkpoint,
                                                save_checkpoint)
from legion_tpu_torch.utils import trace
from legion_tpu_torch.utils.logging import eval_labels, log_metrics


def sum_edge_counts(per_step: torch.Tensor) -> int:
    """Exact epoch edge total from per-step counts (int32, or float64
    summed over ranks), reduced on the host in int64 (an int32 sum wraps
    past 2^31)."""
    return int(per_step.cpu().to(torch.int64).sum())


def masked_softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the valid seeds, reduced in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -logp.gather(1, safe[:, None])[:, 0]
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def lp_logsigmoid_sum(emb: torch.Tensor, mask: torch.Tensor):
    """Link-prediction loss SUM and valid-pair count: the thirds of the
    batch are (anchor, positive, negative), and a pair costs
    -logsigmoid(a.p) - logsigmoid(-(a.n)); a pair counts when all three of
    its seeds are valid. Reduced in float32. Eval accumulates this
    (sum, pairs) form, so that a partial last batch weighs by its real
    pairs."""
    emb = emb.float()
    third = emb.shape[0] // 3
    a, p, n = emb[:third], emb[third:2 * third], emb[2 * third:3 * third]
    m = (mask[:third] & mask[third:2 * third] & mask[2 * third:3 * third])
    mf = m.float()
    pos = F.logsigmoid((a * p).sum(-1))
    neg = F.logsigmoid(-(a * n).sum(-1))
    return -((pos * mf).sum() + (neg * mf).sum()), m.sum(dtype=torch.int32)


def lp_logsigmoid_loss(emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean LP loss per valid pair (the train objective)."""
    s, pairs = lp_logsigmoid_sum(emb, mask)
    return s / pairs.float().clamp(min=1.0)


def make_objective(cfg: Config):
    """(loss_of, counts_of) over a model's output and its batch, shared by
    both drivers' step functions. ``loss_of`` is the train objective: the
    masked cross-entropy, or for ``lp_sage`` the mean LP loss per pair.
    ``counts_of`` is what eval accumulates: the (correct, valid) seed
    counts as int32 device tensors, or for ``lp_sage`` the (LP loss sum,
    valid-pair count); either way the epoch's a / b weighs a partial
    batch by its real contents."""
    is_lp = cfg.model.arch == "lp_sage"

    def loss_of(out, batch):
        out, mask = out[: batch.seed_cap], batch.seed_mask()
        if is_lp:
            return lp_logsigmoid_loss(out, mask)
        return masked_softmax_ce(out, batch.labels, mask)

    def counts_of(out, batch):
        out, mask = out[: batch.seed_cap], batch.seed_mask()
        if is_lp:
            return lp_logsigmoid_sum(out, mask)
        return (((out.argmax(-1) == batch.labels) & mask).sum(
            dtype=torch.int32), mask.sum(dtype=torch.int32))

    return loss_of, counts_of


class StepFns(NamedTuple):
    """Step functions built by make_step_fns."""
    train_step: Callable
    eval_step: Callable
    epoch_scan: EpochScan
    eval_scan: EvalScan


def make_step_fns(cfg: Config, caps: Sequence[int],
                  reducer: Optional[Callable] = None,
                  feature_fetch: Optional[Callable] = None,
                  sampler: Optional[Callable] = None,
                  pool: Optional[GraphPool] = None,
                  uniform_shapes: Optional[Sequence] = None) -> StepFns:
    """Build (train_step, eval_step, epoch_scan, eval_scan) for static
    frontier caps. The scans run every step of an epoch from static
    buffers (``train/graphed.py``): captured as CUDA graphs in ``pool``
    where it captures, eagerly otherwise (no pool, or the CPU).

    Randomness comes from ``state.generator`` (train) or the given
    ``generator`` (eval); parity tests pass per-hop ``uniforms`` instead
    (see sampler.sample_batch), and dropout still draws from the
    generator. ``reducer(model)``, when given, runs between the backward
    pass and the optimizer step: the data-parallel gradient mean
    (``parallel/dp.py``; the reference's ``shard_axes``).
    ``feature_fetch(feats, frontier)`` replaces the gather of the
    frontier's rows (default ``gather_features``); it may return (rows,
    overflow), whose () int32 overflow (requests the striped exchange had
    to cap, read as zero rows) is added to the step's ``cap_overflow``.
    ``sampler(graph, seeds, num_seeds, labels, generator, uniforms)``
    replaces ``sample_batch`` (the edge-partitioned path's, whose
    ``graph`` is the rank's shard); it is handed the generator or the
    uniforms, whichever the step was given, and ``uniform_shapes`` are
    then its uniforms' shapes (default: ``(cap, fanout)`` a hop)."""
    fanouts = tuple(cfg.sampler.fanouts)
    dedup_last = cfg.sampler.dedup_last
    caps = tuple(caps)
    loss_of, counts_of = make_objective(cfg)
    fetch = feature_fetch or gather_features

    def features(feats, frontier):
        x = fetch(feats, frontier)
        if isinstance(x, tuple):
            return x
        return x, None

    def sample(graph, seeds, num_seeds, labels, generator, uniforms):
        if sampler is not None:
            return sampler(graph, seeds, num_seeds, labels,
                           None if uniforms is not None else generator,
                           uniforms)
        return sample_batch(graph, seeds, num_seeds, labels, fanouts, caps,
                            dedup_last=dedup_last,
                            generator=None if uniforms is not None
                            else generator,
                            uniforms=uniforms)

    def device_step(state: TrainState, graph: DeviceGraph, feats, seeds,
                    num_seeds, labels,
                    uniforms=None) -> Dict[str, torch.Tensor]:
        """``train_step`` on the device alone: the step the scan captures
        (the host counts ``state.step``)."""
        batch = sample(graph, seeds, num_seeds, labels, state.generator,
                       uniforms)
        x, fetch_overflow = features(feats, batch.frontier)
        out = state.model(tuple(reversed(batch.blocks)), x,
                          deterministic=False, generator=state.generator)
        loss = loss_of(out, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if reducer is not None:
            reducer(state.model)
        state.optimizer.step()
        edges = torch.stack([b.num_edges() for b in batch.blocks]).sum(
            dtype=torch.int32)
        # Static caps drop frontier ids beyond capacity, silently thinning
        # sampled neighborhoods: surface it (> 0 means loosen the caps).
        overflow = torch.zeros((), dtype=torch.int32, device=seeds.device)
        for blk, cap in zip(batch.blocks, caps[1:]):
            if blk.identity_offset is None:
                overflow = overflow + (blk.num_src - cap).clamp(min=0)
        if fetch_overflow is not None:
            overflow = overflow + fetch_overflow
        metrics = {"loss": loss.detach(), "edges": edges,
                   "frontier": batch.num_frontier, "cap_overflow": overflow}
        # the model's own counters (block k's layer takes the frontier's
        # rows up to caps[k + 1]); 0 for those it does not count
        step_counts = getattr(state.model, "step_counts", None)
        if step_counts is not None:
            metrics.update(step_counts(batch.blocks, caps[1:]))
        for name in MODEL_COUNTS:
            if name not in metrics:
                metrics[name] = torch.zeros((), dtype=torch.int32,
                                            device=seeds.device)
        return metrics

    def train_step(state: TrainState, graph: DeviceGraph, feats, seeds,
                   num_seeds, labels,
                   uniforms=None) -> Dict[str, torch.Tensor]:
        """One sampled mini-batch: forward, backward and an Adam update of
        ``state`` in place. Returns the step's metrics as device tensors."""
        metrics = device_step(state, graph, feats, seeds, num_seeds, labels,
                              uniforms)
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(model, graph: DeviceGraph, feats, seeds, num_seeds, labels,
                  generator=None, uniforms=None):
        """(correct, valid) seed counts of one batch as int32 device
        tensors; for ``lp_sage`` the (LP loss sum, valid-pair count), so
        that the epoch's a / b is the pair-weighted mean loss."""
        batch = sample(graph, seeds, num_seeds, labels, generator, uniforms)
        x, _ = features(feats, batch.frontier)
        out = model(tuple(reversed(batch.blocks)), x, deterministic=True)
        return counts_of(out, batch)

    shapes = uniform_shapes or [(c, f) for c, f in zip(caps, fanouts)]
    return StepFns(train_step=train_step, eval_step=eval_step,
                   epoch_scan=EpochScan(device_step, pool, shapes),
                   eval_scan=EvalScan(eval_step, pool, shapes))


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed of data-parallel rank ``rank``: ``seed`` itself
    on rank 0 (so that rank 0 draws the single-device stream), a stream
    of its own on every other rank."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0] >> 1)


class EpochDraw(NamedTuple):
    """An epoch's train seeds of one shard and their labels, with what
    they were drawn for: ``key`` (run seed, epoch, shard index, plan) and
    the shard id arrays themselves, matched by identity."""
    key: Tuple
    shards: Tuple[np.ndarray, ...]
    seeds: np.ndarray
    labels: np.ndarray

    def serves(self, key: Tuple, shards: Sequence[np.ndarray]) -> bool:
        return (self.key == key and len(self.shards) == len(shards)
                and all(a is b for a, b in zip(self.shards, shards)))


class Trainer:
    """Single-device trainer with the topology and the whole feature table
    in device memory, whatever ``feature_placement`` says (as the
    reference's ``Trainer`` does). ``device`` is required: the trainer
    never picks one itself. It raises on ``topology_placement="host"``
    (``train.hybrid_driver.run_hybrid_training``) and on
    ``CacheConfig(enabled=True)`` (``train.cached_driver``).

    ``num_shards > 1`` splits the seeds as the data-parallel drivers do;
    ``train_one_epoch`` and ``evaluate`` then run one shard's seeds on
    this one device, with no collective (``parallel.trainer.MeshTrainer``
    runs every shard at once).

    With ``train.checkpoint_dir`` set, the trainer restores the latest
    checkpoint of that directory when it is built, ``fit`` saves one after
    every epoch, and a fresh trainer on the same directory goes on from
    the saved epoch."""

    log_suffix = ""                 # appended to each epoch's log line
    # the steps are captured as CUDA graphs on a CUDA device (MeshTrainer:
    # on a NCCL group only)
    capture_steps = True

    def __init__(self, cfg: Config, data: GraphData,
                 device: torch.device | str, num_shards: int = 1):
        if cfg.dataset.topology_placement != "hbm":
            raise ValueError(
                f"Trainer keeps the topology in device memory; "
                f"topology_placement={cfg.dataset.topology_placement!r} runs "
                "through "
                "legion_tpu_torch.train.hybrid_driver.run_hybrid_training")
        if cfg.cache.enabled:
            raise ValueError(
                "Trainer keeps the whole feature table in device memory; "
                "CacheConfig(enabled=True) runs through "
                "legion_tpu_torch.train.cached_driver.run_cached_training")
        self._setup(cfg, data, device, num_shards, probe=True)

    def _setup(self, cfg: Config, data: GraphData, device, num_shards: int,
               probe: bool, rank: int = 0, world: int = 1) -> None:
        """Graph and whole feature table on ``device``, the shards and
        their seed plan, the caps, the model, a state whose generator
        draws rank ``rank``'s stream (restored from the checkpoint, which
        ``world`` ranks wrote, when there is one) and the step functions
        (``_step_fns``)."""
        self.cfg = cfg
        self.data = data
        self.device = torch.device(device)

        self.graph = DeviceGraph.from_host(data.indptr, data.indices,
                                           self.device)
        feats = pad_feature_dim(np.asarray(data.features, np.float32),
                                cfg.dataset.feature_pad_align or 1)
        self.features = self._place_features(feats)

        self.shards_train = shard_node_set(data.train_ids, num_shards)
        self.shards_valid = shard_node_set(data.valid_ids, num_shards)
        self.shards_test = shard_node_set(data.test_ids, num_shards)
        self.plan = make_seed_plan(
            [len(s) for s in self.shards_train],
            [max(len(s), 1) for s in self.shards_valid],
            [max(len(s), 1) for s in self.shards_test],
            cfg.sampler.batch_size, cfg.sampler.eval_batch_size)

        self.caps = frontier_caps(cfg.sampler.batch_size, cfg.sampler.fanouts)
        self.eval_caps = frontier_caps(cfg.sampler.eval_batch_size,
                                       cfg.sampler.fanouts)
        if (probe and cfg.sampler.probe_caps
                and self.caps[-1] >= cfg.sampler.probe_caps_min_cap):
            self.caps = self._probe_caps()

        num_classes = cfg.dataset.num_classes or data.num_classes
        self.model = build_model(**model_args(
            cfg.model, self.features.shape[1], num_classes,
            cfg.train.seed)).to(self.device)
        self.state = create_train_state(self.model, cfg.train.learning_rate,
                                        rank_seed(cfg.train.seed, rank),
                                        self.device)
        if cfg.train.checkpoint_dir:
            restore_checkpoint(cfg.train.checkpoint_dir, self.state,
                               rank=rank, world=world)
        # the train and eval graphs share one pool; eval draws from a
        # generator of its own, seeded at each evaluation
        pool = GraphPool(self.device) if self.capture_steps else None
        self.fns = self._step_fns(self.caps, pool)
        self.fns_eval = self._step_fns(self.eval_caps, pool)
        self.eval_generator = torch.Generator(device=self.device)
        self.history: list[Dict] = []
        # the next epoch's draw, made while this epoch's steps ran
        self.prefetched: Optional[EpochDraw] = None

    def _step_fns(self, caps: Sequence[int],
                  pool: Optional[GraphPool]) -> StepFns:
        """The step functions at ``caps``: the frontier's rows come from
        the whole table on the device."""
        return make_step_fns(self.cfg, caps, pool=pool)

    def _place_features(self, feats: np.ndarray) -> torch.Tensor:
        """The feature table as the steps read it: the whole (padded)
        table on the device."""
        return torch.from_numpy(np.ascontiguousarray(feats)).to(self.device)

    def _probe_caps(self):
        """Tighten static frontier caps to slack x the maxima realized on
        a few probe batches at loose caps (the reference's 1.2 x observed
        MaxIdNum sizing). The last cap is exact when the final hop is
        identity-appended. Reads the counts on the host: a set-up sync
        (the span ``setup.cap_probe``)."""
        cfg = self.cfg
        b = cfg.sampler.batch_size
        fanouts = tuple(cfg.sampler.fanouts)
        loose = frontier_caps(b, fanouts)
        rng = np.random.default_rng(cfg.train.seed * 7919 + 1)
        ids = np.asarray(self.shards_train[0])

        def seed_batches():
            for _ in range(cfg.sampler.probe_caps_batches):
                seeds = rng.permutation(ids)[:b].astype(np.int32)
                n = len(seeds)
                seeds = np.pad(seeds, (0, b - n), constant_values=-1)
                yield (torch.from_numpy(seeds).to(self.device),
                       torch.tensor(n, dtype=torch.int32,
                                    device=self.device))

        with trace.span("setup.cap_probe"):
            mx = probe_frontier_maxima(
                self.graph, seed_batches(), fanouts, loose,
                torch.Generator(device=self.device).manual_seed(1000))
        caps = list(observed_caps(mx, cfg.sampler.observed_cap_slack,
                                  align=128))
        caps = [min(c, lo) for c, lo in zip(caps, loose)]
        if not cfg.sampler.dedup_last:   # identity append: exact extent
            caps[-1] = caps[-2] * (1 + fanouts[-1])
        caps = tuple(caps)
        log_metrics({"event": "cap_probe", "observed": mx.tolist(),
                     "caps": list(caps), "loose": list(loose)})
        return caps

    # -- epoch loops --------------------------------------------------------

    def _labels_of(self, seeds: np.ndarray) -> np.ndarray:
        return np.asarray(self.data.labels, np.int32)[seeds]

    def _load_epoch(self, seeds: np.ndarray, labels: np.ndarray,
                    uniforms: Optional[Callable]):
        """The epoch scan's run loaded with (steps, batch) seeds and their
        labels (the span ``epoch.load``)."""
        with trace.span("epoch.load"):
            return self.fns.epoch_scan.load(
                self.state, self.graph, self.features,
                torch.from_numpy(seeds), torch.from_numpy(labels), uniforms)

    def _train_steps(self, seeds: np.ndarray,
                     uniforms: Optional[Callable]) -> torch.Tensor:
        """Train on (steps, batch) seeds through ``epoch_scan``; returns
        the steps' (loss, edges, frontier, cap_overflow, attn_slots) as a
        (steps, 5) float64 device tensor. ``uniforms(step, hop)`` replaces the
        generator's sampling draws (parity tests); ``step`` is the state's
        global step."""
        with trace.span("epoch.labels"):
            labels = self._labels_of(seeds)
        run = self._load_epoch(seeds, labels, uniforms)
        return self.fns.epoch_scan.replay(run, self.state, self.graph,
                                          self.features, seeds.shape[0],
                                          uniforms)

    def _draw_epoch(self, epoch: int, shards, which: int) -> EpochDraw:
        """Epoch ``epoch``'s seeds of shard ``which`` of ``shards``
        (``seeds_of_epoch``) and their labels."""
        seeds = seeds_of_epoch(self.cfg.train.seed, epoch, shards,
                               self.plan)[which]
        return EpochDraw(self._draw_key(epoch, which), tuple(shards), seeds,
                         self._labels_of(seeds))

    def _draw_key(self, epoch: int, which: int) -> Tuple:
        return (self.cfg.train.seed, epoch, which, self.plan)

    def _take_epoch(self, epoch: int, shards, which: int):
        """(seeds, labels) of epoch ``epoch``, shard ``which``: the held
        draw (``prefetched``, counted ``seeds_prefetched``) where it was
        drawn for them, else drawn now; the held draw is dropped either
        way. The spans ``epoch.seeds`` and ``epoch.labels``."""
        held, self.prefetched = self.prefetched, None
        hit = held is not None and held.serves(self._draw_key(epoch, which),
                                               shards)
        if hit:
            trace.count("seeds_prefetched", 1)
        with trace.span("epoch.seeds"):
            seeds = held.seeds if hit else seeds_of_epoch(
                self.cfg.train.seed, epoch, shards, self.plan)[which]
        with trace.span("epoch.labels"):
            labels = held.labels if hit else self._labels_of(seeds)
        return seeds, labels

    def _epoch_record(self, epoch: int, metrics: torch.Tensor,
                      dt: float) -> Dict:
        """The epoch's record from its (steps, 5) host metrics; each
        counter the model counted (``MODEL_COUNTS``, non-zero) goes to the
        tracer under its name."""
        losses = metrics[:, 0].to(torch.float32).numpy()
        overflow = int(metrics[:, 3].sum())
        for col, name in enumerate(MODEL_COUNTS, 4):
            total = sum_edge_counts(metrics[:, col])
            if total:
                trace.count(name, total)
        if overflow > 0:
            log_metrics({"event": "cap_overflow", "epoch": epoch,
                         "dropped_frontier_ids": overflow,
                         "hint": "raise sampler.observed_cap_slack"})
        rec = {"epoch": epoch, "loss": float(losses[-1]),
               "mean_loss": float(losses.mean()), "losses": losses.tolist(),
               "steps": self.plan.train_steps, "epoch_s": dt,
               "edges_per_s": sum_edge_counts(metrics[:, 1]) / dt,
               "cap_overflow": overflow}
        self.history.append(rec)
        log_metrics({"event": "train_epoch", **rec})
        return rec

    def _read_metrics(self, metrics: torch.Tensor) -> torch.Tensor:
        """The epoch's (steps, 5) metrics on the host: its only device ->
        host read."""
        return metrics.cpu()

    def _profiled(self, epoch: int):
        """``torch.profiler`` around epoch 0 when ``train.profile_dir`` is
        set (``trace.profiled``), else nothing."""
        if epoch != 0:
            return contextlib.nullcontext()
        return trace.profiled(self.cfg.train, epoch, self.device)

    def train_one_epoch(self, epoch: int, shard: int = 0,
                        uniforms: Optional[Callable] = None) -> Dict:
        return self._train_epoch(epoch, [self.shards_train[shard]], 0,
                                 uniforms)

    def _train_epoch(self, epoch: int, shards, which: int,
                     uniforms: Optional[Callable]) -> Dict:
        """One epoch of shard ``which`` of the lockstep seeds of
        ``shards``, as an epoch root whose spans and counts the record
        carries. Once the steps are queued, and before their metrics are
        read, epoch ``epoch + 1``'s seeds and labels are drawn and held
        (``epoch.prefetch``), whatever the run's epoch count: the window
        of a caller may run past it. ``epoch_s`` is the root's seconds up
        to the record less its ``epoch.seeds``: from the seeds' end to
        the metrics' read."""
        with self._profiled(epoch), trace.epoch("train") as root:
            with trace.span("epoch.prepare"):
                seeds, labels = self._take_epoch(epoch, shards, which)
                run = self._load_epoch(seeds, labels, uniforms)
            root.steps = seeds.shape[0]
            with trace.span("epoch.steps"):
                metrics = self.fns.epoch_scan.replay(
                    run, self.state, self.graph, self.features, root.steps,
                    uniforms)
            with trace.span("epoch.prefetch"):
                self.prefetched = self._draw_epoch(epoch + 1, shards, which)
            with trace.span("epoch.read"):
                metrics = self._read_metrics(metrics)
            with trace.span("epoch.record"):
                rec = self._epoch_record(epoch, metrics, root.elapsed()
                                         - trace.seconds(root.tally,
                                                         "epoch.seeds"))
        rec["spans"], rec["counts"] = root.entry["spans"], root.entry["counts"]
        return rec

    def _eval_counts(self, seeds: np.ndarray, counts: np.ndarray, seed: int,
                     uniforms: Optional[Callable]) -> torch.Tensor:
        """(correct, valid) summed over (steps, cap) eval seeds through
        ``eval_scan``, as a float32 device pair; for ``lp_sage`` the (LP
        loss sum, pairs). The eval generator restarts from ``seed``. The
        labels and the load are the spans ``epoch.labels`` and
        ``epoch.load``, the steps ``epoch.steps``."""
        with trace.span("epoch.labels"):
            labels_all = np.asarray(self.data.labels)
            lab = np.where(seeds >= 0, labels_all[np.clip(seeds, 0, None)],
                           -1).astype(np.int32)
        scan = self.fns_eval.eval_scan
        with trace.span("epoch.load"):
            self.eval_generator.manual_seed(seed)
            run = scan.load(self.model, self.graph, self.features,
                            torch.from_numpy(seeds), torch.from_numpy(counts),
                            torch.from_numpy(lab), self.eval_generator,
                            uniforms)
        with trace.span("epoch.steps"):
            return scan.replay(run, self.model, self.graph, self.features,
                               self.eval_generator, seeds.shape[0], uniforms)

    def _eval_seeds(self, which: str):
        """Every shard's (seeds, counts) of the valid or test set, in the
        lockstep plan: (shards, steps, cap), short shards padded with -1."""
        shards = self.shards_valid if which == "valid" else self.shards_test
        steps = (self.plan.valid_steps if which == "valid"
                 else self.plan.test_steps)
        per = (self.plan.valid_batch if which == "valid"
               else self.plan.test_batch)
        return epoch_eval_seeds(shards, steps, per,
                                self.cfg.sampler.eval_batch_size)

    def evaluate(self, which: str = "valid", shard: int = 0,
                 uniforms: Optional[Callable] = None) -> float:
        """Accuracy over one shard's valid or test seeds; for ``lp_sage``
        the mean LP loss per valid pair (lower is better)."""
        with trace.epoch("eval") as root:
            with trace.span("epoch.seeds"):
                seeds, counts = self._eval_seeds(which)
            root.steps = seeds.shape[1]
            pair = self._eval_counts(seeds[shard], counts[shard], 12345,
                                     uniforms)
            with trace.span("epoch.read"):
                c, n = pair.tolist()
        return c / max(n, 1.0)

    def save_checkpoint(self) -> None:
        """Write the state into ``train.checkpoint_dir``."""
        save_checkpoint(self.cfg.train.checkpoint_dir, self.state)

    def fit(self, epochs: Optional[int] = None,
            log: Callable[[str], None] = print) -> Dict:
        """Train to ``epochs`` with validation after each (a checkpoint
        after each too, with ``train.checkpoint_dir``), then test."""
        epochs = epochs or self.cfg.train.epochs
        start = self.state.epoch
        if start > 0:
            log(f"resumed from checkpoint at epoch {start}")
        vlab, tlab = eval_labels(self.cfg)
        for epoch in range(start, epochs):
            rec = self.train_one_epoch(epoch)
            acc = self.evaluate("valid")
            self.state.epoch = epoch + 1
            log(f"Epoch:{epoch}, Cost:{rec['epoch_s']:.3f} s, "
                f"Loss:{rec['loss']:.4f}, {vlab}: {acc:.4f}, "
                f"edges/s: {rec['edges_per_s']:.3e}{self.log_suffix}")
            rec["valid"] = acc
            if self.cfg.train.checkpoint_dir:
                self.save_checkpoint()
        test_acc = self.evaluate("test")
        log(f"{tlab}: {test_acc:.4f}")
        return {"test_acc": test_acc, "history": self.history}
