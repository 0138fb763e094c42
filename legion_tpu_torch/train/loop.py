"""End-to-end training driver (port of ``legion_tpu/train/loop.py``, the
single-device path with every array in device memory).

The reference fuses a whole epoch into one ``lax.scan``; here an epoch is
a Python loop of ``train_step`` calls. Nothing inside a step reads a
device value on the host: the loss, edge count and cap overflow of every
step stay on the device and are fetched once per epoch, so the host runs
ahead of the device and a later change can capture the step as a CUDA
graph.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from legion_tpu_torch.cache.hotness import observed_caps
from legion_tpu_torch.config import Config
from legion_tpu_torch.data.format import GraphData, pad_feature_dim
from legion_tpu_torch.models import build_model
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import (DeviceGraph, gather_features,
                                               sample_batch)
from legion_tpu_torch.sampling.seeds import (epoch_eval_seeds,
                                             epoch_train_seeds,
                                             make_seed_plan, shard_node_set)
from legion_tpu_torch.train.train_state import (TrainState,
                                                create_train_state,
                                                restore_checkpoint,
                                                save_checkpoint)
from legion_tpu_torch.utils.logging import eval_labels, log_metrics


def sum_edge_counts(per_step: torch.Tensor) -> int:
    """Exact epoch edge total from per-step int32 counts, reduced on the
    host in int64 (an int32 sum wraps past 2^31)."""
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


def make_step_fns(cfg: Config, caps: Sequence[int]) -> StepFns:
    """Build (train_step, eval_step) for static frontier caps.

    Randomness comes from ``state.generator`` (train) or the given
    ``generator`` (eval); parity tests pass per-hop ``uniforms`` instead
    (see sampler.sample_batch), and dropout still draws from the
    generator."""
    fanouts = tuple(cfg.sampler.fanouts)
    dedup_last = cfg.sampler.dedup_last
    caps = tuple(caps)
    loss_of, counts_of = make_objective(cfg)

    def sample(graph, seeds, num_seeds, labels, generator, uniforms):
        return sample_batch(graph, seeds, num_seeds, labels, fanouts, caps,
                            dedup_last=dedup_last,
                            generator=None if uniforms is not None
                            else generator,
                            uniforms=uniforms)

    def train_step(state: TrainState, graph: DeviceGraph, feats, seeds,
                   num_seeds, labels,
                   uniforms=None) -> Dict[str, torch.Tensor]:
        """One sampled mini-batch: forward, backward and an Adam update of
        ``state`` in place. Returns the step's metrics as device tensors."""
        batch = sample(graph, seeds, num_seeds, labels, state.generator,
                       uniforms)
        x = gather_features(feats, batch.frontier)
        out = state.model(tuple(reversed(batch.blocks)), x,
                          deterministic=False, generator=state.generator)
        loss = loss_of(out, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        edges = torch.stack([b.num_edges() for b in batch.blocks]).sum(
            dtype=torch.int32)
        # Static caps drop frontier ids beyond capacity, silently thinning
        # sampled neighborhoods: surface it (> 0 means loosen the caps).
        overflow = torch.zeros((), dtype=torch.int32, device=seeds.device)
        for blk, cap in zip(batch.blocks, caps[1:]):
            if blk.identity_offset is None:
                overflow = overflow + (blk.num_src - cap).clamp(min=0)
        return {"loss": loss.detach(), "edges": edges,
                "frontier": batch.num_frontier, "cap_overflow": overflow}

    @torch.no_grad()
    def eval_step(model, graph: DeviceGraph, feats, seeds, num_seeds, labels,
                  generator=None, uniforms=None):
        """(correct, valid) seed counts of one batch as int32 device
        tensors; for ``lp_sage`` the (LP loss sum, valid-pair count), so
        that the epoch's a / b is the pair-weighted mean loss."""
        batch = sample(graph, seeds, num_seeds, labels, generator, uniforms)
        x = gather_features(feats, batch.frontier)
        out = model(tuple(reversed(batch.blocks)), x, deterministic=True)
        return counts_of(out, batch)

    return StepFns(train_step=train_step, eval_step=eval_step)


class Trainer:
    """Single-device trainer with the topology and features in device
    memory. ``device`` is required: the trainer never picks one itself.
    Host-resident features behind the cache (``feature_placement="host"``,
    ``CacheConfig(enabled=True)``) go through
    ``train.cached_driver.run_cached_training`` instead; the trainer
    raises on either.

    With ``train.checkpoint_dir`` set, the trainer restores the latest
    checkpoint of that directory when it is built, ``fit`` saves one after
    every epoch, and a fresh trainer on the same directory goes on from
    the saved epoch. Not ported yet (each raises when set):
    ``train.profile_dir`` and ``num_shards > 1``."""

    def __init__(self, cfg: Config, data: GraphData,
                 device: torch.device | str, num_shards: int = 1):
        for unsupported, what in ((num_shards != 1, "num_shards > 1"),
                                  (cfg.train.profile_dir, "profile_dir")):
            if unsupported:
                raise NotImplementedError(
                    f"{what} is not ported to legion_tpu_torch yet "
                    "(queued in ROADMAP.md)")
        if cfg.dataset.topology_placement != "hbm":
            raise ValueError(
                f"Trainer keeps the topology in device memory; "
                f"topology_placement={cfg.dataset.topology_placement!r} runs "
                "through "
                "legion_tpu_torch.train.hybrid_driver.run_hybrid_training")
        if cfg.dataset.feature_placement != "hbm" or cfg.cache.enabled:
            raise ValueError(
                f"Trainer keeps the features in device memory; "
                f"feature_placement={cfg.dataset.feature_placement!r} with "
                f"CacheConfig(enabled={cfg.cache.enabled}) runs through "
                "legion_tpu_torch.train.cached_driver.run_cached_training")
        self.cfg = cfg
        self.data = data
        self.device = torch.device(device)

        self.graph = DeviceGraph.from_host(data.indptr, data.indices,
                                           self.device)
        feats = pad_feature_dim(np.asarray(data.features, np.float32),
                                cfg.dataset.feature_pad_align or 1)
        self.features = torch.from_numpy(np.ascontiguousarray(feats)).to(
            self.device)

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
        if (cfg.sampler.probe_caps
                and self.caps[-1] >= cfg.sampler.probe_caps_min_cap):
            self.caps = self._probe_caps()

        num_classes = cfg.dataset.num_classes or data.num_classes
        init_gen = torch.Generator().manual_seed(cfg.train.seed)
        self.model = build_model(
            cfg.model.arch, self.features.shape[1], cfg.model.hidden_dim,
            num_classes, cfg.model.num_layers, cfg.model.dropout,
            dtype=cfg.model.dtype, generator=init_gen).to(self.device)
        self.state = create_train_state(self.model, cfg.train.learning_rate,
                                        cfg.train.seed, self.device)
        if cfg.train.checkpoint_dir:
            restore_checkpoint(cfg.train.checkpoint_dir, self.state)
        self.fns = make_step_fns(cfg, self.caps)
        self.fns_eval = make_step_fns(cfg, self.eval_caps)
        self.history: list[Dict] = []

    def _probe_caps(self):
        """Tighten static frontier caps to slack x the maxima realized on
        a few probe batches at loose caps (the reference's 1.2 x observed
        MaxIdNum sizing). The last cap is exact when the final hop is
        identity-appended. Reads the counts on the host: a set-up sync."""
        cfg = self.cfg
        b = cfg.sampler.batch_size
        fanouts = tuple(cfg.sampler.fanouts)
        loose = frontier_caps(b, fanouts)
        rng = np.random.default_rng(cfg.train.seed * 7919 + 1)
        gen = torch.Generator(device=self.device).manual_seed(1000)
        ids = np.asarray(self.shards_train[0])
        mx = np.zeros(len(fanouts) + 1, np.int64)
        labels = torch.zeros((b,), dtype=torch.int32, device=self.device)
        with torch.no_grad():
            for _ in range(cfg.sampler.probe_caps_batches):
                seeds = rng.permutation(ids)[:b].astype(np.int32)
                n = len(seeds)
                seeds = np.pad(seeds, (0, b - n), constant_values=-1)
                batch = sample_batch(
                    self.graph, torch.from_numpy(seeds).to(self.device),
                    torch.tensor(n, dtype=torch.int32, device=self.device),
                    labels, fanouts, loose, generator=gen)
                counts = torch.stack([batch.num_seeds] + [
                    blk.num_src for blk in batch.blocks]).tolist()
                mx = np.maximum(mx, counts)
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

    def train_one_epoch(self, epoch: int) -> Dict:
        rng = np.random.default_rng(self.cfg.train.seed * 100003 + epoch)
        seeds, _ = epoch_train_seeds(rng, self.shards_train, self.plan)
        labels = np.asarray(self.data.labels, np.int32)[seeds[0]]
        dev = self.device
        t0 = time.perf_counter()
        seeds_d = torch.from_numpy(seeds[0]).to(dev)
        labels_d = torch.from_numpy(labels).to(dev)
        nb = torch.tensor(self.plan.train_batch, dtype=torch.int32, device=dev)
        per_step = [self.fns.train_step(self.state, self.graph, self.features,
                                        seeds_d[i], nb, labels_d[i])
                    for i in range(self.plan.train_steps)]
        # the epoch's only device -> host reads
        losses = torch.stack([m["loss"] for m in per_step]).cpu().numpy()
        edges = torch.stack([m["edges"] for m in per_step]).cpu()
        overflow = int(torch.stack([m["cap_overflow"] for m in per_step])
                       .sum(dtype=torch.int64))
        dt = time.perf_counter() - t0
        if overflow > 0:
            log_metrics({"event": "cap_overflow", "epoch": epoch,
                         "dropped_frontier_ids": overflow,
                         "hint": "raise sampler.observed_cap_slack"})
        # exact byte accounting: every step gathers frontier_cap rows
        feat_bytes = (self.plan.train_steps * self.caps[-1]
                      * self.features.shape[1] * self.features.element_size())
        rec = {"epoch": epoch, "loss": float(losses[-1]),
               "mean_loss": float(losses.mean()), "losses": losses.tolist(),
               "steps": self.plan.train_steps, "epoch_s": dt,
               "edges_per_s": sum_edge_counts(edges) / dt,
               "cap_overflow": overflow, "feature_gb": feat_bytes / 2 ** 30}
        self.history.append(rec)
        log_metrics({"event": "train_epoch", **rec})
        return rec

    def evaluate(self, which: str = "valid") -> float:
        """Accuracy over the valid or test seeds; for ``lp_sage`` the
        mean LP loss per valid pair (lower is better)."""
        shards = self.shards_valid if which == "valid" else self.shards_test
        steps = (self.plan.valid_steps if which == "valid"
                 else self.plan.test_steps)
        per = (self.plan.valid_batch if which == "valid"
               else self.plan.test_batch)
        cap = self.cfg.sampler.eval_batch_size
        seeds, counts = epoch_eval_seeds(shards, steps, per, cap)
        labels_all = np.asarray(self.data.labels)
        lab = np.where(seeds[0] >= 0, labels_all[np.clip(seeds[0], 0, None)],
                       -1).astype(np.int32)
        dev = self.device
        seeds_d = torch.from_numpy(seeds[0]).to(dev)
        counts_d = torch.from_numpy(counts[0]).to(dev)
        lab_d = torch.from_numpy(lab).to(dev)
        gen = torch.Generator(device=dev).manual_seed(12345)
        correct = torch.zeros((), dtype=torch.float32, device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(steps):
            a, b = self.fns_eval.eval_step(self.model, self.graph,
                                           self.features, seeds_d[t],
                                           counts_d[t], lab_d[t],
                                           generator=gen)
            correct += a
            total += b
        return float(correct) / max(float(total), 1.0)

    def fit(self, epochs: Optional[int] = None,
            log: Callable[[str], None] = print) -> Dict:
        epochs = epochs or self.cfg.train.epochs
        vlab, tlab = eval_labels(self.cfg)
        for epoch in range(self.state.epoch, epochs):
            rec = self.train_one_epoch(epoch)
            acc = self.evaluate("valid")
            self.state.epoch = epoch + 1
            log(f"Epoch:{epoch}, Cost:{rec['epoch_s']:.3f} s, "
                f"Loss:{rec['loss']:.4f}, {vlab}: {acc:.4f}, "
                f"edges/s: {rec['edges_per_s']:.3e}")
            if self.cfg.train.checkpoint_dir:
                save_checkpoint(self.cfg.train.checkpoint_dir, self.state)
        test_acc = self.evaluate("test")
        log(f"{tlab}: {test_acc:.4f}")
        return {"test_acc": test_acc, "history": self.history}
