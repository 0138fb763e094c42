"""Cached training pipeline: device sampling, the device hot-row cache
and host miss staging, overlapped (port of
``legion_tpu/cache/pipeline.py``).

The reference splits this into a C++ sampling server and a training
client that hand batches over in per-slot buffers guarded by semaphores
(``src/CUDA_IPC_Service.cu:34-37,140-201``, PIPELINE_DEPTH 2). Here both
halves live in one process on one CUDA stream, and the overlap comes from
the stream running ahead of the host:

  dispatch(i): [device] sample + cache plan of step i, then a non-blocking
               copy of its packed [hit, miss, valid, overflow | miss_ids]
               into pinned host memory, and an event
  step i:      wait for step i's event (not for the stream), gather the
               miss rows on the host into a pinned buffer while the device
               still trains step i-1, copy them to the device
               (non-blocking), enqueue train(i), then dispatch(i + depth)

Per step the host reads one packed array from the device and nothing
else; losses and edge counts stay on the device until the epoch ends.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import numpy as np
import torch

from legion_tpu_torch.cache.feature_cache import FeatureCache
from legion_tpu_torch.config import Config
from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
from legion_tpu_torch.train.loop import make_objective
from legion_tpu_torch.train.train_state import (TrainState,
                                                maybe_checkpoint_step)


def make_cache_step_fns(cfg: Config):
    """(train_from, eval_from) over a sampled batch, its cache plan and
    the staged miss rows. ``train_from`` updates ``state`` in place (one
    Adam step) and returns the loss as a device tensor; ``eval_from``
    returns what eval accumulates (``train.loop.make_objective``): the
    (correct, valid) seed counts, or for ``lp_sage`` the (LP loss sum,
    valid-pair count)."""
    loss_of, counts_of = make_objective(cfg)

    def train_from(state: TrainState, rows, batch, plan, staged):
        x = FeatureCache.combine_rows(rows, plan, staged, batch.frontier)
        out = state.model(tuple(reversed(batch.blocks)), x,
                          deterministic=False, generator=state.generator)
        loss = loss_of(out, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_from(model, rows, batch, plan, staged):
        x = FeatureCache.combine_rows(rows, plan, staged, batch.frontier)
        out = model(tuple(reversed(batch.blocks)), x, deterministic=True)
        return counts_of(out, batch)

    return train_from, eval_from


class _Packed:
    """The packed per-step statistics and miss ids on their way to the
    host: a non-blocking copy into pinned memory and an event on CUDA, a
    plain tensor on the CPU."""

    def __init__(self, packed: torch.Tensor):
        self.event = None
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(packed.device))
            packed = host
        self.host = packed

    def numpy(self) -> np.ndarray:
        """Wait for this step's copy only, not for the whole stream."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class CachedTrainer:
    """Train with host-resident features behind a ``FeatureCache``.
    Sampling always dedups the last hop: with host-resident features
    every duplicate frontier row would cost host->device bytes."""

    def __init__(self, cfg: Config, model: torch.nn.Module, caps,
                 graph: DeviceGraph, cache: FeatureCache):
        self.cfg = cfg
        self.model = model
        self.caps = tuple(caps)
        self.graph = graph
        self.cache = cache
        self.device = graph.indptr.device
        self.fanouts = tuple(cfg.sampler.fanouts)
        self.train_from, self.eval_from = make_cache_step_fns(cfg)

    def sample_plan(self, generator, seeds, num_seeds, labels):
        """Enqueue sampling and the cache plan of one batch, and start the
        packed copy to the host."""
        batch = sample_batch(self.graph, seeds, num_seeds, labels,
                             self.fanouts, self.caps, dedup_last=True,
                             generator=generator)
        plan = FeatureCache.plan_ids(self.cache.hot_ids, batch.frontier,
                                     self.cache.miss_cap)
        packed = torch.cat([
            torch.stack([plan.num_hit, plan.num_miss, plan.num_valid,
                         plan.overflow()]),
            plan.miss_ids])
        return batch, plan, _Packed(packed)

    def stage(self, miss_ids: np.ndarray) -> torch.Tensor:
        """The staged rows of ``miss_ids`` on their way to the device
        (``FeatureCache.stage_to``)."""
        return self.cache.stage_to(self.device, miss_ids)

    def _pipeline(self, steps, dispatch, consume):
        """Run ``dispatch(i)`` ``train.pipeline_depth`` steps ahead of
        ``consume(i, ...)``; returns the host seconds spent reading the
        packed arrays and staging."""
        depth = self.cfg.train.pipeline_depth
        inflight = collections.deque()
        stage_s = 0.0
        for i in range(min(depth, steps)):
            inflight.append(dispatch(i))
        for i in range(steps):
            batch, plan, packed = inflight.popleft()
            t = time.perf_counter()
            p = packed.numpy()
            n_miss = int(p[1])
            staged = self.stage(p[4:4 + min(n_miss, self.cache.miss_cap)])
            stage_s += time.perf_counter() - t
            consume(i, batch, plan, staged, p)
            if i + depth < steps:
                inflight.append(dispatch(i + depth))
        return stage_s

    def run_epoch(self, state: TrainState, seeds_epoch: np.ndarray,
                  labels_epoch: np.ndarray) -> Dict:
        """One pipelined epoch over (steps, batch) seeds and labels, with
        ``train.pipeline_depth`` steps enqueued ahead; sampling and dropout
        draw from ``state.generator``."""
        steps, b = seeds_epoch.shape
        dev = self.device
        t0 = time.perf_counter()
        seeds_d = torch.from_numpy(np.ascontiguousarray(
            seeds_epoch, np.int32)).to(dev)
        labels_d = torch.from_numpy(np.ascontiguousarray(
            labels_epoch, np.int32)).to(dev)
        nb = torch.full((), b, dtype=torch.int32, device=dev)
        losses, edges = [], []
        tot = np.zeros(4, np.int64)          # hit, miss, valid, overflow
        row_bytes = self.cache.rows.shape[1] * self.cache.rows.element_size()
        host_rows = 0

        def dispatch(i):
            return self.sample_plan(state.generator, seeds_d[i], nb,
                                    labels_d[i])

        def consume(i, batch, plan, staged, p):
            nonlocal host_rows
            losses.append(self.train_from(state, self.cache.rows, batch,
                                          plan, staged))
            edges.append(torch.stack([blk.num_edges()
                                      for blk in batch.blocks]).sum())
            tot[:] += p[:4]
            host_rows += min(int(p[1]), self.cache.miss_cap)
            maybe_checkpoint_step(self.cfg.train, state, i)

        stage_s = self._pipeline(steps, dispatch, consume)
        # the epoch's only reads besides the per-step packed arrays
        loss_h = (torch.stack(losses).cpu().numpy() if losses
                  else np.zeros(0, np.float32))
        n_edges = int(torch.stack(edges).cpu().to(torch.int64).sum()) \
            if edges else 0
        dt = time.perf_counter() - t0
        return {
            "state": state, "steps": steps, "seconds": dt,
            "loss": float(loss_h[-1]) if steps else float("nan"),
            "losses": loss_h.tolist(),
            "cache_hit_rate": int(tot[0]) / max(int(tot[2]), 1),
            "host_gb": host_rows * row_bytes / 2 ** 30,
            "staging_overflow": int(tot[3]),
            "edges_per_s": n_edges / dt, "stage_s": stage_s,
        }

    def eval_epoch(self, model: torch.nn.Module, seeds: np.ndarray,
                   counts: np.ndarray, labels: np.ndarray,
                   generator: Optional[torch.Generator] = None) -> float:
        """Accuracy (for ``lp_sage`` the mean LP loss per valid pair) over
        (steps, batch) eval seeds through the cached feature path,
        pipelined like ``run_epoch`` and summed on the device: one fetch
        for the epoch."""
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(4242)
        steps = seeds.shape[0]
        if steps == 0:
            return float("nan")
        seeds_d = torch.from_numpy(np.ascontiguousarray(seeds, np.int32)
                                   ).to(dev)
        counts_d = torch.from_numpy(np.ascontiguousarray(counts, np.int32)
                                    ).to(dev)
        labels_d = torch.from_numpy(np.ascontiguousarray(labels, np.int32)
                                    ).to(dev)
        acc = torch.zeros(2, dtype=torch.float32, device=dev)

        def dispatch(t):
            return self.sample_plan(generator, seeds_d[t], counts_d[t],
                                    labels_d[t])

        def consume(t, batch, plan, staged, p):
            a, b = self.eval_from(model, self.cache.rows, batch, plan,
                                  staged)
            acc.add_(torch.stack([a, b]).float())

        self._pipeline(steps, dispatch, consume)
        a, b = acc.tolist()
        return a / max(b, 1.0)
