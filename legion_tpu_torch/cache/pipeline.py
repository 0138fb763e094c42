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
from typing import Callable, Dict, Optional

import numpy as np
import torch

from legion_tpu_torch.cache.feature_cache import FeatureCache
from legion_tpu_torch.config import Config
from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
from legion_tpu_torch.train.loop import make_objective
from legion_tpu_torch.train.train_state import (TrainState,
                                                maybe_checkpoint_step)


def make_cache_step_fns(cfg: Config, combine: Optional[Callable] = None,
                        reducer: Optional[Callable] = None):
    """(train_from, eval_from) over a sampled batch, its cache plan and
    the staged miss rows. ``train_from`` updates ``state`` in place (one
    Adam step) and returns the loss as a device tensor; ``eval_from``
    returns what eval accumulates (``train.loop.make_objective``): the
    (correct, valid) seed counts, or for ``lp_sage`` the (LP loss sum,
    valid-pair count). ``combine(rows, plan, staged, frontier)`` builds
    the feature matrix (default ``FeatureCache.combine_rows``; the striped
    cache's fetches its hits over the cache group), and ``reducer(model)``
    runs between the backward pass and the optimizer step (the
    data-parallel gradient mean)."""
    loss_of, counts_of = make_objective(cfg)
    combine = combine or FeatureCache.combine_rows

    def train_from(state: TrainState, rows, batch, plan, staged):
        x = combine(rows, plan, staged, batch.frontier)
        out = state.model(tuple(reversed(batch.blocks)), x,
                          deterministic=False, generator=state.generator)
        loss = loss_of(out, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if reducer is not None:
            reducer(state.model)
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_from(model, rows, batch, plan, staged):
        x = combine(rows, plan, staged, batch.frontier)
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
    every duplicate frontier row would cost host->device bytes.

    Each step's packed array holds ``n_stats`` statistics (hits, misses,
    valid ids, staging overflow, sampled edges) and then the miss ids.
    ``cache.plan`` and ``cache.combine`` make the plan and the feature
    matrix, so a striped cache (``cache/striped_pipeline.py``) runs the
    same pipeline; ``_sum_ranks`` is where it sums an epoch's figures over
    the ranks, and ``save`` (None: ``train_state.save_checkpoint``) is how
    a mid-epoch checkpoint is written."""

    n_stats = 5
    save: Optional[Callable] = None

    def __init__(self, cfg: Config, model: torch.nn.Module, caps,
                 graph: DeviceGraph, cache: FeatureCache,
                 reducer: Optional[Callable] = None):
        self.cfg = cfg
        self.model = model
        self.caps = tuple(caps)
        self.graph = graph
        self.cache = cache
        self.device = graph.indptr.device
        self.fanouts = tuple(cfg.sampler.fanouts)
        self.train_from, self.eval_from = make_cache_step_fns(
            cfg, combine=lambda rows, plan, staged, frontier:
            cache.combine(plan, staged, frontier), reducer=reducer)

    def _plan(self, frontier):
        """(the cache plan, the cache's own statistics beyond the plan's:
        () int32 device tensors)."""
        return self.cache.plan(frontier), []

    def sample_plan(self, generator, seeds, num_seeds, labels, uniforms=None):
        """Enqueue sampling and the cache plan of one batch, and start the
        packed copy to the host. ``uniforms`` (per-hop tensors) replace the
        generator's sampling draws (parity tests)."""
        draws = (dict(generator=generator) if uniforms is None
                 else dict(generator=None, uniforms=uniforms))
        batch = sample_batch(self.graph, seeds, num_seeds, labels,
                             self.fanouts, self.caps, dedup_last=True,
                             **draws)
        plan, extra = self._plan(batch.frontier)
        edges = torch.stack([blk.num_edges() for blk in batch.blocks]).sum(
            dtype=torch.int32)
        packed = torch.cat([
            torch.stack([plan.num_hit, plan.num_miss, plan.num_valid,
                         plan.overflow(), edges] + extra),
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
        ns = self.n_stats
        inflight = collections.deque()
        stage_s = 0.0
        for i in range(min(depth, steps)):
            inflight.append(dispatch(i))
        for i in range(steps):
            batch, plan, packed = inflight.popleft()
            t = time.perf_counter()
            p = packed.numpy()
            n_miss = int(p[1])
            staged = self.stage(p[ns:ns + min(n_miss, self.cache.miss_cap)])
            stage_s += time.perf_counter() - t
            consume(i, batch, plan, staged, p)
            if i + depth < steps:
                inflight.append(dispatch(i + depth))
        return stage_s

    def _sum_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """An epoch's figures as every rank holds them: here the one
        device's own."""
        return t

    def run_epoch(self, state: TrainState, seeds_epoch: np.ndarray,
                  labels_epoch: np.ndarray,
                  uniforms: Optional[Callable] = None) -> Dict:
        """One pipelined epoch over (steps, batch) seeds and labels, with
        ``train.pipeline_depth`` steps enqueued ahead; sampling and dropout
        draw from ``state.generator`` (``uniforms(step, hop)`` replaces
        the sampling draws in parity tests). The losses, and the hit,
        miss and byte figures, are those of every rank: ``_sum_ranks``."""
        steps, b = seeds_epoch.shape
        dev = self.device
        t0 = time.perf_counter()
        seeds_d = torch.from_numpy(np.ascontiguousarray(
            seeds_epoch, np.int32)).to(dev)
        labels_d = torch.from_numpy(np.ascontiguousarray(
            labels_epoch, np.int32)).to(dev)
        nb = torch.full((), b, dtype=torch.int32, device=dev)
        ns, hops = self.n_stats, range(len(self.fanouts))
        losses = []
        tot = np.zeros(ns + 1, np.int64)       # the stats, then host rows

        def dispatch(i):
            u = (None if uniforms is None
                 else [uniforms(i, k) for k in hops])
            return self.sample_plan(state.generator, seeds_d[i], nb,
                                    labels_d[i], u)

        def consume(i, batch, plan, staged, p):
            losses.append(self.train_from(state, self.cache.rows, batch,
                                          plan, staged))
            tot[:ns] += p[:ns]
            tot[ns] += min(int(p[1]), self.cache.miss_cap)
            maybe_checkpoint_step(self.cfg.train, state, i, self.save)

        stage_s = self._pipeline(steps, dispatch, consume)
        # the epoch's only reads besides the per-step packed arrays
        summed = self._sum_ranks(torch.cat([
            torch.stack(losses).to(torch.float64) if losses
            else torch.zeros(0, dtype=torch.float64, device=dev),
            torch.from_numpy(tot.astype(np.float64)).to(dev)])).cpu()
        loss_h = summed[:steps].to(torch.float32).numpy()
        tot = summed[steps:].to(torch.int64).numpy()
        row_bytes = self.cache.rows.shape[1] * self.cache.rows.element_size()
        dt = time.perf_counter() - t0
        return {
            "state": state, "steps": steps, "seconds": dt,
            "loss": float(loss_h[-1]) if steps else float("nan"),
            "losses": loss_h.tolist(),
            "cache_hit_rate": int(tot[0]) / max(int(tot[2]), 1),
            "host_gb": int(tot[ns]) * row_bytes / 2 ** 30,
            "staging_overflow": int(tot[3]), "edges": int(tot[4]),
            "edges_per_s": int(tot[4]) / dt, "stage_s": stage_s,
            **self._extra(tot),
        }

    def _extra(self, tot: np.ndarray) -> Dict:
        """Figures of a subclass's own statistics."""
        return {}

    def eval_epoch(self, model: torch.nn.Module, seeds: np.ndarray,
                   counts: np.ndarray, labels: np.ndarray,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[Callable] = None) -> float:
        """Accuracy (for ``lp_sage`` the mean LP loss per valid pair) over
        (steps, batch) eval seeds through the cached feature path,
        pipelined like ``run_epoch`` and summed on the device (and over
        the ranks): one fetch for the epoch."""
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
        hops = range(len(self.fanouts))

        def dispatch(t):
            u = (None if uniforms is None
                 else [uniforms(t, k) for k in hops])
            return self.sample_plan(generator, seeds_d[t], counts_d[t],
                                    labels_d[t], u)

        def consume(t, batch, plan, staged, p):
            a, b = self.eval_from(model, self.cache.rows, batch, plan,
                                  staged)
            acc.add_(torch.stack([a, b]).float())

        self._pipeline(steps, dispatch, consume)
        a, b = self._sum_ranks(acc).tolist()
        return a / max(b, 1.0)
