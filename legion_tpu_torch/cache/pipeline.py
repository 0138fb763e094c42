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

The device stages are the reference's compiled programs
(``jit_sample_plan``, ``jit_train_from``, ``jit_eval_from``): on a
capturing ``GraphPool`` each is a CUDA graph (``train/graphed.py``'s
``StageGraph`` / ``GraphedStep``) that replays between the host legs.
A graph bakes in its tensors' addresses, and ``train.pipeline_depth`` = d
batches are in flight at once, so there is one sample graph and one
train (or eval) graph per slot, slot ``i % d`` serving step i; every
tensor that crosses from one stage to the next (the batch, the plan, the
packed array, the staged rows, the losses) lives in static buffers made
outside the graphs' pool. The host legs stay eager between the replays:
the packed read, the host gather of the misses and the copy of exactly
their rows to the device, whose size changes from step to step. Without
a capturing pool (the CPU, the eager comparison) the same stages run
eagerly on the same buffers.

Spans (``utils/trace.py``), each step: ``pipeline.dispatch`` (the
sample stage's replay and the packed array's fetch), ``pipeline.plan_wait``
(the wait for the packed array), ``pipeline.stage`` (the host gather of
the misses and their copy up) and ``pipeline.consume`` (the train or eval
stage and the host's count); the epoch's ``stage_s`` is ``plan_wait`` +
``stage``. An epoch is a ``train`` root, an evaluation an ``eval`` one;
``h2d_bytes`` counts the loads, the staged rows and the epoch's totals.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from legion_tpu_torch.cache.feature_cache import FeatureCache
from legion_tpu_torch.config import Config
from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
from legion_tpu_torch.train.graphed import (GraphedStep, GraphPool, HostRing,
                                            Run, StageGraph, addresses, lend,
                                            row_at, serving_run, state_ties)
from legion_tpu_torch.train.loop import make_objective
from legion_tpu_torch.train.train_state import (TrainState,
                                                maybe_checkpoint_step)
from legion_tpu_torch.utils import trace


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


def run_ties(owner, tables) -> Tuple:
    """What a staged run's graphs were captured on: a ``TrainState`` (its
    generator, hyperparameters and tensors, as ``EpochScan`` ties them)
    or an eval model's parameters, and the device tables the stages
    read."""
    if isinstance(owner, TrainState):
        own = state_ties(owner)
    else:
        own = (id(owner), addresses(owner.parameters()))
    return own + (addresses(tables),)


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
    a mid-epoch checkpoint is written. ``pool``: where the device stages
    are captured (None: they run eagerly); the train and eval graphs
    share it."""

    n_stats = 5
    save: Optional[Callable] = None

    def __init__(self, cfg: Config, model: torch.nn.Module, caps,
                 graph: DeviceGraph, cache: FeatureCache,
                 reducer: Optional[Callable] = None,
                 pool: Optional[GraphPool] = None):
        self.cfg = cfg
        self.model = model
        self.caps = tuple(caps)
        self.graph = graph
        self.cache = cache
        self.device = graph.indptr.device
        self.fanouts = tuple(cfg.sampler.fanouts)
        self.pool = pool
        self.runs: Dict[Tuple[str, bool], Run] = {}
        self.train_from, self.eval_from = make_cache_step_fns(
            cfg, combine=lambda rows, plan, staged, frontier:
            cache.combine(plan, staged, frontier), reducer=reducer)

    def release(self) -> None:
        """Drop the captured stages and their buffers (a rebuilt cache
        captures anew)."""
        self.runs.clear()

    def _plan(self, frontier):
        """(the cache plan, the cache's own statistics beyond the plan's:
        () int32 device tensors)."""
        return self.cache.plan(frontier), []

    def sample_plan(self, generator, seeds, num_seeds, labels, uniforms=None):
        """Sampling and the cache plan of one batch on the device: (batch,
        plan, packed statistics and miss ids). ``uniforms`` (per-hop
        tensors) replace the generator's sampling draws (parity tests)."""
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
        return batch, plan, packed

    def stage(self, miss_ids: np.ndarray, host: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
        """The rows of ``miss_ids`` gathered into ``host`` and on their way
        to ``out`` (``FeatureCache.stage_to``)."""
        return self.cache.stage_to(self.device, miss_ids, out=out, host=host)

    def _tables(self):
        return (self.graph.indptr, self.graph.indices, self.cache.rows,
                self.cache.hot_ids)

    def _build(self, rows: int, width: int, generator: torch.Generator,
               consume: Callable, consume_gens, injected: bool,
               out: torch.Tensor, label: str) -> Run:
        """A pipelined pass's static buffers and stages: per slot a sample
        graph (drawing from ``generator`` unless the uniforms are given)
        and a ``consume(run, slot)`` graph (drawing from
        ``consume_gens``; its spans ``stage.<label>``). The sample stages
        read row ``run.sampled`` of
        the seeds and advance it; ``out`` collects what the consume stages
        report. The rows hold one padding row past the last step's: a
        capture records the step after its warm-up's."""
        dev, d = self.device, self.cfg.train.pipeline_depth
        i32 = dict(dtype=torch.int32, device=dev)
        rows_d = self.cache.rows
        run = Run(rows, width, None,
                  seeds=torch.full((rows + 1, width), -1, **i32),
                  labels=torch.full((rows + 1, width), -1, **i32),
                  nums=torch.zeros((rows + 1,), **i32),
                  sampled=torch.zeros((1,), dtype=torch.int64, device=dev),
                  done=torch.zeros((1,), dtype=torch.int64, device=dev),
                  ubufs=[torch.empty((c, f), dtype=torch.float32, device=dev)
                         for c, f in zip(self.caps, self.fanouts)]
                  if injected else None,
                  staged=torch.empty((self.cache.miss_cap, rows_d.shape[1]),
                                     dtype=rows_d.dtype, device=dev),
                  packed=HostRing(dev, d), staging=HostRing(dev, d),
                  gen=generator, out=out)

        def sample():
            i = run.sampled
            res = self.sample_plan(run.gen, row_at(run.seeds, i),
                                   row_at(run.nums, i),
                                   row_at(run.labels, i), run.ubufs)
            i.add_(1)
            return res

        draws = () if injected else (generator,)
        run.sample = [StageGraph(sample, self.pool, draws, "sample_plan")
                      for _ in range(d)]
        run.consume = [GraphedStep(functools.partial(consume, run, s),
                                   self.pool, consume_gens, label)
                       for s in range(d)]
        return run

    def _train_stage(self, state: TrainState, run: Run, slot: int) -> None:
        batch, plan, _ = run.sample[slot].out
        step = state.step
        loss = self.train_from(state, self.cache.rows, batch, plan,
                               run.staged)
        # the host counts the step (``run_epoch``): a replay runs no Python
        state.step = step
        run.out.index_copy_(0, run.done, loss.to(torch.float64)[None])
        run.done.add_(1)

    def _eval_stage(self, model: torch.nn.Module, run: Run,
                    slot: int) -> None:
        batch, plan, _ = run.sample[slot].out
        a, b = self.eval_from(model, self.cache.rows, batch, plan,
                              run.staged)
        run.out.add_(torch.stack([a, b]).float())

    def _pipeline(self, run: Run, steps: int, uniforms: Optional[Callable],
                  consume: Callable):
        """Replay slot ``i % d``'s sample stage ``d`` =
        ``train.pipeline_depth`` steps ahead of its consume stage, with
        the host legs between them, and ``consume(i, packed)`` on the host
        after each step, in the spans the module names.

        The host rings. At step i the host waits for packed(i)'s event,
        recorded after sample(i), which was enqueued at step i-d: before
        the staged-row copies of steps i-d+1 .. i-1. Those copies may
        still be pending, so one pinned staging buffer would be written
        under them; a ring of d is not, since slot i % d was last read by
        the copy of step i-d, enqueued before sample(i). Packed(i + d) is
        fetched into slot i % d after the host has read step i's. The
        device's staged rows need one buffer: copy(i) is enqueued after
        train(i-1), which reads the last ones."""
        d = len(run.sample)
        ns, miss_cap = self.n_stats, self.cache.miss_cap

        def dispatch(i):
            with trace.span("pipeline.dispatch"):
                if uniforms is not None:
                    for k, buf in enumerate(run.ubufs):
                        buf.copy_(uniforms(i, k))
                run.packed.fetch(i % d, run.sample[i % d]()[2])

        for i in range(min(d, steps)):
            dispatch(i)
        for i in range(steps):
            s = i % d
            with trace.span("pipeline.plan_wait"):
                p = run.packed.numpy(s)
            with trace.span("pipeline.stage"):
                n_miss = min(int(p[1]), miss_cap)
                self.stage(p[ns:ns + n_miss], run.staging.buffer(
                    s, run.staged.shape, run.staged.dtype), run.staged)
            with trace.span("pipeline.consume"):
                run.consume[s]()
                consume(i, p)
            if i + d < steps:
                dispatch(i + d)

    @staticmethod
    def _load(run: Run, seeds: np.ndarray, nums, labels: np.ndarray) -> None:
        """An epoch's seeds, seed counts and labels into the run's static
        rows (``h2d_bytes``), and its counters to the first row: the span
        ``epoch.load``."""
        with trace.span("epoch.load"):
            steps = seeds.shape[0]
            for buf, x in ((run.seeds, seeds), (run.nums, nums),
                           (run.labels, labels)):
                x = np.ascontiguousarray(x, np.int32)
                buf[:steps].copy_(torch.from_numpy(x))
                trace.count("h2d_bytes", x.nbytes)
            run.sampled.zero_()
            run.done.zero_()

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
        miss and byte figures, are those of every rank: ``_sum_ranks``.
        The epoch is a ``train`` root: ``seconds`` is its time up to the
        record, ``stage_s`` its ``pipeline.plan_wait`` + ``pipeline.stage``
        seconds, and the record carries its ``spans`` and ``counts``."""
        steps, b = seeds_epoch.shape
        dev = self.device
        with trace.epoch("train") as root:
            root.steps = steps
            with trace.span("epoch.prepare"):
                injected = uniforms is not None
                ties = run_ties(state, self._tables())
                run = serving_run(
                    self.runs, ("train", injected), steps, b, ties,
                    lambda rows: self._build(
                        rows, b, state.generator,
                        functools.partial(self._train_stage, state),
                        (state.generator,), injected,
                        torch.zeros((rows + 1,), dtype=torch.float64,
                                    device=dev), "train_from"))
                self._load(run, seeds_epoch, np.full(steps, b), labels_epoch)
            ns = self.n_stats
            tot = np.zeros(ns + 1, np.int64)   # the stats, then host rows

            def consume(i, p):
                state.step += 1
                tot[:ns] += p[:ns]
                tot[ns] += min(int(p[1]), self.cache.miss_cap)
                maybe_checkpoint_step(self.cfg.train, state, i, self.save)

            with trace.span("epoch.steps"):
                self._pipeline(run, steps, uniforms, consume)
            run.ties = run_ties(state, self._tables())  # Adam's state now
            with trace.span("epoch.read"):
                # the epoch's only reads besides the per-step packed arrays
                up = torch.from_numpy(tot.astype(np.float64))
                trace.count("h2d_bytes", up.numel() * up.element_size())
                summed = self._sum_ranks(torch.cat([run.out[:steps],
                                                    up.to(dev)])).cpu()
            with trace.span("epoch.record"):
                loss_h = summed[:steps].to(torch.float32).numpy()
                tot = summed[steps:].to(torch.int64).numpy()
                row_bytes = (self.cache.rows.shape[1]
                             * self.cache.rows.element_size())
                dt = root.elapsed()
                rec = {
                    "state": state, "steps": steps, "seconds": dt,
                    "loss": float(loss_h[-1]) if steps else float("nan"),
                    "losses": loss_h.tolist(),
                    "cache_hit_rate": int(tot[0]) / max(int(tot[2]), 1),
                    "host_gb": int(tot[ns]) * row_bytes / 2 ** 30,
                    "staging_overflow": int(tot[3]), "edges": int(tot[4]),
                    "edges_per_s": int(tot[4]) / dt,
                    "stage_s": (trace.seconds(root.tally, "pipeline.plan_wait")
                                + trace.seconds(root.tally, "pipeline.stage")),
                    **self._extra(tot),
                }
        rec["spans"], rec["counts"] = root.entry["spans"], root.entry["counts"]
        return rec

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
        the ranks): one fetch for the epoch. The samples draw from
        ``generator`` (default: one seeded 4242), through a generator of
        the run's own that takes its state and hands it back, so that the
        run's graphs serve every call. The pass is an ``eval`` root."""
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(4242)
        steps, b = seeds.shape
        if steps == 0:
            return float("nan")
        with trace.epoch("eval") as root:
            root.steps = steps
            with trace.span("epoch.prepare"):
                injected = uniforms is not None
                run = serving_run(
                    self.runs, ("eval", injected), steps, b,
                    run_ties(model, self._tables()),
                    lambda rows: self._build(
                        rows, b, torch.Generator(device=dev),
                        functools.partial(self._eval_stage, model), (),
                        injected,
                        torch.zeros(2, dtype=torch.float32, device=dev),
                        "eval_from"))
                self._load(run, seeds, counts, labels)
                run.out.zero_()
            with trace.span("epoch.steps"), lend([run.gen], [generator]):
                self._pipeline(run, steps, uniforms, lambda i, p: None)
            run.ties = run_ties(model, self._tables())
            with trace.span("epoch.read"):
                a, b = self._sum_ranks(run.out.clone()).tolist()
        return a / max(b, 1.0)
