"""Captured steps: the port's counterpart of ``jax.jit(epoch_scan)`` and
``jax.jit(eval_scan)`` in ``legion_tpu/train/loop.py`` (``:220-267``,
jitted at ``:320-323``).

The reference runs an epoch as one compiled program, a ``lax.scan`` over
its train step. Here the step is captured once as a CUDA graph and the
epoch replays it: one graph launch a step in place of the ~231 kernel
launches PyTorch makes when it dispatches the step op by op.

* **Static inputs.** ``EpochScan`` copies the epoch's seeds and labels
  once into a static ``(rows, batch)`` buffer (the scan's ``xs``); a
  device step counter picks the row inside the graph. Uniforms that a
  test passes are copied into static ``(cap_k, fanout_k)`` buffers before
  each replay.
* **Static outputs.** Each step writes its (loss, edges, frontier,
  cap_overflow, attn_slots) into row ``counter`` of a ``(rows, 5)``
  float64 device tensor, so the epoch still has one device->host read.
* **The warm-up is the first step.** The capturing call runs its step
  once on a side stream, as PyTorch's whole-network capture recipe warms
  up: that builds the kernels, makes Adam's state and sets up cuBLAS, and
  writes the step's row and advances the counter, the generators and
  Adam as that step should. The capture that follows executes nothing,
  and replays serve the steps after it.
* **Randomness.** The generators the step draws from are registered with
  the graph, so the capture draws nothing from them and each replay
  advances them as the eager step does.
* **One pool.** A trainer's train and eval graphs share one memory pool
  (``GraphPool``): they never run at once, and what outlives a replay
  (parameters, Adam's state, the static buffers) lives outside it.
* **Never stale.** A graph belongs to the tensors it was captured on. A
  scan called on other ones (another state, weights or optimizer tensors
  that were replaced, another graph or table) drops it and captures anew.
* **No fallback.** A capture that fails raises.
* **Off the card** (``GraphPool.captures`` False: the CPU, or no pool)
  the same static-buffer step runs eagerly, without capture, so the CPU
  tests run the code that the graph records.

Launch counts: each kernel wrapper counts its Python calls, and a replay
makes none. A capture records how many launches of each wrapper the step
holds, takes them back off the counts, and each replay adds them; the
warm-up's are those of the step it runs, so the counts remain those of
the steps that ran. The collectives' bytes and calls (``utils/comm.py``)
are kept the same way.

Collectives inside a step (the data-parallel and partitioned paths,
``parallel/``) are captured on a NCCL group only
(``parallel.mesh.captures_steps``): the warm-up makes the step's NCCL
communicators, on its side stream, before anything is captured, and
``torch.cuda.graph`` synchronizes the device before it captures, so no
NCCL work from before the capture is pending. The default (global)
capture mode serves: NCCL's watchdog thread does not break it, also
right after eager NCCL work. Over gloo the same step runs eagerly.

Spans (``utils/trace.py``): each call of a step is the span
``stage.<label>`` (its owner's label: ``train_step``, ``eval_step``,
``sample_plan``, ``train_from``, ``eval_from``, the hybrid's ``start``,
``hop<k>`` and ``finish``), a first call's warm-up and capture the span
``stage.capture``.

Staged steps (``cache/pipeline.py``, ``cache/hybrid.py``): a step that
reads a packed array back to the host in its middle is several graphs,
one per device stage (``StageGraph``: a ``GraphedStep`` whose results
land in static buffers cloned at its first run), replayed between the
host legs, whose copies go through pinned ``HostRing`` slots. Several
graphs may register one generator: each replay advances it by its own
draws, in the order the stages replay, as the eager stages would.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from legion_tpu_torch.ops.act_dropout import (act_dropout,
                                              act_dropout_backward)
from legion_tpu_torch.ops.gat_attention import (
    edge_softmax_aggregate, edge_softmax_aggregate_backward)
from legion_tpu_torch.ops.gather import gather_rows
from legion_tpu_torch.ops.identity_agg import (gathered_feature_mean,
                                               gathered_masked_mean,
                                               gathered_masked_mean_backward,
                                               identity_masked_mean)
from legion_tpu_torch.ops.dedup import dedup_tail
from legion_tpu_torch.ops.sample import sample_neighbors
from legion_tpu_torch.ops.spmm import grouped_masked_sum
from legion_tpu_torch.train.train_state import TrainState, state_tensors
from legion_tpu_torch.utils import comm, trace

# the counters a model may add to its step's metrics through its
# ``step_counts(blocks, rows)`` (GAT: attn_slots); the step reports 0 for
# those its model does not count
MODEL_COUNTS = ("attn_slots",)
# what a train step reports, in the columns of the epoch's metrics
METRICS = ("loss", "edges", "frontier", "cap_overflow") + MODEL_COUNTS

# every kernel wrapper; each counts its launches in ``.launches``
COUNTED = (identity_masked_mean, gathered_masked_mean,
           gathered_masked_mean_backward, gather_rows, sample_neighbors,
           grouped_masked_sum, dedup_tail, edge_softmax_aggregate,
           edge_softmax_aggregate_backward, gathered_feature_mean,
           act_dropout, act_dropout_backward)


class GraphPool:
    """The memory pool that a trainer's captured steps share. Capture
    happens on a CUDA device only (``captures``); elsewhere the steps run
    eagerly on the same static buffers."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.captures = self.device.type == "cuda"
        self.handle = torch.cuda.graph_pool_handle() if self.captures else None


def warm_up(body: Callable[[], None], device: torch.device) -> None:
    """One run of ``body`` on a side stream, as PyTorch's capture recipe
    warms a step up before capturing it."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)


def capture(body: Callable[[], None], generators: Sequence[torch.Generator],
            pool: GraphPool) -> torch.cuda.CUDAGraph:
    """``body`` captured into a graph in ``pool``, with ``generators``
    registered so that each replay advances them."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, pool=pool.handle):
        body()
    return graph


class GraphedStep:
    """``body()``, a step that reads and writes only tensors that outlive
    it: its first call runs it (the warm-up) and captures it, every later
    call replays the capture. ``generators`` are those it draws from.
    Without a capturing pool every call runs ``body`` eagerly. Each call
    is the span ``stage.<label>``, a capture ``stage.capture``
    (``capture_s``: its seconds)."""

    def __init__(self, body: Callable[[], None], pool: Optional[GraphPool],
                 generators: Sequence[torch.Generator] = (),
                 label: str = "step"):
        self.body = body
        self.pool = pool
        self.generators = tuple(generators)
        self.span = "stage." + label
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: List[int] = []     # of each COUNTED wrapper a replay
        self.comm = ({}, {})              # collectives (bytes, calls) a replay
        self.capture_s: Optional[float] = None

    @property
    def captures(self) -> bool:
        return self.pool is not None and self.pool.captures

    def __call__(self) -> None:
        if not self.captures:
            with trace.span(self.span):
                self.body()
        elif self.graph is None:
            with trace.span("stage.capture") as span:
                self._capture()
            self.capture_s = span.seconds
        else:
            with trace.span(self.span):
                self.graph.replay()
            for fn, n in zip(COUNTED, self.launches):
                fn.launches += n
            comm.add(self.comm)

    def _capture(self) -> None:
        warm_up(self.body, self.pool.device)       # this call's step
        before = [fn.launches for fn in COUNTED]
        counts = comm.snapshot()
        try:
            graph = capture(self.body, self.generators, self.pool)
        finally:
            self.launches = [fn.launches - b
                             for fn, b in zip(COUNTED, before)]
            for fn, b in zip(COUNTED, before):
                fn.launches = b
            self.comm = comm.since(counts)
            comm.restore(counts)
        torch.cuda.synchronize(self.pool.device)
        self.graph = graph


def store(dst, src):
    """``src``'s tensors written into ``dst``'s, a structure of the same
    shape (tensors, tuples, lists, dataclasses), or cloned when ``dst`` is
    None; other leaves are kept from the first. Returns ``dst``."""
    if dst is None:
        if isinstance(src, torch.Tensor):
            return src.clone()
        if dataclasses.is_dataclass(src):
            return dataclasses.replace(src, **{
                f.name: store(None, getattr(src, f.name))
                for f in dataclasses.fields(src)})
        if isinstance(src, (tuple, list)):
            items = [store(None, x) for x in src]
            return (type(src)(*items) if hasattr(src, "_fields")
                    else type(src)(items))
        return src
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            store(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src, strict=True):
            store(d, s)
    return dst


class StageGraph:
    """A device stage of a staged pipeline (``cache/pipeline.py``,
    ``cache/hybrid.py``): ``fn()`` as a ``GraphedStep`` whose results land
    in static buffers, ``out``, which the stages after it read. The first
    run (eager, the capture's warm-up) clones its results into ``out``,
    outside any graph's pool; every later run copies into them. So no
    graph leaves a value in the shared pool that another graph or the
    host reads later, and the stages may replay in any order."""

    def __init__(self, fn: Callable, pool: Optional[GraphPool],
                 generators: Sequence[torch.Generator] = (),
                 label: str = "step"):
        self.fn = fn
        self.out = None
        self.step = GraphedStep(self._body, pool, generators, label)

    def _body(self) -> None:
        self.out = store(self.out, self.fn())

    def __call__(self):
        self.step()
        return self.out


class HostRing:
    """Host buffers of a staged pipeline's host legs: ``slots`` of them,
    pinned on CUDA and made at the first use of each. ``fetch(slot, src)``
    starts the device->host copy of ``src`` into slot ``slot`` and records
    an event behind it; ``numpy(slot)`` waits for that event alone, never
    for the stream, and returns the slot as a numpy view (valid until the
    slot's next fetch). ``buffer(slot, shape, dtype)`` is a slot for a copy
    up (host->device), which the caller orders on the stream."""

    def __init__(self, device: torch.device, slots: int = 1):
        self.cuda = torch.device(device).type == "cuda"
        self.bufs: List[Optional[torch.Tensor]] = [None] * slots
        self.events = [None] * slots

    def buffer(self, slot: int, shape, dtype) -> torch.Tensor:
        if self.bufs[slot] is None:
            self.bufs[slot] = torch.empty(shape, dtype=dtype,
                                          pin_memory=self.cuda)
        return self.bufs[slot]

    def fetch(self, slot: int, src: torch.Tensor) -> None:
        self.buffer(slot, src.shape, src.dtype).copy_(src,
                                                      non_blocking=self.cuda)
        if self.cuda:
            if self.events[slot] is None:
                self.events[slot] = torch.cuda.Event()
            self.events[slot].record(torch.cuda.current_stream(src.device))

    def numpy(self, slot: int):
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        return self.bufs[slot].numpy()


@contextlib.contextmanager
def lend(owned: Sequence[torch.Generator],
         sources: Sequence[torch.Generator]):
    """For a pass, ``owned`` (generators that a run's graphs are
    registered with) take the states of ``sources``, and hand them back
    after it: the run's graphs serve callers that bring generators of
    their own."""
    for own, src in zip(owned, sources, strict=True):
        own.set_state(src.get_state())
    yield
    for own, src in zip(owned, sources):
        src.set_state(own.get_state())


def pool_bytes(pool: Optional[GraphPool]) -> int:
    """The device bytes of the segments ``pool`` holds (0 without one)."""
    if pool is None or pool.handle is None:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool.handle))


def row_at(buf: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Row ``counter`` of a static buffer, selected on the device (a 0-d
    tensor used as an index would be read back by the host)."""
    return buf.index_select(0, counter)[0]


def addresses(tensors) -> Tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


def state_ties(state: TrainState) -> Tuple:
    """What a train step's graph is tied to in its state: the state, its
    generator, the optimizer's hyperparameters and every tensor's
    address."""
    hyper = [sorted((k, repr(v)) for k, v in g.items() if k != "params")
             for g in state.optimizer.param_groups]
    return (id(state), id(state.generator), hyper,
            addresses(state_tensors(state)))


def _graph_tensors(graph) -> Tuple[torch.Tensor, ...]:
    """The tensors of a step's graph: a ``DeviceGraph``'s CSR, or every
    field of a rank's ``HostShard``."""
    fields = graph if isinstance(graph, tuple) else vars(graph).values()
    return tuple(t for t in fields if isinstance(t, torch.Tensor))


class Run:
    """One scan's static buffers, its step (or a staged pipeline's stages)
    and what it was captured on."""

    def __init__(self, rows: int, batch: int, step: Optional[GraphedStep],
                 **buffers):
        self.rows, self.batch, self.step = rows, batch, step
        self.ties: Optional[Tuple] = None
        for name, buf in buffers.items():
            setattr(self, name, buf)

    def serves(self, steps: int, batch: int, ties: Tuple) -> bool:
        return steps <= self.rows and batch == self.batch and ties == self.ties


def serving_run(runs: Dict, key, steps: int, width: int, ties: Tuple,
                build: Callable[[int], Run]) -> Run:
    """``runs[key]`` if it serves ``steps`` rows of ``width`` on ``ties``,
    else a new run from ``build(rows)`` in its place (its graphs dropped
    before the new ones are captured)."""
    run = runs.pop(key, None)
    # valid and test differ in steps: a run serves up to its rows
    rows = steps if run is None else max(steps, run.rows)
    if run is not None and not run.serves(steps, width, ties):
        run = None
    if run is None:
        run = build(rows)
    runs[key] = run
    return run


def _copy_up(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``src`` copied into ``dst``, a static row; from host memory, its
    bytes count in ``h2d_bytes``."""
    dst.copy_(src)
    if src.device.type == "cpu":
        trace.count("h2d_bytes", src.numel() * src.element_size())


def _uniform_buffers(shapes, uniforms, device):
    if uniforms is None:
        return None
    return [torch.empty(s, dtype=torch.float32, device=device)
            for s in shapes]


class _Scan:
    """What both scans share: a run for steps with and without given
    uniforms, each kept while it serves the call."""

    def __init__(self, step_fn: Callable, pool: Optional[GraphPool],
                 uniform_shapes: Sequence[Tuple[int, int]]):
        self.step_fn = step_fn
        self.pool = pool
        self.uniform_shapes = tuple(uniform_shapes)
        self.runs: Dict[bool, Run] = {}      # uniforms given? -> run

    def _run(self, uniforms, steps: int, width: int, ties: Tuple,
             build: Callable[[int], Run]) -> Run:
        return serving_run(self.runs, uniforms is not None, steps, width,
                           ties, build)


class EpochScan(_Scan):
    """``epoch_scan(state, graph, feats, seeds_epoch, labels_epoch,
    uniforms=None)``: every step of the epoch's ``(steps, batch)`` seeds
    and labels through the train step (``step_fn``, without the host's
    step count), as the reference's ``epoch_scan``. Updates ``state`` in
    place, ``state.step`` included, and returns the steps' (loss, edges,
    frontier, cap_overflow, attn_slots) as a ``(steps, 5)`` float64 device
    tensor.
    ``uniforms(step, hop)`` replaces the generator's sampling draws
    (parity tests; ``step`` is the state's global step), each of shape
    ``uniform_shapes[hop]``. The call is ``load`` (the run that serves
    it, the seeds and labels copied into its static rows: ``h2d_bytes``)
    then ``replay``, which a driver may call apart."""

    @staticmethod
    def _ties(state: TrainState, graph, feats) -> Tuple:
        return state_ties(state) + (
            addresses(_graph_tensors(graph) + (feats,)),)

    def _build(self, state, graph, feats, rows, batch, uniforms) -> Run:
        dev = feats.device
        seeds = torch.empty((rows, batch), dtype=torch.int32, device=dev)
        labels = torch.empty_like(seeds)
        num = torch.full((), batch, dtype=torch.int32, device=dev)
        counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        metrics = torch.zeros((rows, len(METRICS)), dtype=torch.float64,
                              device=dev)
        ubufs = _uniform_buffers(self.uniform_shapes, uniforms, dev)
        train_step = self.step_fn

        def body():
            m = train_step(state, graph, feats, row_at(seeds, counter), num,
                           row_at(labels, counter), uniforms=ubufs)
            row = torch.stack([m[k].to(torch.float64) for k in METRICS])
            metrics.index_copy_(0, counter, row[None])
            counter.add_(1)

        step = GraphedStep(body, self.pool, (state.generator,), "train_step")
        return Run(rows, batch, step, seeds=seeds, labels=labels,
                   counter=counter, metrics=metrics, ubufs=ubufs)

    def __call__(self, state: TrainState, graph, feats: torch.Tensor,
                 seeds_epoch: torch.Tensor, labels_epoch: torch.Tensor,
                 uniforms: Optional[Callable] = None) -> torch.Tensor:
        run = self.load(state, graph, feats, seeds_epoch, labels_epoch,
                        uniforms)
        return self.replay(run, state, graph, feats, seeds_epoch.shape[0],
                           uniforms)

    def load(self, state: TrainState, graph, feats: torch.Tensor,
             seeds_epoch: torch.Tensor, labels_epoch: torch.Tensor,
             uniforms: Optional[Callable] = None) -> Run:
        steps, batch = seeds_epoch.shape
        run = self._run(uniforms, steps, batch,
                        self._ties(state, graph, feats),
                        lambda rows: self._build(state, graph, feats, rows,
                                                 batch, uniforms))
        _copy_up(run.seeds[:steps], seeds_epoch)
        _copy_up(run.labels[:steps], labels_epoch)
        run.counter.zero_()
        return run

    def replay(self, run: Run, state: TrainState, graph,
               feats: torch.Tensor, steps: int,
               uniforms: Optional[Callable] = None) -> torch.Tensor:
        for _ in range(steps):
            if uniforms is not None:
                for k, buf in enumerate(run.ubufs):
                    buf.copy_(uniforms(state.step, k))
            run.step()
            state.step += 1
        run.ties = self._ties(state, graph, feats)   # Adam's state exists now
        return run.metrics[:steps].clone()


class EvalScan(_Scan):
    """``eval_scan(model, graph, feats, seeds_epoch, counts, labels_epoch,
    generator, uniforms=None)``: every eval step (``step_fn``) of the
    ``(steps, cap)`` seeds, ``(steps,)`` valid counts and labels, summed
    as the reference's ``eval_scan`` sums them; returns the (a, b) sums
    as a (2,) float32 device tensor. ``generator`` draws the samples (the
    caller seeds it); ``uniforms(step, hop)`` replaces those draws. The
    call is ``load`` then ``replay``, as ``EpochScan``'s."""

    @staticmethod
    def _ties(model, graph, feats, generator) -> Tuple:
        return (id(model), id(generator), addresses(model.parameters()),
                addresses(_graph_tensors(graph) + (feats,)))

    def _build(self, model, graph, feats, generator, rows, cap,
               uniforms) -> Run:
        dev = feats.device
        seeds = torch.empty((rows, cap), dtype=torch.int32, device=dev)
        labels = torch.empty_like(seeds)
        counts = torch.empty((rows,), dtype=torch.int32, device=dev)
        counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        acc = torch.zeros((2,), dtype=torch.float32, device=dev)
        ubufs = _uniform_buffers(self.uniform_shapes, uniforms, dev)
        eval_step = self.step_fn

        def body():
            a, b = eval_step(model, graph, feats, row_at(seeds, counter),
                             row_at(counts, counter), row_at(labels, counter),
                             generator=generator, uniforms=ubufs)
            acc.add_(torch.stack([a.float(), b.float()]))
            counter.add_(1)

        step = GraphedStep(body, self.pool, (generator,), "eval_step")
        return Run(rows, cap, step, seeds=seeds, labels=labels,
                   counts=counts, counter=counter, acc=acc, ubufs=ubufs)

    def __call__(self, model, graph, feats: torch.Tensor,
                 seeds_epoch: torch.Tensor, counts: torch.Tensor,
                 labels_epoch: torch.Tensor, generator: torch.Generator,
                 uniforms: Optional[Callable] = None) -> torch.Tensor:
        run = self.load(model, graph, feats, seeds_epoch, counts,
                        labels_epoch, generator, uniforms)
        return self.replay(run, model, graph, feats, generator,
                           seeds_epoch.shape[0], uniforms)

    def load(self, model, graph, feats: torch.Tensor,
             seeds_epoch: torch.Tensor, counts: torch.Tensor,
             labels_epoch: torch.Tensor, generator: torch.Generator,
             uniforms: Optional[Callable] = None) -> Run:
        steps, cap = seeds_epoch.shape
        run = self._run(uniforms, steps, cap,
                        self._ties(model, graph, feats, generator),
                        lambda rows: self._build(model, graph, feats,
                                                 generator, rows, cap,
                                                 uniforms))
        _copy_up(run.seeds[:steps], seeds_epoch)
        _copy_up(run.labels[:steps], labels_epoch)
        _copy_up(run.counts[:steps], counts)
        run.counter.zero_()
        run.acc.zero_()
        return run

    def replay(self, run: Run, model, graph, feats: torch.Tensor,
               generator: torch.Generator, steps: int,
               uniforms: Optional[Callable] = None) -> torch.Tensor:
        for t in range(steps):
            if uniforms is not None:
                for k, buf in enumerate(run.ubufs):
                    buf.copy_(uniforms(t, k))
            run.step()
        run.ties = self._ties(model, graph, feats, generator)
        return run.acc.clone()
