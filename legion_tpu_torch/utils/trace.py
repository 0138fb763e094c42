"""Host spans and counters of the port's drivers, and the profiler export.

A **span** (``span(name)``, a context manager) adds to the tally of the
epoch that encloses it: its calls, its inclusive seconds and its self
seconds (inclusive minus what its child spans cover). Spans nest through
one stack, so each has a parent. A **counter** (``count(name, n)``) adds
to the same tally. An **epoch root** (``epoch(kind)``, ``kind`` "train"
or "eval") is the span ``epoch`` with a tally of its own: when it closes
it appends ``{"kind", "steps", "spans": {name: [calls, total_s,
self_s]}, "counts": {name: n}}`` to a ring of the last ``RING`` epochs,
which ``epochs(kind)`` reads; the trainers put that entry's ``spans``
and ``counts`` into their epoch records. Spans and counters outside any
epoch (the drivers' ``setup.*``) go to the tally of set-up,
``TRACER.setup``.

The tally is host-only and always on: no span or counter makes a CUDA
event, a synchronize, a device read or any device work. While a
``torch.profiler`` records, each span is also a ``record_function``
range, so it lies on the profiler's clock beside the kernels and names
the host work under the device's idle gaps; without one no
``record_function`` is made (~12 us each on an H100 machine's host even
with no profiler), and the profiler flag is the one check a span adds
to its clock pair.

The names (the drivers, ``cache/pipeline.py``, ``cache/hybrid.py``,
``train/graphed.py``): ``epoch.prepare`` (seeds, labels, the loads into
the static rows: ``epoch.seeds``, ``epoch.labels``, ``epoch.load``),
``epoch.steps``, ``epoch.prefetch`` (``Trainer``: the next epoch's seeds
and labels drawn while the steps run), ``epoch.read``, ``epoch.record``;
``stage.<label>`` for each call of a captured step or stage and
``stage.capture`` for a first call's warm-up and capture;
``pipeline.dispatch``,
``pipeline.plan_wait``, ``pipeline.stage``, ``pipeline.consume``;
``hybrid.fetch``, ``hybrid.host_sample``; ``setup.*``; counters
``h2d_bytes`` (bytes copied host->device), ``seeds_prefetched`` (1 an
epoch that took the draw held from the epoch before), ``fetches``,
``host_topo_copied_bytes``, ``attn_slots`` (GAT: the slots its attention
scored in the epoch, self slots included, over every layer; counted on
the device in each step and read with the epoch's metrics, so it adds no
sync).

One thread drives a trainer, and the tracer is the process's, as the
launch counts of ``train/graphed.py`` and the collectives' counts of
``utils/comm.py`` are. ``profiled`` is the ``train.profile_dir``
exporter every driver uses.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 256
_clock = time.perf_counter


class Tally:
    """Spans ({name: [calls, total_s, self_s]}) and counts ({name: n})."""

    __slots__ = ("spans", "counts")

    def __init__(self):
        self.spans: Dict[str, List] = {}
        self.counts: Dict[str, int] = {}


class Span:
    """An open span; after it closes, ``seconds`` is its inclusive time."""

    __slots__ = ("tracer", "name", "parent", "child", "t0", "range",
                 "seconds")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self) -> "Span":
        stack = self.tracer.stack
        self.parent = stack[-1] if stack else None
        self.child = 0.0
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        else:
            self.range = None
        self.t0 = _clock()
        return self

    def elapsed(self) -> float:
        """Seconds since the open span began."""
        return _clock() - self.t0

    def __exit__(self, *exc) -> None:
        self.seconds = dt = _clock() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        tr = self.tracer
        tr.stack.pop()
        if self.parent is not None:
            self.parent.child += dt
        spans = tr.tally.spans
        row = spans.get(self.name)
        if row is None:
            row = spans[self.name] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += dt
        row[2] += dt - self.child


class Root(Span):
    """An epoch root: the span ``epoch`` over a tally of its own
    (``tally``, which the record reads before the root closes), whose
    entry it appends to the ring when it closes (``entry``). The driver
    sets ``steps``."""

    __slots__ = ("kind", "steps", "outer", "tally", "entry")

    def __init__(self, tracer: "Tracer", kind: str):
        super().__init__(tracer, "epoch")
        self.kind = kind
        self.steps = 0
        self.entry: Optional[Dict] = None

    def __enter__(self) -> "Root":
        tr = self.tracer
        self.outer = tr.tally
        self.tally = tr.tally = Tally()
        return super().__enter__()

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        tr = self.tracer
        tr.tally = self.outer
        self.entry = {"kind": self.kind, "steps": self.steps,
                      "spans": self.tally.spans, "counts": self.tally.counts}
        tr.ring.append(self.entry)


class Tracer:
    """The stack of open spans, the tally they add to, the ring of closed
    epochs and the set-up tally."""

    def __init__(self):
        self.stack: List[Span] = []
        self.setup = Tally()
        self.tally = self.setup
        self.ring: collections.deque = collections.deque(maxlen=RING)

    def span(self, name: str) -> Span:
        return Span(self, name)

    def epoch(self, kind: str) -> Root:
        return Root(self, kind)

    def count(self, name: str, n: int) -> None:
        counts = self.tally.counts
        counts[name] = counts.get(name, 0) + n

    def epochs(self, kind: Optional[str] = None) -> List[Dict]:
        """The ring's entries, oldest first (of ``kind`` only, if given)."""
        return [e for e in self.ring if kind is None or e["kind"] == kind]


TRACER = Tracer()
span = TRACER.span
epoch = TRACER.epoch
count = TRACER.count
epochs = TRACER.epochs


def seconds(tally: Tally, name: str) -> float:
    """Inclusive seconds of ``name`` in ``tally`` (0 if it never ran)."""
    row = tally.spans.get(name)
    return row[1] if row else 0.0


@contextlib.contextmanager
def profiled(train_cfg, epoch_index: int, device):
    """``torch.profiler`` (CPU, and CUDA on a CUDA device) around the block
    when ``train_cfg.profile_dir`` is set, its chrome trace written there
    as ``epoch_<epoch_index>.pt.trace.json``; nothing otherwise. Yields
    the profiler or None."""
    if not train_cfg.profile_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(train_cfg.profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        train_cfg.profile_dir, f"epoch_{epoch_index}.pt.trace.json"))
