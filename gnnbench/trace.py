"""The traced run's window: whole epochs under ``torch.profiler`` (CPU and
CUDA activity), read after a spin-kernel mark.

Late in a long process the profiler has dropped the first device records
of its window (as ``chip_smoke.py::traced_launches`` records), so
one epoch runs first inside the profile to take what is lost, a spin
kernel marks its end, and only the records after the mark are read. The
device's busy time is the union of the spans of its kernels and copies
after the mark (ranges the profiler mirrors onto the device timeline,
such as the optimizer's, are left out: their kernels are records of their
own); the window is the host's wall time of the epochs after the mark.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

from gnnbench.counting import device_busy_us, idle_gaps

# the traced epochs after the mark: at least this many, and more while
# they have lasted less than TRACE_SECONDS
MIN_EPOCHS = 2
TRACE_SECONDS = 1.0
SPIN_CYCLES = 1_000_000
TOP = 10
# the longest idle gaps named by the host operation under them; the host
# operations looked back over for each
NAMED_GAPS = 500
LOOK_BACK = 5000


def traced_epochs(epoch: Callable[[], Dict]) -> Dict:
    """Run ``epoch`` under the profiler as the module says; returns the
    epochs' records, the kernels after the mark as (name, start_us,
    end_us), ``busy_s``, ``window_s`` and the ``breakdown``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    records: List[Dict] = []
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        epoch()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)                  # the mark
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while (len(records) < MIN_EPOCHS
               or time.perf_counter() - t0 < TRACE_SECONDS):
            records.append(epoch())
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    host_names = {e.name for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU}
    dev = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation
                  and e.name not in host_names),
                 key=lambda e: e.time_range.start)
    mark = max(i for i, e in enumerate(dev) if "spin_kernel" in e.name)
    lo = dev[mark].time_range.end
    kernels = [(e.name, float(e.time_range.start), float(e.time_range.end))
               for e in dev[mark + 1:]]
    hi = max((k[2] for k in kernels), default=lo)
    spans = [(a, b) for _, a, b in kernels]
    busy_us = device_busy_us(spans)
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in kernels:
        by_name[name] += (b - a) / 1e6
    host = sorted(((float(e.time_range.start), float(e.time_range.end),
                    e.name) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.time_range.start >= lo),
                  key=lambda h: h[0])
    gaps: Dict[str, float] = defaultdict(float)
    starts = [h[0] for h in host]
    idle = sorted(idle_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])
    for a, b in idle[:NAMED_GAPS]:
        gaps[_host_at(host, starts, (a + b) / 2)] += (b - a) / 1e6
    if len(idle) > NAMED_GAPS:
        gaps["shorter gaps"] += sum(b - a for a, b in idle[NAMED_GAPS:]) / 1e6
    return {"records": records, "kernels": kernels,
            "busy_s": busy_us / 1e6, "window_s": window_s,
            "breakdown": {
                "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                     key=lambda kv: -kv[1])[:TOP],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                    key=lambda kv: -kv[1])[:TOP]}}


def _host_at(host, starts, t: float) -> str:
    """The innermost host operation running at ``t`` (``host``: (start,
    end, name) sorted by start, ``starts`` their starts), or ``python``
    where none is."""
    best = None
    for a, b, name in reversed(host[max(0, bisect.bisect_right(starts, t)
                                        - LOOK_BACK):
                                    bisect.bisect_right(starts, t)]):
        if b >= t and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "python"
