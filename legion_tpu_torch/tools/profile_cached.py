"""Where the time of the cached path at papers100M class goes, or of the
hybrid (host-topology) path at uk-union class.

    python -m legion_tpu_torch.tools.profile_cached [PATH]

from the repository root, on a machine with the card. PATH picks the
cell: ``cached`` (the default: ``run_cached_training`` on ``pa_cell``'s
configuration and cut graph), ``hybrid`` (``run_hybrid_training`` on
``hybrid_cell``'s), or the same drivers at full size, ``pa_full``
(``smoke_pa_scale``'s configuration and 111M-node graph) and ``uk_full``
(``smoke_uk_scale``'s, 5.52B edges); each graph is generated into
``.bench_cache/`` on first use and trimmed to 10 training steps and 2
eval batches a set. It runs three epochs and traces epoch 1 under
``torch.profiler``: epoch 0 warms up and captures the pipeline's device
stages, so epoch 1 replays them (the steady state). It prints one JSON
line: every epoch's ms/step, the host seconds inside the device stages'
calls (``stage_calls_s``: epoch 0's warm-ups and captures, then replays),
staging seconds, hit rate, host GB and edges/s (for the hybrid path also
the hot fraction and the host sampler's and the packed reads' seconds);
for the profiled epoch the wall time, the device-busy time
(``device_busy_ms``: the union of the spans of the device's kernels and
copies, as ``chip_smoke.py::replay_profile`` reads a replay), the idle
share ``1 - busy / wall``, the largest device rows and the largest host
rows. Ranges that the profiler mirrors onto the device timeline
(``Optimizer.step#Adam.step``) are not counted, since the kernels inside
them are.
"""

from __future__ import annotations

import json
import os
import sys
from unittest import mock

import torch

from legion_tpu_torch.cache.hybrid import HybridTrainer
from legion_tpu_torch.cache.pipeline import CachedTrainer
from legion_tpu_torch.tools import (hybrid_cell, pa_cell, scale,
                                    smoke_pa_scale, smoke_uk_scale)
from legion_tpu_torch.train.cached_driver import run_cached_training
from legion_tpu_torch.train.hybrid_driver import run_hybrid_training

EPOCHS, PROFILED_EPOCH = 3, 1
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHED = (CachedTrainer, run_cached_training,
          ("stage_s", "cache_hit_rate", "host_gb", "edges_per_s",
           "staging_overflow"))
HYBRID = (HybridTrainer, run_hybrid_training,
          ("stage_s", "host_sample_s", "fetch_s", "feat_hit_rate",
           "topo_hot_fraction", "host_feat_gb", "host_topo_gb",
           "edges_per_s", "staging_overflow", "fetches"))
# path -> ((trainer whose run_epoch is traced, driver, the epoch figures
# printed), configuration, dataset)
PATHS = {
    "cached": (CACHED, pa_cell.config, pa_cell.dataset),
    "hybrid": (HYBRID, hybrid_cell.config, hybrid_cell.dataset),
    "pa_full": (CACHED, smoke_pa_scale.config, smoke_pa_scale.dataset),
    "uk_full": (HYBRID, smoke_uk_scale.config,
                lambda root, log: smoke_uk_scale.dataset(root, log=log)),
}


def device_busy_ms(events) -> float:
    """Milliseconds of the device covered by the spans of ``events``
    (profiler device records), each overlap once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def _rows(events, key, n):
    top = sorted(events, key=lambda e: -getattr(e, key))[:n]
    return [[e.key, e.count, getattr(e, key) / 1e3] for e in top]


def main(path: str = "cached") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_cached needs a CUDA device")
    (trainer, driver, figures), config, dataset = PATHS[path]
    log = lambda s: print(s, file=sys.stderr, flush=True)   # noqa: E731
    data, gen_s, load_s = dataset(ROOT, log)
    data = scale.trim(data, pa_cell.STEPS * pa_cell.BATCH + 1,
                      2 * pa_cell.BATCH)
    run_epoch = trainer.run_epoch
    calls, profiled = [], {}

    def traced(self, *args):
        r = profiled_epoch(self, *args)
        calls.append(scale.stage_seconds(r["spans"]))
        return r

    def profiled_epoch(self, *args):
        if len(calls) != PROFILED_EPOCH:
            return run_epoch(self, *args)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            r = run_epoch(self, *args)
            torch.cuda.synchronize()
        ev = prof.key_averages()
        # device rows named as a host row are ranges the profiler mirrors
        # onto the device timeline (the optimizer step): their kernels are
        # rows of their own already
        host = {e.key for e in ev
                if e.device_type == torch.autograd.DeviceType.CPU}
        dev = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in host]
        busy = device_busy_ms(
            e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and e.name not in host)
        wall = r["seconds"] * 1e3
        profiled.update(
            epoch=PROFILED_EPOCH, steps=r["steps"], wall_ms=wall,
            device_busy_ms=busy, idle_share=1.0 - busy / wall,
            stage_s=r["stage_s"],
            device_top=_rows(dev, "self_device_time_total", 25),
            host_top=_rows(ev, "self_cpu_time_total", 15))
        return r

    with mock.patch.object(trainer, "run_epoch", traced):
        res = driver(config(EPOCHS), data, "cuda", log=log)
    print(json.dumps({
        "path": path, "device": scale.card_line(), "gen_s": gen_s,
        "load_s": load_s, "nodes": data.num_nodes, "edges": data.num_edges,
        "epochs": [{"ms_per_step": 1e3 * h["seconds"] / h["steps"],
                    "stage_calls_s": s, **{k: h[k] for k in figures}}
                   for h, s in zip(res["history"], calls)],
        "profiled": profiled}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:2])
