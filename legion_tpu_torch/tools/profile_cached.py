"""Where the time of the cached path at papers100M class goes, or of the
hybrid (host-topology) path at uk-union class.

    python -m legion_tpu_torch.tools.profile_cached [hybrid]

from the repository root, on a machine with the card. It runs
``run_cached_training`` on ``pa_cell``'s configuration (with ``hybrid``:
``run_hybrid_training`` on ``hybrid_cell``'s) and dataset (generated into
``.bench_cache/`` on first use) for three epochs and traces epoch 1
under ``torch.profiler``: epoch 0 warms up and captures the pipeline's
device stages, so epoch 1 replays them (the steady state). It prints one
JSON line: every epoch's ms/step, staging seconds, hit rate, host GB and
edges/s (for the hybrid path also the hot fraction and the host
sampler's and the packed reads' seconds); for the profiled epoch the wall
time, the device-busy time (``device_busy_ms``: the union of the spans
of the device's kernels and copies, as ``chip_smoke.py::replay_profile``
reads a replay), the idle share ``1 - busy / wall``, the largest device
rows and the largest host rows. Ranges that the profiler mirrors onto
the device timeline (``Optimizer.step#Adam.step``) are not counted,
since the kernels inside them are.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from unittest import mock

import torch

from legion_tpu_torch.cache.hybrid import HybridTrainer
from legion_tpu_torch.cache.pipeline import CachedTrainer
from legion_tpu_torch.tools import hybrid_cell, pa_cell
from legion_tpu_torch.train.cached_driver import run_cached_training
from legion_tpu_torch.train.hybrid_driver import run_hybrid_training

EPOCHS, PROFILED_EPOCH = 3, 1
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# path -> (trainer whose run_epoch is traced, driver, configuration, the
# epoch figures printed)
PATHS = {
    "cached": (CachedTrainer, run_cached_training, pa_cell.config,
               ("stage_s", "cache_hit_rate", "host_gb", "edges_per_s",
                "staging_overflow")),
    "hybrid": (HybridTrainer, run_hybrid_training, hybrid_cell.config,
               ("stage_s", "host_sample_s", "fetch_s", "feat_hit_rate",
                "topo_hot_fraction", "host_feat_gb", "host_topo_gb",
                "edges_per_s", "staging_overflow", "fetches")),
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
    trainer, driver, config, figures = PATHS[path]
    log = lambda s: print(s, file=sys.stderr, flush=True)   # noqa: E731
    data, gen_s, load_s = pa_cell.dataset(ROOT, log)
    run_epoch = trainer.run_epoch
    calls, profiled = [], {}

    def traced(self, *args):
        calls.append(None)
        if len(calls) != PROFILED_EPOCH + 1:
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({
        "path": path, "device": smi, "gen_s": gen_s, "load_s": load_s,
        "epochs": [{"ms_per_step": 1e3 * h["seconds"] / h["steps"],
                    **{k: h[k] for k in figures}}
                   for h in res["history"]],
        "profiled": profiled}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:2])
