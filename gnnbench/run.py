"""One run of one cell:

    python3 -m gnnbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It makes the cell's inputs on the card from
the seed, runs the configuration's driver through its own set-up (whose
first steps ``observe`` reads), measures whole epochs for ``--seconds``
(``--trace 1``: a short traced window instead, see ``trace.py``), checks
the observed steps against the plain reference once the window has
closed, and prints one JSON line last on stdout: ``correct``,
``attempted`` and ``failed`` (training steps of the window, and those of
its epochs that dropped rows), ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones, each read by its module under
``metrics/``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which also end stderr.

It refuses to run (exit 2, no result) without as many CUDA devices as the
cell asks for, and fails (exit 3, no result) if the process holds a JAX
module when the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from gnnbench.cell import ROOT, benchmark, load_cell  # noqa: E402

# every build and kernel cache of a run inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, ".gnnbench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(CACHE, _sub)

import torch  # noqa: E402

from gnnbench import check, graphgen, metrics  # noqa: E402
from gnnbench.observe import Observer  # noqa: E402
from gnnbench.sizes import realized  # noqa: E402
from gnnbench.trace import traced_epochs  # noqa: E402

# top-level module names the harness's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "legion_tpu")
OBSERVED_STEPS = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def metric_names(bench: Dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, or that list no cells."""
    return [m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool,
             device, names: list, limits: Dict,
             control: bool = False) -> Dict:
    """Set-up, window and check of ``cell``; returns the result line's
    fields, with the raw ``readings``."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    inputs = graphgen.make_inputs(cell["configuration"], seed, dev)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    observer = Observer(OBSERVED_STEPS)
    ctx: Dict = {"cell": cell, "window": None, "trace": None}

    def window(epoch) -> None:
        if cuda:
            torch.cuda.synchronize()
        ctx["setup_s"] = time.perf_counter() - T0
        if trace:
            ctx["trace"] = traced_epochs(epoch)
        elif seconds > 0:
            recs, times = [], []
            t0 = time.perf_counter()
            while not times or time.perf_counter() - t0 < seconds:
                t = time.perf_counter()
                recs.append(epoch())
                times.append(time.perf_counter() - t)
            ctx["window"] = {"records": recs, "epoch_s": times,
                             "window_s": time.perf_counter() - t0}
        ctx["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if cuda
                             else 0)
        if ctx["window"] is not None:
            ctx["window"]["peak_bytes"] = ctx["peak_bytes"]

    driver = importlib.import_module(
        f"gnnbench.drivers.{cell['configuration']['driver']}")
    setup = driver.drive(cell, inputs, seed, dev, observer, window)
    ctx["setup"] = setup
    ctx["sizes"] = realized(observer.steps, cell)
    observer.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    recs = (ctx["window"] or {}).get("records") or \
        (ctx["trace"] or {}).get("records") or []
    dropped = sum(r["overflow"] for r in recs)
    values = check.readings(observer, setup, inputs, cell, dev, dropped,
                            control=control)
    correct, checks = check.judge(values, limits, OBSERVED_STEPS)
    out = {}
    for name in names:
        mod = metrics.reader(name)
        v = mod.read(ctx)
        if v is not None:
            out[name] = {"value": float(v), "unit": mod.UNIT}
    steps = sum(r["steps"] for r in recs)
    failed = sum(r["steps"] for r in recs if r["overflow"] > 0)
    res = {"correct": bool(correct), "attempted": steps, "failed": failed,
           "metrics": out, "ctx": ctx, "readings": values,
           "checks": checks}
    return res


def window_summary(ctx: Dict) -> Dict:
    """What the window's epochs reported, for the log: epochs, their wall
    times' quartiles, and the cached trainer's mean hit rate and staging
    seconds a step."""
    w = ctx["window"] or ctx["trace"] or {}
    recs = w.get("records", [])
    out = {"epochs": len(recs), "window_s": w.get("window_s")}
    if "epoch_s" in w and len(w["epoch_s"]) > 1:
        q = statistics.quantiles(w["epoch_s"], n=4)
        out.update(epoch_s_min=min(w["epoch_s"]), epoch_s_q=q,
                   epoch_s_max=max(w["epoch_s"]))
    steps = sum(r["steps"] for r in recs) or 1
    if recs and "hit_rate" in recs[0]:
        out["hit_rate"] = sum(r["hit_rate"] for r in recs) / len(recs)
        out["stage_ms_per_step"] = 1e3 * sum(r["stage_s"]
                                             for r in recs) / steps
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        log(f"{args.workload} needs {entry['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cell = load_cell(args.workload)
    names = metric_names(bench, args.workload,
                         "per_layer" if args.trace else "end_to_end")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   names, cell["limits"])
    bad = forbidden_modules()
    if bad:
        log(f"the process holds JAX modules: {bad}")
        return 3
    ctx = res["ctx"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"],
              "memory_peak_bytes": int(ctx["peak_bytes"]),
              "card": card_line()}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        device["busy_s"] = ctx["trace"]["busy_s"]
        device["window_s"] = ctx["trace"]["window_s"]
        line["breakdown"] = ctx["trace"]["breakdown"]
    log("readings: " + json.dumps(res["readings"]))
    log("window: " + json.dumps(window_summary(ctx)))
    line["checks"] = res["checks"]
    print(json.dumps(line), flush=True)
    for k, (v, lim) in res["checks"].items():
        log(f"check {k}: {v} limit {lim}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
