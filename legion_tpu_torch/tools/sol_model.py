"""Whole-step roof of the port's train step on one H100 (counterpart of
``tools/sol_model.py``).

The roof is composed per stage from rates measured on the card, none
fitted to the step's own time, so the model can disagree with the step:

* ``ROW_GATHERS_PER_S``: random 512-byte rows gathered from a
  bench-sized float32 table (2,449,029 x 128), the faster of K3 and
  ``index_select``, as a marginal rate, n / (t(2n) - t(n)).
* ``SCATTER_ROWS_PER_S``: scatter-add update rows of 47 columns (K2
  backward's width, a bf16 gradient into float32 sums) into 121,856 rows,
  the faster of K2's scatter kernel and ``index_add_``, marginal.
* ``SORT_KEYS_PER_S``: ``torch.sort(stable=True)`` of int32 node ids with
  their indices (the dedup's sort), marginal at 208,000 keys.
* ``COPY_BYTES_PER_S``: a device-to-device copy, bytes read plus written,
  marginal between 512 MiB and 1 GiB.
* ``GEMM_TFLOPS``: ``F.linear`` and its two gradient products at the
  step's shapes, in bf16 and in float32 (no TF32); the fastest shape's
  rate, so that every product's roof is below its own time.

They are measured by ``python -m legion_tpu_torch.tools.sol_model
--measure`` and written below by hand, with the card and the run.
``python -m legion_tpu_torch.tools.sol_model --trace`` holds the roof
against steady steps of the bench (replays of its captured step) under
``torch.profiler``: each stage's roof must not exceed the device time of
that stage's kernels a step.

The stages are the port's step, not the TPU's: draws as index reads on
a plain CSR (no line descriptors), hop 1's sort dedup and its tail's
bytes (``ops/dedup.py::dedup_traffic``), K3's row gather, K1's
read pass, the GEMMs, K2's backward scatter, and the elementwise passes
and Adam.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

from legion_tpu_torch.ops.dedup import dedup_traffic

# Every rate: one run of ``--measure`` on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit, torch 2.11.0+cu128 (PERF.md §6 lists the run).
# The card they describe, as ``torch.cuda.get_device_name`` gives it: the
# bench gives no roof on another card.
RATES_CARD = "NVIDIA H100 80GB HBM3"
# H100 80GB HBM3, 700.00 W: K3 (index_select 1.664e9)
ROW_GATHERS_PER_S = 2876417018.4402013
# H100 80GB HBM3, 700.00 W: K2's scatter (index_add_ 2.886e9)
SCATTER_ROWS_PER_S = 16270746310.380346
# H100 80GB HBM3, 700.00 W
SORT_KEYS_PER_S = 26337103361.665443
# H100 80GB HBM3, 700.00 W
COPY_BYTES_PER_S = 3056251514516.4126
# H100 80GB HBM3, 700.00 W: bf16 at (121856, 128, 256) forward, float32
# at its weight gradient
GEMM_TFLOPS = {"bfloat16": 210.76904633806254,
               "float32": 48.89615634113273}

STAGES = ("sample", "dedup", "gather", "aggregate", "matmuls",
          "bwd_scatter", "elementwise")


def sage_flops(batch: int, m_hop1: int, hidden: int, feat_dim: int,
               num_classes: int) -> int:
    """Matrix-product flops of one train step of the bench's 2-layer SAGE.
    Layer 0 reduces first (K1) and transforms m_hop1 rows twice (fc_neigh
    on the means, fc_self on the prefix); its inputs are features, so its
    backward is the weight gradients alone (2x forward). Layer 1
    transforms first (``num_classes < hidden``): fc_neigh over the m_hop1
    rows, fc_self over the batch; its backward has both gradients (3x)."""
    l0 = 2 * m_hop1 * feat_dim * hidden
    l1 = m_hop1 * hidden * num_classes + batch * hidden * num_classes
    return 2 * (2 * l0 + 3 * l1)


def step_roof_ms(batch: int, caps, fanouts, hidden: int, feat_dim: int,
                 num_classes: int, bf16: bool = True,
                 edges: Optional[float] = None) -> Dict[str, float]:
    """Per-stage roof (ms) of one bench train step: 2-layer SAGE, hop 1
    deduped, hop 2 identity-appended, K1 at layer 0 and transform-first K2
    at layer 1. caps: (caps[0] >= batch, the hop-1 frontier, the
    identity-append extent caps[1] * (1 + fanouts[1])). Padding rows are
    not work the step must do: the seeds count as ``batch``. ``edges``,
    where known, is the run's valid sampled edges per step: hop 2's
    valid slots are then at least ``edges - batch * fanouts[0]``, and the
    draws and K1 count those instead of every slot of the cap."""
    caps = list(caps)
    f1, f2 = fanouts
    m_hop1, m_final = caps[1], caps[-1]
    act = 2 if bf16 else 4
    row = feat_dim * 4
    valid2 = m_hop1 * f2 if edges is None else max(edges - batch * f1, 0)

    # 1. draws: per valid slot an index and a uniform read, per slot the
    #    id written, per frontier row its id and an indptr pair (two hops)
    slots = batch * f1 + m_hop1 * f2
    t_sample = (8 * (batch * f1 + valid2) + 4 * slots
                + 12 * (batch + m_hop1)) / COPY_BYTES_PER_S

    # 2. hop 1's dedup: one stable sort over [seeds | draws], then its
    #    tail's bytes (the sorted ids and indices read, the positions and
    #    the frontier written)
    keys = batch * (1 + f1)
    t_dedup = (keys / SORT_KEYS_PER_S
               + dedup_traffic(keys, batch, m_hop1) / COPY_BYTES_PER_S)

    # 3. feature gather: the hop-1 frontier's rows are distinct, each one
    #    random row; the appended rows repeat hubs, which the L2 serves,
    #    so they count as their writes alone
    t_gather = (m_hop1 / ROW_GATHERS_PER_S
                + (m_final - m_hop1) * row / COPY_BYTES_PER_S)

    # 4. K1 reads the valid appended slots' float32 rows and writes the
    #    means; K2's forward reads the batch's slot rows and writes its rows
    agg_bytes = (valid2 * row + m_hop1 * feat_dim * act
                 + batch * f1 * num_classes * act
                 + batch * num_classes * act)
    t_agg = agg_bytes / COPY_BYTES_PER_S

    # 5. matrix products at the fastest measured GEMM rate
    rate = GEMM_TFLOPS["bfloat16" if bf16 else "float32"] * 1e12
    t_mm = sage_flops(batch, m_hop1, hidden, feat_dim, num_classes) / rate

    # 6. K2's backward: one update row per slot of the batch's block
    t_scatter = batch * f1 / SCATTER_ROWS_PER_S

    # 7. relu, dropout and its mask over the hidden activations (three
    #    passes), and Adam over the parameters (read p, g, m, v; write p,
    #    m, v in float32)
    params = 2 * feat_dim * hidden + hidden + 2 * hidden * num_classes
    t_elem = (3 * m_hop1 * hidden * act + 7 * 4 * params) / COPY_BYTES_PER_S

    out = {"sample": t_sample * 1e3, "dedup": t_dedup * 1e3,
           "gather": t_gather * 1e3, "aggregate": t_agg * 1e3,
           "matmuls": t_mm * 1e3, "bwd_scatter": t_scatter * 1e3,
           "elementwise": t_elem * 1e3}
    out["total"] = sum(out.values())
    return out


def sol_fraction(measured_step_ms: float, roof: Dict[str, float]) -> float:
    """Roof time over measured time (1.0: the step runs at its roof)."""
    return roof["total"] / measured_step_ms


# -- on the card ---------------------------------------------------------

# the bench step's kernels by stage (lower-case name fragments); the rest
# is "elementwise"
_KERNEL_STAGES = (
    ("sample", ("sample_neighbors",)),
    ("dedup", ("radixsort", "radix_sort", "onesweep", "dedup_tail")),
    ("gather", ("gather_rows_kernel",)),
    ("aggregate", ("masked_agg_kernel", "gathered_agg_kernel")),
    ("bwd_scatter", ("scatter_rows_kernel", "narrow_rows_kernel")),
    ("matmuls", ("gemm", "nvjet", "cutlass", "xmma", "splitk", "gemv")),
)


def stage_of(kernel: str) -> str:
    """The roof's stage of a kernel of the bench step, by its name."""
    name = kernel.lower()
    for stage, parts in _KERNEL_STAGES:
        if any(p in name for p in parts):
            return stage
    return "elementwise"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _marginal(fn_of_n: Callable[[int], Callable[[], object]],
              n: int) -> Dict:
    """Per-item rate n / (t(2n) - t(n)) of fn_of_n(k)() calls, and both
    times (CUDA events, ``bench_kernels.time_ms``)."""
    from legion_tpu_torch.tools.bench_kernels import time_ms
    t1 = time_ms(fn_of_n(n))
    t2 = time_ms(fn_of_n(2 * n))
    return {"n": n, "ms_n": t1, "ms_2n": t2, "per_s": n / ((t2 - t1) * 1e-3)}


def measure_rates(nodes: int = 2_449_029, batch: int = 8000,
                  m_hop1: int = 121_856, fanouts: Sequence[int] = (25, 10),
                  hidden: int = 256, feat_dim: int = 128,
                  num_classes: int = 47) -> Dict:
    """Every rate of the roof, on the card, at the bench step's sizes."""
    import torch
    import torch.nn.functional as F

    from legion_tpu_torch.ops.gather import gather_rows
    from legion_tpu_torch.ops.identity_agg import (scatter_masked_rows,
                                                   staging_width)
    from legion_tpu_torch.tools.bench_kernels import time_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out: Dict = {"nvidia_smi": smi(), "torch": torch.__version__,
                 "device": torch.cuda.get_device_name(0)}

    # random 512-byte rows from a bench-sized table
    table = torch.randn((nodes, feat_dim), generator=gen, device=dev)
    ids = torch.randint(0, nodes, (1 << 22,), generator=gen, device=dev,
                        dtype=torch.int32)
    n = 1 << 20
    k3 = _marginal(lambda k: lambda: gather_rows(table, ids[:k]), n)
    lids = ids.long()
    lib = _marginal(lambda k: lambda: torch.index_select(table, 0,
                                                         lids[:k]), n)
    out["row_gathers"] = {"k3": k3, "index_select": lib,
                          "per_s": max(k3["per_s"], lib["per_s"])}
    del table, ids, lids

    # scatter-add rows of K2's backward width into m_hop1 rows, as the
    # bf16 step gives them: a bf16 gradient into the padded f32 staging
    f1 = fanouts[0]
    p = 2 * batch
    g = torch.randn((2 * p, num_classes), generator=gen, device=dev)
    pos = torch.randint(0, m_hop1, (2 * p, f1), generator=gen, device=dev,
                        dtype=torch.int32)
    mask = torch.ones((2 * p, f1), dtype=torch.bool, device=dev)
    gb = g.to(torch.bfloat16)
    staging = torch.zeros((m_hop1, staging_width(num_classes,
                                                 torch.bfloat16)),
                          device=dev)
    kern = _marginal(lambda k: lambda: scatter_masked_rows(
        gb[:k // f1], pos[:k // f1], mask[:k // f1], staging, "mean"),
        p * f1)
    sums = torch.zeros((m_hop1, num_classes), device=dev)
    src = g[:, None, :].expand(-1, f1, -1).reshape(-1, num_classes)
    flat = pos.reshape(-1).long()
    lib = _marginal(lambda k: lambda: sums.index_add_(0, flat[:k], src[:k]),
                    p * f1)
    out["scatter_rows"] = {"kernel": kern, "index_add": lib,
                           "per_s": max(kern["per_s"], lib["per_s"])}
    del g, gb, pos, mask, staging, sums, src, flat

    # the dedup's stable sort of node ids with their indices
    nk = batch * (1 + f1)
    keys = torch.randint(0, nodes, (2 * nk,), generator=gen, device=dev,
                         dtype=torch.int32)
    out["sort_keys"] = _marginal(
        lambda k: lambda: torch.sort(keys[:k], stable=True), nk)

    # a device-to-device copy: bytes read plus written
    a = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)
    cp = _marginal(lambda k: lambda: b[:k].copy_(a[:k]), 1 << 27)
    cp["bytes_per_s"] = 2 * 4 * cp["per_s"]
    out["copy"] = cp
    del a, b

    # the step's matrix products: forward, weight and input gradients
    shapes = [(m_hop1, feat_dim, hidden), (m_hop1, hidden, num_classes),
              (batch, hidden, num_classes)]
    gemms: Dict = {}
    for dt in (torch.bfloat16, torch.float32):
        recs = []
        for m, k, nn_ in shapes:
            x = torch.randn((m, k), generator=gen, device=dev).to(dt)
            w = torch.randn((nn_, k), generator=gen, device=dev).to(dt)
            gy = torch.randn((m, nn_), generator=gen, device=dev).to(dt)
            flops = 2 * m * k * nn_
            for what, fn in (("forward", lambda: F.linear(x, w)),
                             ("weight_grad", lambda: gy.t() @ x),
                             ("input_grad", lambda: gy @ w)):
                ms = time_ms(fn)
                recs.append({"shape": [m, k, nn_], "product": what,
                             "ms": ms, "tflops": flops / ms * 1e-9})
        gemms[str(dt).split(".")[-1]] = {
            "shapes": recs, "tflops": max(r["tflops"] for r in recs)}
    out["gemm"] = gemms
    return out


def trace_step(cache_dir: str, steps: int = 5, warmup: int = 20) -> Dict:
    """The bench's main variant under ``torch.profiler``: ``steps``
    replays of the captured step (``epoch_scan`` over a ``steps``-row
    seeds matrix), after ``warmup`` steps whose first scan captures; each
    stage's device time per step beside its roof at the bench's caps, and
    the replays' device time by CUDA events; raises when the trace holds
    no kernel of a stage. The graph and caps memos of
    ``legion_tpu_torch.bench`` in ``cache_dir`` are used or made."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from legion_tpu_torch import bench
    args = bench.parse_args(["--cache-dir", cache_dir, "--steps", str(steps)])
    setup = bench.prepare(args)
    state, fns = bench.build_variant("fanout", setup)

    def scan():
        return fns.epoch_scan(state, setup.graph, setup.feats, setup.seeds,
                              setup.labels)[:, 1]

    for _ in range(-(-warmup // steps)):
        scan()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        ev[0].record()
        edges = scan()
        ev[1].record()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    replay_ms = ev[0].elapsed_time(ev[1]) / steps
    edges_per_step = float(edges.mean())
    by_kernel: Dict[str, float] = {}
    for e in prof.events():
        # device kernels, copies and fills; not the annotations of ranges
        # (``Optimizer.step``), which span kernels counted on their own
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3 / steps)
    if not any(stage_of(n) != "elementwise" for n in by_kernel):
        raise RuntimeError("the replays' trace holds no kernel of a stage")
    traced = {s: 0.0 for s in STAGES}
    for name, ms in by_kernel.items():
        traced[stage_of(name)] += ms
    cfg = setup.cfg
    roof = step_roof_ms(args.batch, setup.caps, bench.FANOUTS,
                        cfg.model.hidden_dim, setup.feats.shape[1],
                        cfg.dataset.num_classes,
                        bf16=cfg.model.dtype == "bfloat16",
                        edges=edges_per_step)
    top: List = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:40]
    return {"nvidia_smi": smi(), "caps": list(setup.caps),
            "traced_steps": steps, "edges_per_step": edges_per_step,
            "wall_ms_per_step_traced": wall_ms,
            "replay_ms_per_step": replay_ms,
            "busy_ms_per_step": sum(by_kernel.values()),
            "stages": {s: {"roof_ms": roof[s], "traced_ms": traced[s],
                           "floor_holds": roof[s] <= traced[s]}
                       for s in STAGES},
            "roof_total_ms": roof["total"],
            "floor_holds": all(roof[s] <= traced[s] for s in STAGES),
            "top_kernels_ms": [[n, ms, stage_of(n)] for n, ms in top]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", action="store_true",
                    help="measure every rate on the card")
    ap.add_argument("--trace", action="store_true",
                    help="hold each stage's roof against a traced step")
    ap.add_argument("--cache-dir", default=None,
                    help="the bench's cache directory (--trace)")
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure_rates()), flush=True)
    if args.trace:
        from legion_tpu_torch import bench
        rec = trace_step(args.cache_dir or bench.DEFAULT_CACHE)
        print(json.dumps(rec), flush=True)
        if not rec["floor_holds"]:
            sys.exit(1)
    if not (args.measure or args.trace):
        roof = step_roof_ms(8000, (8000, 122240, 1344640), (25, 10), 256,
                            128, 47)
        for k, v in roof.items():
            print(f"{k:>12}: {v:8.4f} ms")


if __name__ == "__main__":
    main()
