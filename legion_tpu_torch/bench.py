"""Headline benchmark of the port: GraphSAGE mini-batch training throughput
(edges/s) on one card (counterpart of ``bench.py``).

    python -m legion_tpu_torch.bench                  # on the card
    python -m legion_tpu_torch.bench --device cpu --nodes 4000 --deg 10 \\
        --batch 256 --steps 3                         # plain versions, CPU

The workload is bench.py's: GraphSAGE, hidden 256, fanout [25, 10],
batch 8000, bf16 compute with float32 parameters, Adam at lr 0.003, on
``data/synthetic.py::bench_graph`` (2,449,029 nodes, ~122M edges, 100
features padded to 128, 47 classes). The whole step is measured: neighbor
sampling, dedup and renumbering, the feature gather, forward, backward
and Adam, every step through ``train/loop.py::make_step_fns``'
``epoch_scan``: on the card the step is captured once as a CUDA graph
and replayed, as bench.py times ``jax.jit(epoch_scan)``.

Stage 1 probes the realized frontier sizes on 3 batches at loose caps and
tightens the static caps to ``--slack`` times the maxima (aligned to 128;
the last cap is the identity append's exact extent). Stage 2 runs the
``--steps`` steps once to warm up (the capture happens there), then twice
timed, and keeps the faster trial. A trial's window ends in its one device-to-host fetch; its edges
are summed as int64 on the host, and a step whose frontier overflowed its
cap fails the run.

``vs_baseline`` is the speed-up over the same pipeline with the
scatter-based SpMM (``SAGE(agg="coo_segment")``: ``index_add_`` over the
COO edge list, no K1 or K2). ``roof_ms`` and ``sol_frac`` come from
``tools/sol_model.py``'s roof of the step from rates measured on the H100
(JSON null where it fails, and on the CPU); ``kernel_gate`` is
``tools/bench_kernels.py``'s gate (``"not_run:cpu"`` on the CPU).

It prints exactly one JSON line on stdout, with bench.py's keys; the
rest, both trials' ms/step of each variant among it, goes to stderr.

Flags take the place of bench.py's ``BENCH_*`` variables, which are not
read. ``BENCH_PRNG`` and ``BENCH_LAYOUT`` have no counterpart: they pick
the TPU's rbg generator and the lined CSR layout, where the port draws
from a ``torch.Generator`` and reads a plain CSR. Memos live under
``<cache-dir>/torch/``: the graph, the probed caps (keyed as bench.py's,
with the device type and seed, since the draws differ) and the baseline
(keyed by dtype, slack, steps, seed, the card's name and ``code_hash``).
The JAX bench's memos are never read.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from legion_tpu_torch.cache.hotness import (observed_caps,
                                            probe_frontier_maxima)
from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data.format import (GraphData, load_dataset,
                                          pad_feature_dim, save_dataset)
from legion_tpu_torch.data.synthetic import bench_graph
from legion_tpu_torch.models.sage import SAGE
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import DeviceGraph
from legion_tpu_torch.train.graphed import GraphPool
from legion_tpu_torch.train.loop import StepFns, make_step_fns
from legion_tpu_torch.train.train_state import (TrainState,
                                                create_train_state)

FANOUTS = (25, 10)
PROBE_BATCHES = 3
PACKAGE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CACHE = os.path.join(os.path.dirname(PACKAGE), ".bench_cache")
# the port's files that the baseline variant runs (bench.py's
# shared_code_hash list): its memo is stale when one of them changes
BASELINE_PATH = (
    "bench.py", "sampling/sampler.py", "sampling/block.py", "train/loop.py",
    "train/graphed.py", "train/train_state.py", "models/sage.py", "ops/segment.py",
    "ops/identity_agg.py", "ops/gather.py", "ops/sample.py", "ops/_build.py",
    "csrc/legion_kernels.cu", "cache/hotness.py")
KEYS = ("metric", "value", "unit", "vs_baseline", "step_ms", "roof_ms",
        "sol_frac", "roof_stages_ms", "kernel_gate", "kernels")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8000)
    ap.add_argument("--steps", type=int, default=160,
                    help="steps of the warm-up and of each timed trial")
    ap.add_argument("--nodes", type=int, default=2_449_029)
    ap.add_argument("--deg", type=int, default=50)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--slack", type=float, default=1.03,
                    help="cap slack over the probed frontier maxima")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE,
                    help="memos go to <cache-dir>/torch/")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def code_hash(root: str = PACKAGE,
              files: Sequence[str] = BASELINE_PATH) -> str:
    """Content hash of the port's files on the baseline variant's path
    (counterpart of bench.py's ``shared_code_hash``)."""
    h = hashlib.sha256()
    for rel in files:
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:10]


def graph_dir(cache_dir: str, nodes: int, deg: int) -> str:
    return os.path.join(cache_dir, "torch", f"synth_{nodes}_{deg}")


def load_or_gen(args: argparse.Namespace,
                log: Callable[[str], None] = log) -> GraphData:
    """``bench_graph`` at (nodes, deg), memoized by ``save_dataset``."""
    t0 = time.perf_counter()
    path = graph_dir(args.cache_dir, args.nodes, args.deg)
    if os.path.exists(os.path.join(path, "meta.json")):
        data = load_dataset(path, mmap=False)
        log(f"graph loaded from cache {time.perf_counter() - t0:.1f}s")
        return data
    log(f"generating {args.nodes} nodes x deg {args.deg} graph ...")
    data = bench_graph(num_nodes=args.nodes, avg_degree=args.deg)
    save_dataset(data, path)
    log(f"graph gen {time.perf_counter() - t0:.1f}s; "
        f"edges={data.num_edges}")
    return data


def seeds_matrix(train_ids: np.ndarray, steps: int, batch: int,
                 seed: int) -> np.ndarray:
    """(steps, batch) seed ids, one permutation of the train ids a step:
    bench.py's expression, so the port trains on the JAX bench's seeds."""
    rng = np.random.default_rng(seed)
    ids = np.asarray(train_ids)
    return np.stack([rng.permutation(ids)[:batch] for _ in range(steps)])


def make_config(args: argparse.Namespace) -> Config:
    return Config(
        dataset=DatasetConfig(num_classes=47),
        sampler=SamplerConfig(fanouts=FANOUTS, batch_size=args.batch),
        model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype=args.dtype),
        train=TrainConfig(learning_rate=0.003))


@dataclasses.dataclass
class Setup:
    """What every variant trains on: the graph and features on the
    device, the seeds and labels of every step, and the probed caps."""
    cfg: Config
    device: torch.device
    graph: DeviceGraph
    feats: torch.Tensor
    seeds: torch.Tensor          # (steps, batch) int32
    labels: torch.Tensor         # (steps, batch) int32
    caps: Tuple[int, ...]
    seed: int

    @property
    def steps(self) -> int:
        return self.seeds.shape[0]


def memo_dir(args: argparse.Namespace) -> str:
    path = os.path.join(args.cache_dir, "torch")
    os.makedirs(path, exist_ok=True)
    return path


def probe_caps(graph: DeviceGraph, seeds: torch.Tensor,
               args: argparse.Namespace,
               log: Callable[[str], None] = log) -> Tuple[int, ...]:
    """Realized per-hop frontier sizes on the first batches at loose caps,
    tightened to ``--slack`` times their maxima; memoized. Intermediate
    caps come from observation; the last is the identity append's exact
    extent."""
    dev = seeds.device
    memo = os.path.join(
        memo_dir(args), f"caps_nd_{args.nodes}_{args.deg}_{args.batch}"
        f"_s{args.slack}_{dev.type}_seed{args.seed}.json")
    if os.path.exists(memo):
        with open(memo) as f:
            caps = tuple(json.load(f))
        log(f"observed caps from cache: {caps}")
        return caps
    loose = frontier_caps(args.batch, FANOUTS)
    t0 = time.perf_counter()
    num = torch.tensor(args.batch, dtype=torch.int32, device=dev)
    mx = probe_frontier_maxima(
        graph, [(seeds[i], num) for i in range(min(PROBE_BATCHES,
                                                   seeds.shape[0]))],
        FANOUTS, loose, torch.Generator(device=dev).manual_seed(100))
    caps = observed_caps(mx, slack=args.slack, align=128,
                         last_exact_fanout=FANOUTS[-1])
    log(f"cap probe {time.perf_counter() - t0:.1f}s: observed {mx.tolist()}"
        f" -> caps {caps} (loose {loose})")
    with open(memo, "w") as f:
        json.dump(list(caps), f)
    return caps


def prepare(args: argparse.Namespace, data: Optional[GraphData] = None,
            log: Callable[[str], None] = log) -> Setup:
    """The graph (generated or loaded, unless given), its features and the
    steps' seeds on ``--device``, and the probed caps."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("legion_tpu_torch.bench needs a CUDA device "
                         "(torch.cuda.is_available() is False); "
                         "--device cpu runs the plain versions")
    if data is None:
        data = load_or_gen(args, log)
    graph = DeviceGraph.from_host(data.indptr, data.indices, dev)
    feats = torch.from_numpy(np.ascontiguousarray(pad_feature_dim(
        np.asarray(data.features, np.float32)))).to(dev)
    seeds_np = seeds_matrix(data.train_ids, args.steps, args.batch,
                            args.seed)
    labels_np = np.asarray(data.labels)[seeds_np]
    seeds = torch.from_numpy(seeds_np.astype(np.int32)).to(dev)
    labels = torch.from_numpy(labels_np.astype(np.int32)).to(dev)
    caps = probe_caps(graph, seeds, args, log)
    return Setup(cfg=make_config(args), device=dev, graph=graph,
                 feats=feats, seeds=seeds, labels=labels, caps=caps,
                 seed=args.seed)


def build_variant(agg: str, setup: Setup) -> Tuple[TrainState, StepFns]:
    """A fresh SAGE with aggregator ``agg`` (weights from ``seed``), its
    Adam state and the step functions at the probed caps, whose scans
    capture in a pool of their own."""
    cfg = setup.cfg
    model = SAGE(setup.feats.shape[1], cfg.model.hidden_dim,
                 cfg.dataset.num_classes, cfg.model.num_layers,
                 cfg.model.dropout, dtype=getattr(torch, cfg.model.dtype),
                 generator=torch.Generator().manual_seed(setup.seed),
                 agg=agg).to(setup.device)
    state = create_train_state(model, cfg.train.learning_rate, setup.seed,
                               setup.device)
    return state, make_step_fns(cfg, setup.caps,
                                pool=GraphPool(setup.device))


def run_steps(fns: StepFns, state: TrainState,
              setup: Setup) -> torch.Tensor:
    """Every step of the seeds matrix through ``epoch_scan`` (on the card,
    a replay of the captured step each, after the first call's capture);
    returns (last loss, cap overflow, edges of each step) as one float64
    host tensor: the window's only device-to-host read. Each step's edges
    (< 2^24) ride exactly."""
    m = fns.epoch_scan(state, setup.graph, setup.feats, setup.seeds,
                       setup.labels)
    return torch.cat([torch.stack([m[-1, 0], m[:, 3].sum()]),
                      m[:, 1]]).cpu()


def run_variant(agg: str, setup: Setup,
                log: Callable[[str], None] = log) -> Dict:
    """Warm-up pass, then two timed trials over the same steps; the faster
    trial gives edges/s and ms/step. Raises on a cap overflow."""
    state, fns = build_variant(agg, setup)
    t0 = time.perf_counter()
    run_steps(fns, state, setup)
    log(f"[{agg}] warm-up {time.perf_counter() - t0:.1f}s")
    trials: List[Dict] = []
    for _ in range(2):
        t0 = time.perf_counter()
        packed = run_steps(fns, state, setup)
        dt = time.perf_counter() - t0
        overflow = int(packed[1])
        if overflow:
            raise RuntimeError(f"[{agg}] frontier cap overflow ({overflow} "
                               "ids dropped): raise --slack")
        trials.append({"s": dt, "edges": int(packed[2:].to(torch.int64)
                                              .sum()),
                       "loss": float(packed[0])})
    for i, t in enumerate(trials):
        log(f"[{agg}] trial {i}: {setup.steps} steps in {t['s']!r} s = "
            f"{1e3 * t['s'] / setup.steps!r} ms/step, {t['edges']} edges, "
            f"loss {t['loss']!r}")
    best = min(trials, key=lambda t: t["s"])
    eps = best["edges"] / best["s"]
    log(f"[{agg}] best {eps:.4e} edges/s")
    return {"agg": agg, "edges_per_s": eps,
            "step_ms": 1e3 * best["s"] / setup.steps,
            "edges_per_step": best["edges"] / setup.steps,
            "trials_ms_per_step": [1e3 * t["s"] / setup.steps
                                   for t in trials],
            "losses": [t["loss"] for t in trials]}


def baseline(args: argparse.Namespace, setup: Setup,
             log: Callable[[str], None] = log) -> float:
    """The coo_segment variant's edges/s, memoized under a key that holds
    everything it depends on."""
    dev = setup.device
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu").replace(" ", "_")
    memo = os.path.join(
        memo_dir(args), f"baseline_{args.nodes}_{args.deg}_{args.batch}_"
        f"{args.dtype}_s{args.slack}_n{args.steps}_seed{args.seed}_{card}"
        f"_h{code_hash()}.json")
    if os.path.exists(memo):
        with open(memo) as f:
            eps = json.load(f)["edges_per_s"]
        log(f"[coo_segment] baseline from cache: {eps:.4e} edges/s")
        return eps
    rec = run_variant("coo_segment", setup, log)
    with open(memo, "w") as f:
        json.dump(rec, f)
    return rec["edges_per_s"]


def roof(setup: Setup, step_ms: float, edges_per_step: float,
         log: Callable[[str], None] = log) -> Tuple[Dict, Optional[float]]:
    """The step's roof from the H100's measured rates at this run's caps
    and valid edges, and the measured step's fraction of it; ({"total":
    None}, None) on the CPU, on a card other than the one the rates were
    measured on, or when the model fails, so that the headline stands."""
    from legion_tpu_torch.tools.sol_model import (RATES_CARD, sol_fraction,
                                                  step_roof_ms)
    if setup.device.type != "cuda":
        log(f"roof model: rates of the {RATES_CARD}, not applied on the CPU")
        return {"total": None}, None
    card = torch.cuda.get_device_name(setup.device)
    if card != RATES_CARD:
        log(f"roof model: rates measured on the {RATES_CARD}, not applied "
            f"on the {card}")
        return {"total": None}, None
    try:
        cfg = setup.cfg
        stages = step_roof_ms(setup.seeds.shape[1], setup.caps, FANOUTS,
                              cfg.model.hidden_dim, setup.feats.shape[1],
                              cfg.dataset.num_classes,
                              bf16=cfg.model.dtype == "bfloat16",
                              edges=edges_per_step)
        sol = sol_fraction(step_ms, stages)
    except Exception as exc:  # never lose the headline to the roof
        log(f"roof model errored: {type(exc).__name__}: {exc}")
        return {"total": None}, None
    log("roof model [ms]: " + ", ".join(f"{k}={v!r}" for k, v in
                                        stages.items())
        + f"; measured {step_ms!r} -> sol_frac {sol!r}")
    return stages, sol


def gate(device: torch.device,
         log: Callable[[str], None] = log) -> Tuple[str, List[Dict]]:
    """(kernel_gate, kernels): the on-card gate in quick mode, or what
    kept it from running."""
    if device.type != "cuda":
        return "not_run:cpu", []
    try:
        from legion_tpu_torch.tools.bench_kernels import run_gate
        res = run_gate(quick=True, log=log)
    except Exception as exc:  # never lose the headline to the gate
        log(f"kernel gate errored: {exc}")
        return f"ERROR:{type(exc).__name__}:{exc}", []
    verdict = ("pass" if not res["failures"]
               else "FAIL:" + ",".join(res["failures"]))
    return verdict, [{"kernel": k["kernel"], "ok": k["ok"]}
                     for k in res["kernels"]]


def measure(args: argparse.Namespace, data: Optional[GraphData] = None,
            log: Callable[[str], None] = log) -> Dict:
    """The benchmark's record (bench.py's keys)."""
    setup = prepare(args, data, log)
    fan = run_variant("fanout", setup, log)
    stages, sol = roof(setup, fan["step_ms"], fan["edges_per_step"], log)
    eps_coo = baseline(args, setup, log)
    kernel_gate, kernels = gate(setup.device, log)
    total = stages["total"]
    return {
        "metric": "train_edges_per_s",
        "value": round(fan["edges_per_s"], 1),
        "unit": "edges/s",
        "vs_baseline": round(fan["edges_per_s"] / eps_coo, 3),
        "step_ms": round(fan["step_ms"], 2),
        "roof_ms": None if total is None else round(float(total), 2),
        "sol_frac": None if sol is None else round(float(sol), 3),
        "roof_stages_ms": {k: round(float(v), 2) for k, v in stages.items()
                           if k != "total"},
        "kernel_gate": kernel_gate,
        "kernels": kernels,
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    print(json.dumps(measure(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
