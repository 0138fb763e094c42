"""The span-and-counter tracer (``legion_tpu_torch/utils/trace.py``): its
tally against hand sums, its cost contract (no ``record_function``
without a profiler, the span names on the profiler's timeline with one),
the drivers' spans and counters in their epoch records, and the
benchmark's metrics that read the tracer's ring."""

from __future__ import annotations

import dataclasses
import itertools
import sys

import numpy as np
import pytest
import torch

from gnnbench.metrics import (epoch_host_ms, host_to_device_mb_per_step,
                              miss_stage_ms_per_step)
from legion_tpu_torch.cache.feature_cache import cache_dtype_for
from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                     ModelConfig, SamplerConfig, TrainConfig)
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.sampling.seeds import seeds_of_epoch
from legion_tpu_torch.train.cached_driver import run_cached_training
from legion_tpu_torch.train.hybrid_driver import run_hybrid_training
from legion_tpu_torch.train.loop import Trainer
from legion_tpu_torch.utils import trace

torch.set_num_threads(2)

B, FANOUTS = 64, (5, 4)


@pytest.fixture(scope="module")
def graph():
    return random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=7, seed=1)


@pytest.fixture
def setup_tally(monkeypatch):
    """A fresh set-up tally, which the spans outside any epoch add to."""
    t = trace.Tally()
    monkeypatch.setattr(trace.TRACER, "setup", t)
    monkeypatch.setattr(trace.TRACER, "tally", t)
    return t


@pytest.fixture
def ticks(monkeypatch):
    """The tracer's clock as whole ticks: each read is one more."""
    clock = itertools.count(1)
    monkeypatch.setattr(trace, "_clock", lambda: float(next(clock)))


def _cfg(g, cached=False, topo_host=False, epochs=1, **train):
    return Config(
        dataset=DatasetConfig(
            num_classes=g.num_classes,
            feature_placement="host" if cached else "hbm",
            topology_placement="host" if topo_host else "hbm"),
        sampler=SamplerConfig(fanouts=FANOUTS, batch_size=B,
                              eval_batch_size=B, probe_caps=False,
                              dedup_last=cached),
        model=ModelConfig(hidden_dim=16, dropout=0.0),
        train=TrainConfig(epochs=epochs, learning_rate=0.01, **train),
        cache=CacheConfig(enabled=cached, budget_bytes=64 * 1024,
                          presample_steps=2))


# -- the tally ----------------------------------------------------------------

def test_nesting_parents_and_self_time_are_the_hand_sums(ticks):
    """Each clock read is one tick: the root opens at 1, ``a`` at 2 holds
    two ``b`` of one tick each (3-4, 5-6) and closes at 7, ``c`` runs
    8-9, the root closes at 10."""
    with trace.epoch("train") as root:
        root.steps = 2
        with trace.span("a") as a:
            assert a.parent is root
            for _ in range(2):
                with trace.span("b") as b:
                    assert b.parent is a
        with trace.span("c"):
            trace.count("n", 3)
    assert root.entry == {
        "kind": "train", "steps": 2, "counts": {"n": 3},
        "spans": {"epoch": [1, 9.0, 3.0], "a": [1, 5.0, 3.0],
                  "b": [2, 2.0, 2.0], "c": [1, 1.0, 1.0]}}
    assert trace.epochs("train")[-1] is root.entry
    assert root.seconds == 9.0 and a.seconds == 5.0


def test_roots_keep_their_own_tallies(ticks):
    """A span outside any epoch adds to set-up's tally; an epoch root
    opened inside another's span keeps its spans apart, and its time is
    the outer span's child time."""
    before = trace.TRACER.setup.spans.get("setup.x", [0, 0.0, 0.0])[0]
    with trace.span("setup.x"):
        pass
    assert trace.TRACER.setup.spans["setup.x"][0] == before + 1
    with trace.epoch("train") as outer:
        with trace.span("epoch.steps"):                # 2 .. 9
            with trace.epoch("eval") as inner:          # 3 .. 8
                with trace.span("epoch.steps"):         # 4 .. 5
                    pass
                with trace.span("epoch.read"):          # 6 .. 7
                    pass
    assert inner.entry["spans"] == {"epoch.steps": [1, 1.0, 1.0],
                                    "epoch.read": [1, 1.0, 1.0],
                                    "epoch": [1, 5.0, 3.0]}
    assert outer.entry["spans"] == {"epoch.steps": [1, 7.0, 2.0],
                                    "epoch": [1, 9.0, 2.0]}
    assert trace.epochs("eval")[-1] is inner.entry
    assert trace.epochs("train")[-1] is outer.entry


def test_a_raising_span_still_closes():
    with pytest.raises(ValueError):
        with trace.epoch("train") as root:
            with trace.span("epoch.steps"):
                raise ValueError("step failed")
    assert set(root.entry["spans"]) == {"epoch", "epoch.steps"}
    tracer = trace.TRACER
    assert tracer.stack == [] and tracer.tally is tracer.setup


def test_the_ring_holds_the_last_epochs():
    for i in range(trace.RING + 3):
        with trace.epoch("eval") as root:
            root.steps = i
    steps = [e["steps"] for e in trace.epochs("eval")]
    assert len(trace.epochs()) == trace.RING
    assert steps[-1] == trace.RING + 2 and len(steps) <= trace.RING


# -- the cost contract -------------------------------------------------------

def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with trace.epoch("train"):
        with trace.span("epoch.steps"):
            trace.count("h2d_bytes", 4)


def test_spans_are_host_events_under_the_profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.epoch("train"):
            with trace.span("epoch.prepare"):
                torch.ones(4).sum()
            with trace.span("pipeline.stage"):
                pass
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU}
    assert {"epoch", "epoch.prepare", "pipeline.stage"} <= names


# -- the drivers' records -----------------------------------------------------

def _assert_nested(spans, parent, children):
    """``parent``'s inclusive time covers its children's."""
    assert spans[parent][1] >= sum(spans[c][1] for c in children) - 1e-9


def test_trainer_epoch_carries_its_spans_and_counts(graph):
    tr = Trainer(_cfg(graph), graph, device="cpu")
    rec = tr.train_one_epoch(0)
    steps = rec["steps"]
    assert set(rec["spans"]) == {
        "epoch", "epoch.prepare", "epoch.seeds", "epoch.labels",
        "epoch.load", "epoch.steps", "epoch.prefetch", "epoch.read",
        "epoch.record", "stage.train_step"}
    assert rec["spans"]["stage.train_step"][0] == steps
    _assert_nested(rec["spans"], "epoch.prepare",
                   ("epoch.seeds", "epoch.labels", "epoch.load"))
    _assert_nested(rec["spans"], "epoch", (
        "epoch.prepare", "epoch.steps", "epoch.prefetch", "epoch.read",
        "epoch.record"))
    # seeds and labels up
    assert rec["counts"] == {"h2d_bytes": 2 * steps * B * 4}
    assert 0 < rec["epoch_s"] <= rec["spans"]["epoch"][1]
    entry = trace.epochs("train")[-1]
    assert entry["spans"] is rec["spans"] and entry["steps"] == steps
    tr.evaluate("valid")
    ev = trace.epochs("eval")[-1]
    assert "stage.eval_step" in ev["spans"]
    assert "stage.eval_step" not in trace.epochs("train")[-1]["spans"]


def test_epoch_s_leaves_out_the_seeds(graph, ticks):
    """``epoch_s`` runs from the root's start to the record, less the
    seed permutation: the root's ticks less the two after the record
    reads the clock (the record's and the root's close) and the seeds'."""
    rec = Trainer(_cfg(graph), graph, device="cpu").train_one_epoch(0)
    spans = rec["spans"]
    assert spans["epoch.seeds"][1] == 1.0
    assert rec["epoch_s"] == spans["epoch"][1] - 2 - spans["epoch.seeds"][1]


PREFETCH_EPOCHS = (0, 1, 2, 5, 6)


@pytest.fixture(scope="module")
def prefetch_run(graph):
    """A Trainer's epochs 0, 1, 2, 5, 6 in that order: the trainer, and
    each epoch's record with the seeds and labels its run's static rows
    held after it."""
    tr = Trainer(_cfg(graph), graph, device="cpu")
    out = []
    for e in PREFETCH_EPOCHS:
        rec = tr.train_one_epoch(e)
        run, steps = tr.fns.epoch_scan.runs[False], rec["steps"]
        out.append((e, rec, run.seeds[:steps].clone(),
                    run.labels[:steps].clone()))
    return tr, out


def test_every_epoch_trains_on_its_own_seeds_in_any_order(graph,
                                                          prefetch_run):
    """Each epoch loads exactly ``seeds_of_epoch``'s seeds and their
    labels, whether the draw was held from the epoch before (1, 2, 6) or
    made at the call (0, and 5 after 2: the held draw was for 3); only
    the held ones count ``seeds_prefetched``, and the bytes up are the
    same either way."""
    tr, runs = prefetch_run
    labels = np.asarray(graph.labels, np.int32)
    for e, rec, seeds, labs in runs:
        want = seeds_of_epoch(tr.cfg.train.seed, e, tr.shards_train,
                              tr.plan)[0]
        assert torch.equal(seeds, torch.from_numpy(want)), e
        assert torch.equal(labs, torch.from_numpy(labels[want])), e
        assert rec["counts"]["h2d_bytes"] == 2 * rec["steps"] * B * 4
    assert [rec["counts"].get("seeds_prefetched", 0)
            for _, rec, _, _ in runs] == [0, 1, 1, 0, 1]
    assert tr.prefetched.key[1] == 7


def test_a_held_draw_trains_as_a_fresh_one(graph, prefetch_run):
    """A trainer whose held draw is dropped before every call draws each
    epoch afresh and gives bitwise the losses of one that took it."""
    _, runs = prefetch_run
    tr = Trainer(_cfg(graph), graph, device="cpu")
    for e, rec, _, _ in runs[:3]:
        tr.prefetched = None
        got = tr.train_one_epoch(e)
        assert "seeds_prefetched" not in got["counts"]
        assert got["losses"] == rec["losses"], e


def test_another_shard_draws_afresh(graph):
    """The held draw is for the shard it was drawn from: the next epoch of
    another shard draws its own seeds and counts no hit."""
    tr = Trainer(_cfg(graph), graph, device="cpu", num_shards=2)
    tr.train_one_epoch(0, shard=0)
    rec = tr.train_one_epoch(1, shard=1)
    assert "seeds_prefetched" not in rec["counts"]
    want = seeds_of_epoch(tr.cfg.train.seed, 1, [tr.shards_train[1]],
                          tr.plan)[0]
    run = tr.fns.epoch_scan.runs[False]
    assert torch.equal(run.seeds[:rec["steps"]], torch.from_numpy(want))
    assert tr.train_one_epoch(2, shard=1)["counts"]["seeds_prefetched"] == 1


def test_cached_epoch_spans_stage_s_and_bytes(graph, setup_tally):
    """The cached driver's epoch: the pipeline's spans, ``stage_s`` the
    wait plus the staging, ``presample_s`` the ``setup.presample`` span,
    and the bytes up exactly: seeds, seed counts and labels, the staged
    rows (``host_gb``) and the epoch's six totals."""
    cfg = _cfg(graph, cached=True)
    res = run_cached_training(cfg, graph, "cpu", log=lambda s: None)
    rec = res["history"][0]
    spans, counts, steps = rec["spans"], rec["counts"], rec["steps"]
    assert {"epoch", "epoch.prepare", "epoch.load", "epoch.steps",
            "epoch.read", "epoch.record", "pipeline.dispatch",
            "pipeline.plan_wait", "pipeline.stage", "pipeline.consume",
            "stage.sample_plan", "stage.train_from"} == set(spans)
    for name in ("pipeline.plan_wait", "pipeline.stage", "pipeline.consume",
                 "pipeline.dispatch", "stage.train_from"):
        assert spans[name][0] == steps, name
    _assert_nested(spans, "pipeline.consume", ("stage.train_from",))
    _assert_nested(spans, "pipeline.dispatch", ("stage.sample_plan",))
    assert rec["stage_s"] == (spans["pipeline.plan_wait"][1]
                              + spans["pipeline.stage"][1])
    row_bytes = cache_dtype_for(cfg.model.dtype, graph.feature_dim)[1]
    staged = round(rec["host_gb"] * 2 ** 30)
    assert staged > 0 and staged % row_bytes == 0
    assert counts["h2d_bytes"] == (steps * B * 4 + steps * 4 + steps * B * 4
                                   + staged + 6 * 8)
    setup = setup_tally.spans
    assert rec["presample_s"] == setup["setup.presample"][1]
    assert {"setup.cost_model", "setup.cache_build"} <= set(setup)


def test_hybrid_record_reads_the_tally(graph, setup_tally):
    cfg = _cfg(graph, cached=True, topo_host=True)
    res = run_hybrid_training(cfg, graph, "cpu", log=lambda s: None)
    rec = res["history"][0]
    spans, counts = rec["spans"], rec["counts"]
    assert rec["fetch_s"] == spans["hybrid.fetch"][1]
    assert rec["host_sample_s"] == spans["hybrid.host_sample"][1]
    assert rec["stage_s"] == spans["pipeline.stage"][1]
    assert rec["fetches"] == counts["fetches"] == spans["hybrid.fetch"][0]
    assert rec["fetches"] == len(FANOUTS) * rec["steps"] + 1
    assert rec["host_topo_copied_gb"] * 2 ** 30 == counts[
        "host_topo_copied_bytes"]
    assert {"stage.start", "stage.hop1", "stage.finish",
            "stage.train_from"} <= set(spans)
    assert rec["presample_s"] == setup_tally.spans["setup.presample"][1]
    assert trace.epochs("eval")[-1]["counts"]["fetches"] > 0


def test_profile_dir_trace_of_the_trainer_holds_the_spans(graph, tmp_path):
    import json
    cfg = _cfg(graph, profile_dir=str(tmp_path))
    Trainer(cfg, graph, device="cpu").train_one_epoch(0)
    names = {e.get("name") for e in json.loads(
        (tmp_path / "epoch_0.pt.trace.json").read_text())["traceEvents"]}
    assert {"epoch", "epoch.prepare", "epoch.steps", "epoch.record",
            "stage.train_step"} <= names


# -- the benchmark's metrics --------------------------------------------------

def _window():
    """Two earlier train epochs and an eval (outside the window), then the
    window's two train epochs of 4 steps: prepare, 4 staging spans and
    the record each, 64,000 bytes up a step."""
    for kind in ("train", "train", "eval", "train", "train"):
        with trace.epoch(kind) as root:
            root.steps = 4
            with trace.span("epoch.prepare"):
                pass
            for _ in range(4):
                with trace.span("pipeline.stage"):
                    pass
            with trace.span("epoch.record"):
                pass
            trace.count("h2d_bytes", 4 * 64_000 if kind == "train" else 1)
    return {"trace": {"records": [{"steps": 4}, {"steps": 4}]}}


def test_metrics_read_the_window_epochs(ticks):
    ctx = _window()
    # one tick a span: prepare + record = 2 s an epoch; a stage 1 s a step
    assert epoch_host_ms.read(ctx) == 2000.0
    assert miss_stage_ms_per_step.read(ctx) == 1000.0
    assert host_to_device_mb_per_step.read(ctx) == 0.064


def test_metrics_without_their_spans_or_a_trace(ticks):
    with trace.epoch("train") as root:
        root.steps = 3
        with trace.span("epoch.prepare"):
            pass
    ctx = {"trace": {"records": [{"steps": 3}]}}
    assert epoch_host_ms.read(ctx) == 1000.0
    assert miss_stage_ms_per_step.read(ctx) is None
    assert host_to_device_mb_per_step.read(ctx) is None
    for mod in (epoch_host_ms, miss_stage_ms_per_step,
                host_to_device_mb_per_step):
        assert mod.read({"trace": None}) is None


@pytest.mark.parametrize("mod", [epoch_host_ms, miss_stage_ms_per_step,
                                 host_to_device_mb_per_step])
def test_metrics_read_nothing_from_a_program_without_the_tracer(
        ticks, monkeypatch, mod):
    """The parent's program has no ``utils/trace.py``: the import fails
    and the metric is left out, without raising."""
    import legion_tpu_torch.utils
    ctx = _window()
    monkeypatch.delattr(legion_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "legion_tpu_torch.utils.trace", None)
    assert mod.read(ctx) is None


def test_profiled_writes_nothing_without_a_directory(tmp_path):
    cfg = dataclasses.replace(TrainConfig(), profile_dir=None)
    with trace.profiled(cfg, 3, "cpu") as prof:
        assert prof is None
    cfg = dataclasses.replace(cfg, profile_dir=str(tmp_path / "p"))
    with trace.profiled(cfg, 3, "cpu") as prof:
        assert prof is not None
    assert [p.name for p in (tmp_path / "p").iterdir()] == [
        "epoch_3.pt.trace.json"]
