"""The full-size scale tools (``legion_tpu_torch/tools/smoke_pa_scale.py``,
``smoke_uk_scale.py``) and what they share (``tools/scale.py``), run on the
CPU at a few thousand nodes: each prints one JSON line with its keys, the
single-card hybrid run and the two-rank striped one train, the probe
measures a machine, and no tool falls back to the CPU unasked. The tools
import no JAX, so neither do these tests."""

import json
import os
import time

import numpy as np
import pytest
import torch

from legion_tpu_torch.data import synthetic
from legion_tpu_torch.tools import pa_cell, scale, smoke_pa_scale, \
    smoke_uk_scale
from legion_tpu_torch.train import graphed
from legion_tpu_torch.utils import trace

torch.set_num_threads(2)


@pytest.fixture
def tiny_pa(monkeypatch):
    monkeypatch.setattr(smoke_pa_scale, "GRAPH_ARGS", dict(
        smoke_pa_scale.GRAPH_ARGS, num_nodes=3000, train_num=300,
        valid_num=60, test_num=60))
    monkeypatch.setattr(pa_cell, "BATCH", 64)


@pytest.fixture
def tiny_uk(monkeypatch):
    monkeypatch.setattr(smoke_uk_scale, "NODES", 4000)
    monkeypatch.setattr(pa_cell, "BATCH", 64)


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_smoke_pa_scale_prints_its_line(tmp_path, tiny_pa, capsys):
    """The cached driver at the reference's configuration, budget and
    batch-trimmed sets; the line the tool prints; the graph cached under
    its own prefix, so the cut cell's copy is not removed as stale."""
    cut = tmp_path / ".bench_cache" / "synth_pa_torch_other"
    cut.mkdir(parents=True)
    got = smoke_pa_scale.main(["2", "--device", "cpu", "--root",
                               str(tmp_path)])
    assert _line(capsys) == json.loads(json.dumps(got))
    for k in ("gen_s", "load_s", "setup_s", "ms_per_step",
              "first_epoch_ms_per_step", "hit_rate", "host_gb", "loss",
              "peak_host_rss_gb", "max_memory_allocated_gb", "nvidia_smi"):
        assert k in got, k
    assert got["nodes"] == 3000 and got["steps"] == 2
    assert got["epochs"] == 2 and got["first_epoch_ms_per_step"] > 0
    assert got["budget_bytes"] == 1 << 30 and got["gen_s"] > 0
    assert 0 < got["setup_s"] < got["run_s"]
    assert np.isfinite(got["loss"]) and got["peak_host_rss_gb"] > 0
    assert cut.exists()
    assert os.path.basename(pa_cell.streamed_dir(
        str(tmp_path), smoke_pa_scale.PREFIX, smoke_pa_scale.GRAPH_ARGS)) \
        in os.listdir(tmp_path / ".bench_cache")
    again = smoke_pa_scale.main(["2", "--device", "cpu", "--root",
                                 str(tmp_path)])
    assert again["gen_s"] == 0.0 and again["loss"] == got["loss"]


def test_smoke_uk_scale_single_and_mesh(tmp_path, tiny_uk, capsys):
    """The hybrid driver at the reference's configuration on one device,
    then the striped hybrid driver on two gloo ranks at cache group 2 on
    the same cached graph: the keys of each line, finite losses, both
    ranks' stripes."""
    root = ["--device", "cpu", "--root", str(tmp_path)]
    one = smoke_uk_scale.main(["2", *root])
    assert _line(capsys)["mode"] == "single"
    for k in ("gen_s", "load_s", "setup_s", "ms_per_step",
              "first_epoch_ms_per_step", "hit_rate", "hot_fraction",
              "host_gb", "host_topo_gb", "host_topo_copied_gb",
              "staging_overflow", "host_sample_s", "loss",
              "peak_host_rss_gb", "max_memory_allocated_gb"):
        assert k in one, k
    assert one["nodes"] == 4000 and one["steps"] == 2
    assert one["epochs"] == 2 and one["first_epoch_ms_per_step"] > 0
    assert one["budget_bytes"] == 2 << 30 and np.isfinite(one["loss"])
    assert one["fetches"] == 2 * one["steps"] + 1
    two = smoke_uk_scale.main(["2", "--mesh", *root])
    assert two["gen_s"] == 0.0 and len(two["ranks"]) == 2
    assert two["config"]["group_size"] == 2
    for r in two["ranks"]:
        assert r["mesh"] == {"data": 1, "cache": 2}
        assert r["steps"] == smoke_uk_scale.MESH_STEPS
        assert np.isfinite(r["losses"]).all()
        assert r["exchange_overflow"] == 0
    assert sum(r["stripe_edges"] for r in two["ranks"]) > 0


def test_smoke_uk_scale_probe(tmp_path, tiny_uk, capsys):
    """The machine's facts and the generator's rate at 1/8 of the nodes;
    the probe's graph is removed and its marker says whether an earlier
    probe ran on this disk."""
    first = smoke_uk_scale.main(["--probe", "--root", str(tmp_path)])
    assert _line(capsys)["mode"] == "probe"
    assert first["probe_nodes"] == 500 and first["probe_edges"] > 0
    assert first["edges_per_s"] > 0 and first["cores"] >= 1
    assert first["disk_free_gb"] > 0 and first["ram_total_gb"] > 0
    assert not first["marker_survived"]
    assert first["hole_allocated_bytes"] >= 4096
    assert first["keeps_holes"] == (first["hole_allocated_bytes"]
                                    < first["hole_probe_bytes"])
    assert sorted(os.listdir(tmp_path / ".bench_cache")) == ["probe_marker"]
    assert smoke_uk_scale.main(["--probe", "--root", str(tmp_path)])[
        "marker_survived"]


@pytest.mark.parametrize("tool", [smoke_pa_scale, smoke_uk_scale])
def test_the_tools_need_a_card_unless_asked_for_the_cpu(tool, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tool.main(["1", "--root", str(tmp_path)])
    assert not (tmp_path / ".bench_cache").exists()


def test_peak_rss_sees_an_allocation():
    before = scale.resident_gb()
    out, peak = scale.with_peak_rss(
        lambda: int(np.ones(64 << 20, np.uint8).sum()), period=0.001)
    assert out == 64 << 20 and peak >= before


def test_first_epoch_clock_marks_the_first_call_only():
    class T:
        def run_epoch(self, x):
            return x + 1

    t = T()
    with scale.first_epoch_clock(T) as clock:
        assert t.run_epoch(1) == 2
        first = clock["at"]
        t.run_epoch(2)
    assert clock["at"] == first and clock["trainer"] is t
    assert T.run_epoch(t, 3) == 4 and "at" in clock


def test_shares_refuses_a_copy(tmp_path):
    a = np.arange(10, dtype=np.int32)
    a.tofile(tmp_path / "a")
    m = np.memmap(tmp_path / "a", np.int32, "r")
    scale.shares(np.ascontiguousarray(np.asarray(m), np.int32), m, "view")
    with pytest.raises(RuntimeError, match="copy"):
        scale.shares(np.asarray(m, np.int64), m, "widened")


def test_hole_bytes_tells_a_sparse_filesystem(tmp_path):
    """Where the filesystem keeps holes (tmpfs and the usual Linux ones)
    the probe's file allocates far less than its hole, and leaves
    nothing behind."""
    got = scale.hole_bytes(str(tmp_path / "d"))
    assert 4096 <= got < scale.HOLE_PROBE
    assert os.listdir(tmp_path / "d") == []


def test_holed_twins_refuses_a_filesystem_that_writes_holes(tmp_path,
                                                            monkeypatch):
    """On a filesystem that writes holes out, the twins raise before
    writing anything unless ``write_hole`` asks for the hole."""
    g = synthetic.random_power_law_graph(
        num_nodes=200, avg_degree=4, feature_dim=8, num_classes=3, seed=0)
    monkeypatch.setattr(scale, "hole_bytes",
                        lambda d: scale.HOLE_PROBE + 4096)
    with pytest.raises(RuntimeError, match="writes holes out"):
        scale.holed_twins(g, str(tmp_path / "a"), hole=1 << 10)
    assert not (tmp_path / "a").exists()
    big, twin, facts = scale.holed_twins(g, str(tmp_path / "b"),
                                         hole=1 << 10, write_hole=True)
    assert facts["smallest_real_run_start"] == 1 << 10
    assert big.num_edges == twin.num_edges + (1 << 10)


def test_timed_stages_sums_the_stages_calls():
    """Two eager calls of a step whose body sleeps 10 ms, in an epoch that
    closes inside the block: their ``stage.*`` spans sum to at least
    20 ms, and a sleep in the block outside any stage does not count."""
    step = graphed.GraphedStep(lambda: time.sleep(0.01), None, label="nap")
    with scale.timed_stages() as spent:
        with trace.epoch("train"):
            step()
            step()
        time.sleep(0.05)
    assert 0.02 <= spent[0] < 0.05
