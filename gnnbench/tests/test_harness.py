"""The harness by name: cells, configurations, traffic and metrics found
from ``BENCHMARK.json``; its refusal to run without a card; no JAX in its
process; and a tiny cell of each configuration run end to end on the CPU,
correct."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from gnnbench import cell as cells
from gnnbench import metrics, run
from gnnbench.tests.conftest import SEED, tiny_cell

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_names_files_that_exist():
    bench = cells.benchmark()
    assert bench["command"][:2] == ["python3", "-m"]
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert conf["source"] == c["source"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        c = cells.load_cell(w["name"])
        assert c["config"] == w["config"] and c["traffic"] == w["traffic"]
        assert c["chips"] == w["chips"]
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            mod = metrics.reader(m["name"])
            assert mod.UNIT == m["unit"]
            assert mod.MOVES == (m["name"] if kind == "end_to_end"
                                 else m["moves"])
            if kind == "per_layer":
                assert mod.LAYER == m["layer"]


def test_metric_names_follow_the_cells_they_list():
    bench = cells.benchmark()
    names = run.metric_names(bench, "sage-products.b8000", "per_layer")
    assert "cache_hit_rate" not in names and "device_idle_share" in names
    names = run.metric_names(bench, "sage-papers100m.cache100", "per_layer")
    assert "cache_hit_rate" in names and "presample_s" in names


def test_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    rc = run.main(["--workload", "sage-products.b8000", "--seed", "1",
                   "--seconds", "1"])
    assert rc == 2
    assert capsys.readouterr().out == ""


def test_no_jax_in_the_process():
    probe = (
        "import sys\n"
        "from gnnbench import run\n"
        "from gnnbench.drivers import trainer, cached\n"
        "from gnnbench.tests.conftest import tiny_cell, SEED\n"
        "c = tiny_cell('sage-products.b8000')\n"
        "run.run_cell(c, SEED, 0.2, False, 'cpu', [], c['limits'])\n"
        "print(run.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "legion_tpu_torch_extra", sys)
    assert "legion_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in run.forbidden_modules()


@pytest.mark.parametrize("name", ["sage-products.b8000",
                                  "sage-papers100m.cache15",
                                  "sage-papers100m.cache100",
                                  "sage-products.b8000.3layers"])
def test_tiny_cell_runs_correct_on_the_cpu(name):
    c = tiny_cell(name)
    names = [m["name"] for m in cells.benchmark()["end_to_end"]]
    res = run.run_cell(c, SEED, 0.3, False, "cpu", names, c["limits"])
    assert res["correct"], res["checks"]
    assert res["readings"]["sampler_faults"] == 0
    assert res["readings"]["rows_checked_steps"] >= 1
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == set(names)
    for m in res["metrics"].values():
        assert m["value"] >= 0
