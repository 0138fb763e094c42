"""The port's command line, ``python -m legion_tpu_torch.train``
(``legion_tpu_torch/train/__main__.py``), against ``train.py``: the same
config JSON for the same flags, the dispatch to each driver with
``train.py``'s warnings, the registry and ``--config`` checks, and two
gloo ranks training through ``--devices 2 --device cpu``, on each
cache-group path and the edge-partitioned path too. Single-device runs
are in-process on the CPU; ``train.py`` and the two-rank runs are
subprocesses."""

import json
import os
import subprocess
import sys

import pytest
import torch

from legion_tpu_torch.data.format import save_dataset
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.train import __main__ as cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--batch-size", "64", "--fanouts", "4,3", "--hidden-dim", "16",
         "--epochs", "1"]


@pytest.fixture(scope="module")
def packed_dir(tmp_path_factory):
    g = random_power_law_graph(num_nodes=1200, avg_degree=6, feature_dim=12,
                               num_classes=5, seed=3)
    d = str(tmp_path_factory.mktemp("packed") / "ds")
    save_dataset(g, d)
    return d


def _printed_config(argv, monkeypatch, capsys):
    """The config JSON the port's command line prints for ``argv``,
    stopping before it trains, and what it wrote to stderr."""
    monkeypatch.setattr(cli, "dispatch", lambda *a: None)
    cli.main(argv)
    cap = capsys.readouterr()
    return json.loads(cap.out), cap.err


def _reference_config(argv):
    """The config JSON ``train.py`` prints for ``argv``: its stdout up to
    the JSON's closing brace, then the process is stopped (it prints
    before it trains)."""
    env = dict(os.environ, LEGION_FORCE_CPU_DEVICES="8")
    p = subprocess.Popen([sys.executable, os.path.join(REPO, "train.py")]
                         + argv, stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True, env=env,
                         cwd=REPO)
    lines = []
    try:
        for line in p.stdout:
            lines.append(line)
            if line.rstrip() == "}":
                break
    finally:
        p.kill()
        p.wait()
    return json.loads("".join(lines))


FLAG_SETS = {
    "synthetic": ["--synthetic", "1500", "--arch", "gcn", "--dtype",
                  "bfloat16", "--fanouts", "5,3", "--batch-size", "64",
                  "--epochs", "3", "--lr", "0.01", "--dropout", "0.1",
                  "--hidden-dim", "32", "--seed", "4", "--checkpoint-dir",
                  "ck", "--profile-dir", "prof"],
    "host_topology": ["--synthetic", "1500", "--topology", "host",
                      "--cache-budget-gb", "0.5"],
    "packed_mesh": ["--devices", "4", "--cache-budget-gb", "1",
                    "--features", "hbm_sharded", "--halo-exchange", "psum",
                    "--halo-cap-slack", "1.5", "--topology", "host"],
    "partitioned": ["--synthetic", "1500", "--partitioned", "--devices", "2",
                    "--halo-exchange", "psum", "--halo-cap-slack", "1.1"],
}


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_cli_prints_train_py_config(name, packed_dir, monkeypatch, capsys):
    """The same JSON as ``train.py`` for the same flags, less the
    reference's ``scan_unroll`` (a removed key of the port's config). The
    packed set also takes the registry-free ``--data-dir`` path and the
    auto cache group over 4 ranks (the CPU ranks count as this host's
    devices; ``train.py`` sees 8 virtual ones)."""
    argv = FLAG_SETS[name]
    if name == "packed_mesh":
        argv = argv + ["--data-dir", packed_dir]
    want = _reference_config(argv)
    want["train"].pop("scan_unroll")
    got, _ = _printed_config(argv + ["--device", "cpu"], monkeypatch,
                             capsys)
    assert got == want
    assert got["cache"]["group_size"] == (4 if name == "packed_mesh" else 1)


def test_cli_trains_from_packed_dir(packed_dir, capsys):
    """load -> train -> eval from a packed directory (mmap), on the CPU,
    through the Trainer."""
    cli.main(["--data-dir", packed_dir, "--device", "cpu"] + SMALL)
    out = capsys.readouterr().out
    assert "Val Acc" in out and "Accuracy on test data" in out
    assert json.loads(out[:out.index("\n}\n") + 2])["dataset"]["path"] == \
        packed_dir


def test_cli_trains_gat(capsys):
    """``--arch gat --num-heads 2``: one CPU epoch of GAT through the
    Trainer, three hops from three fanouts, every hop deduplicated."""
    cli.main(["--synthetic", "1500", "--arch", "gat", "--num-heads", "2",
              "--hidden-dim", "8", "--fanouts", "4,3,2", "--batch-size",
              "64", "--epochs", "1", "--lr", "0.001", "--device", "cpu"])
    out = capsys.readouterr().out
    cfg = json.loads(out[:out.index("\n}\n") + 2])
    assert cfg["model"]["arch"] == "gat" and cfg["model"]["num_heads"] == 2
    assert cfg["model"]["num_layers"] == 3
    assert cfg["sampler"]["dedup_last"] is True
    assert "Val Acc" in out and "Accuracy on test data" in out


def test_cli_registry_mismatch_fails_loudly(packed_dir, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--dataset", "PR", "--data-dir", packed_dir, "--device",
                  "cpu"])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "registry expects num_nodes=2449029" in err
    assert "wrong directory or bad conversion" in err


def test_cli_config_plus_flags_warns_by_name(packed_dir, tmp_path,
                                             monkeypatch, capsys):
    from legion_tpu_torch.config import Config, DatasetConfig
    f = tmp_path / "run.json"
    f.write_text(Config(dataset=DatasetConfig(path=packed_dir)).to_json())
    got, err = _printed_config(["--config", str(f), "--epochs", "3", "--lr",
                                "0.1", "--device", "cpu"], monkeypatch,
                               capsys)
    assert got["train"]["epochs"] == 10          # the file's, not the flag's
    assert "these command-line flags are ignored: --lr, --epochs" in err


def test_cli_host_topology_without_a_budget_trains(capsys):
    """The repaired case: ``--topology host`` with no budget warns, as
    ``train.py`` does, and trains through the hybrid driver with both
    caches empty."""
    cli.main(["--synthetic", "1500", "--topology", "host", "--device",
              "cpu"] + SMALL)
    cap = capsys.readouterr()
    assert "zero hot cache, every hop/feature is host-served" in cap.err
    assert "cost model: alpha=0.00 feat_cap=0 topo_cap=0" in cap.out
    assert "feat_hit:0.000, topo_hot:0.000" in cap.out
    assert "Accuracy on test data" in cap.out


def _partitioned_dir(packed_dir, tmp_path):
    """The packed dataset with a 2-way hash partition file beside it."""
    from legion_tpu_torch.data.format import load_dataset
    from legion_tpu_torch.data.partition import partition_graph
    g = load_dataset(packed_dir, mmap=False)
    g.partition = partition_graph(g, 2, mode="hash")
    d = str(tmp_path / "parted")
    save_dataset(g, d)
    return d


def test_cli_partitioned_honors_partition_file(packed_dir, tmp_path):
    """``--partitioned --devices 2`` loads ``partition_2_bn`` from the
    dataset directory (as ``train.py:172-177`` does) and trains on it, two
    gloo ranks to the test line; rank 0 logs."""
    d = _partitioned_dir(packed_dir, tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", "legion_tpu_torch.train", "--device", "cpu",
         "--data-dir", d, "--partitioned", "--devices", "2", "--epochs", "1",
         "--batch-size", "32", "--fanouts", "4,3", "--hidden-dim", "16"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "using precomputed 2-way partition" in r.stdout
    assert r.stdout.count("[2-way partitioned]") == 1
    assert "Accuracy on test data" in r.stdout


@pytest.mark.parametrize("partitioned", [True, False])
def test_cli_reads_the_partition_file_only_for_partitioned(
        packed_dir, tmp_path, partitioned):
    """The dataset each rank loads carries the partition of
    ``--devices`` parts under ``--partitioned`` only, from the flags and
    from ``--config`` alike."""
    from legion_tpu_torch.config import Config, DatasetConfig, ParallelConfig
    d = _partitioned_dir(packed_dir, tmp_path)
    f = tmp_path / "run.json"
    f.write_text(Config(dataset=DatasetConfig(path=d),
                        parallel=ParallelConfig(num_devices=2)).to_json())
    flags = ["--partitioned"] if partitioned else []
    for argv in (["--data-dir", d, "--devices", "2"], ["--config", str(f)]):
        args = cli.build_parser().parse_args(argv + flags + ["--device",
                                                             "cpu"])
        _, data, (load, kw), _ = cli.setup(args, cli.build_parser())
        for g in (data, load(**kw)):
            assert (g.partition is not None) == partitioned


def test_cli_partitioned_halo_flags(capsys):
    """``--halo-exchange`` / ``--halo-cap-slack`` reach the partitioned
    driver (psum: no cap probe; exact, the default: the probe's line with
    the slack), here on one rank in this process; another driver warns
    that it ignores them, in ``train.py``'s words."""
    base = ["--synthetic", "1500", "--device", "cpu", "--partitioned"] + SMALL
    cli.main(base + ["--halo-exchange", "psum"])
    out = capsys.readouterr().out
    assert '"halo_exchange": "psum"' in out
    assert "halo exact exchange" not in out
    assert "Accuracy on test data" in out and "[1-way partitioned]" in out
    cli.main(base + ["--halo-cap-slack", "1.5"])
    out = capsys.readouterr().out
    assert "halo exact exchange: per-distance caps () (frontier cap" in out
    assert "slack 1.5)" in out
    cli.main(["--synthetic", "1500", "--device", "cpu", "--halo-exchange",
              "psum"] + SMALL)
    assert "apply only to --partitioned" in capsys.readouterr().err


@pytest.mark.parametrize("flags,lines", [
    (["--topology", "host", "--cache-budget-gb", "0.0002"],
     ["owner-cap probe (Kg=2)", "(x2 ranks/group)", "topo_hot:"]),
    (["--cache-budget-gb", "0.0002"],
     ["(x2 ranks/group)", "owner cap", "hit:"]),
    (["--features", "hbm_sharded"], ["[mesh {'data': 1, 'cache': 2}]"])],
    ids=["striped_hybrid", "striped_cache", "hbm_sharded"])
def test_cli_runs_each_cache_group_path(flags, lines):
    """``--devices 2 --cache-group 2 --device cpu`` on each path that
    stripes over a cache group: two gloo ranks train to the test line;
    rank 0 logs."""
    r = subprocess.run(
        [sys.executable, "-m", "legion_tpu_torch.train", "--device", "cpu",
         "--devices", "2", "--cache-group", "2", "--synthetic", "1500"]
        + SMALL + flags, capture_output=True, text=True, timeout=300,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    for line in lines:
        assert line in r.stdout, line
    assert r.stdout.count("Epoch:0") == 1
    assert "Accuracy on test data" in r.stdout
    assert "NotImplementedError" not in r.stderr


def test_cli_devices_zero_on_the_cpu_asks_for_a_count():
    with pytest.raises(ValueError, match="give a rank count"):
        cli.main(["--synthetic", "1500", "--device", "cpu", "--devices",
                  "0"] + SMALL)


def test_cli_two_gloo_ranks_train():
    """``--devices 2 --device cpu``: two gloo ranks of MeshTrainer, each
    loading the dataset itself; rank 0 logs the mesh."""
    r = subprocess.run(
        [sys.executable, "-m", "legion_tpu_torch.train", "--device", "cpu",
         "--devices", "2", "--synthetic", "1500"] + SMALL,
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[mesh {'data': 2, 'cache': 1}]" in r.stdout
    assert r.stdout.count("Val Acc") == 1
    assert "Accuracy on test data" in r.stdout
