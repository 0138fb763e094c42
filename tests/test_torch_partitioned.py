"""The edge-partitioned driver (``train/partitioned_driver.py``,
``parallel/multihost.py``, ``parallel/launch.py``) against
``legion_tpu.train.partitioned_driver.run_partitioned_training``.

The reference runs in this process on 2 virtual CPU devices, spied on
for its initial weights; its key schedule gives every
rank's draw grids (train: ``fold_in(fold_in(rng, step), rank)`` split into
the sampling key; eval: ``split(PRNGKey(12345), steps)[t]`` folded with the
rank; each hop one (k * M, fanout) grid), which reach the ranks in a file.
One spawn of 2 single-threaded gloo ranks runs the port's driver from the
same weights and grids (dropout 0) for SAGE, GCN and LP-SAGE: each epoch's
last and mean loss within rtol 1e-4 (float32), validation and test
accuracy equal (LP-SAGE's LP-loss figures within rtol 1e-4). The same spawn runs the psum exchange (bitwise the exact one's
losses), counts the kernel wrappers' calls per step, kills and resumes a
run at an epoch end, and trains on a precomputed partition. Two processes
started with torchrun's variables give the spawned run's figures, and a
world of one rank is bitwise the same run through either exchange. Only
the reference helpers import JAX, inside the functions this process
runs."""

import contextlib
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from legion_tpu_torch import config as port_config
from legion_tpu_torch.data.partition import edge_cut_fraction, partition_graph
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.parallel import mesh
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.seeds import make_seed_plan, shard_node_set

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, EB, FANOUTS, HIDDEN, EPOCHS = 48, 48, (4, 3), 16, 2
ARCHS = ("sage", "gcn", "lp_sage")


def _graph():
    """conftest's ``small_graph``, built here so that the ranks need no
    conftest."""
    return random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=7, seed=1)


def _cfg(cm, world, arch="sage", epochs=EPOCHS, dropout=0.0, ck=None,
         halo="exact"):
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=7),
        sampler=cm.SamplerConfig(fanouts=FANOUTS, batch_size=B,
                                 eval_batch_size=EB),
        model=cm.ModelConfig(arch=arch, hidden_dim=HIDDEN, num_layers=2,
                             dropout=dropout),
        train=cm.TrainConfig(learning_rate=0.01, seed=0, epochs=epochs,
                             checkpoint_dir=ck),
        parallel=cm.ParallelConfig(num_devices=world, halo_exchange=halo))


def _epochs(arch):
    return EPOCHS if arch == "sage" else 1


# -- the ranks ----------------------------------------------------------------

@contextlib.contextmanager
def _keyed(d, arch, world, epochs, counts=None):
    """The driver with the reference's weights of ``arch`` and every
    grid of its key schedule; ``counts`` (a dict) gets the calls of the
    sampling kernel, K3 and K2's forward in each epoch and evaluation."""
    from legion_tpu_torch.models import sage
    from legion_tpu_torch.parallel import halo, multihost
    from legion_tpu_torch.train import partitioned_driver as pd
    rank = dist.get_rank()
    ref = np.load(os.path.join(d, f"grids{world}.npz"))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    saved = (pd.build_model, multihost.PartitionedTrainer.run_epoch,
             multihost.PartitionedTrainer.eval_counts, halo.sample_neighbors,
             halo.gather_rows, sage.gathered_masked_mean)
    build, run_epoch, eval_counts = saved[:3]
    calls = {"sample": 0, "gather": 0, "k2": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    def build_from_ref(*a, **k):
        m = build(*a, **k)
        m.load_state_dict(torch.load(os.path.join(d, f"init_{arch}.pt")))
        return m

    def snap(key):
        if counts is not None:
            counts[key] = dict(calls)
        calls.update(sample=0, gather=0, k2=0)

    def run_keyed(self, state, s, lab, uniforms=None):
        snap("before")
        rec = run_epoch(self, state, s, lab, uniforms=lambda st, h: t(
            ref[f"t{rank}_{st}_{h}"]))
        snap(f"train{state.epoch}")
        return rec

    evals = [0]

    def eval_keyed(self, model, s, c, lab, generator, uniforms=None):
        name = "v" if evals[0] < epochs else "s"
        evals[0] += 1
        snap("before")
        out = eval_counts(self, model, s, c, lab, generator,
                          uniforms=lambda i, h: t(ref[f"{name}{rank}_{i}_{h}"]))
        snap(f"eval{evals[0] - 1}")
        return out

    pd.build_model = build_from_ref
    multihost.PartitionedTrainer.run_epoch = run_keyed
    multihost.PartitionedTrainer.eval_counts = eval_keyed
    halo.sample_neighbors = counted("sample", halo.sample_neighbors)
    halo.gather_rows = counted("gather", halo.gather_rows)
    sage.gathered_masked_mean = counted("k2", sage.gathered_masked_mean)
    try:
        yield
    finally:
        (pd.build_model, multihost.PartitionedTrainer.run_epoch,
         multihost.PartitionedTrainer.eval_counts, halo.sample_neighbors,
         halo.gather_rows, sage.gathered_masked_mean) = saved


def _summary(res):
    return {"history": [{k: h[k] for k in ("losses", "loss", "mean_loss",
                                          "valid", "halo_overflow",
                                          "cap_overflow", "edges", "steps")}
                        for h in res["history"]],
            "test_acc": res["test_acc"], "dist_caps": res["dist_caps"],
            "edge_cut": res["edge_cut"], "mesh": res["mesh"],
            "params": {k: v.detach().clone() for k, v in
                       res["state"].model.state_dict().items()}}


def _driver_rank(device, d):
    """Every run of the two ranks, written to rank<r>.pt."""
    from legion_tpu_torch.train.partitioned_driver import (
        run_partitioned_training)
    rank = dist.get_rank()
    g = _graph()
    quiet = lambda s: None  # noqa: E731
    out = {"counts": {}}
    for arch in ARCHS:
        ep = _epochs(arch)
        with _keyed(d, arch, 2, ep, out["counts"] if arch == "sage" else None):
            out[arch] = _summary(run_partitioned_training(
                _cfg(port_config, 2, arch, ep), g, device, log=quiet))
    with _keyed(d, "sage", 2, EPOCHS):
        out["psum"] = _summary(run_partitioned_training(
            _cfg(port_config, 2, halo="psum"), g, device, log=quiet))

    ck = os.path.join(d, "ck")
    kw = dict(dropout=0.3)
    whole = run_partitioned_training(_cfg(port_config, 2, **kw), g, device,
                                     log=quiet)
    first = run_partitioned_training(_cfg(port_config, 2, epochs=1, ck=ck,
                                          **kw), g, device, log=quiet)
    logs = []
    rest = run_partitioned_training(_cfg(port_config, 2, ck=ck, **kw), g,
                                    device, log=logs.append)
    out["resume"] = {"whole": _summary(whole), "first": _summary(first),
                     "rest": _summary(rest), "logs": logs}

    part = partition_graph(g, 2, mode="hash")
    logs = []
    res = run_partitioned_training(
        _cfg(port_config, 2, epochs=1), dataclasses.replace(g, partition=part),
        device, log=logs.append)
    out["precomputed"] = {"logs": logs, "summary": _summary(res)}
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


# -- the reference ------------------------------------------------------------

def _grids(d, world):
    """Every rank's grids of the reference's key schedule: train steps of
    two epochs, and the valid and test evaluations."""
    import jax

    from tests.test_torch_sampler import jax_uniforms
    g = _graph()
    part = partition_graph(g, world, mode="greedy")
    shards = shard_node_set(np.asarray(g.train_ids), world, part)
    plan = make_seed_plan([len(s) for s in shards], [1] * world,
                          [1] * world, B, EB)
    caps = [world * c for c in frontier_caps(B, FANOUTS)]
    ecaps = [world * c for c in frontier_caps(EB, FANOUTS)]
    u = {}
    for s in range(EPOCHS * plan.train_steps):
        base = jax.random.fold_in(jax.random.PRNGKey(0), s)
        for r in range(world):
            skey, _ = jax.random.split(jax.random.fold_in(base, r))
            for h, a in enumerate(jax_uniforms(skey, caps, FANOUTS)):
                u[f"t{r}_{s}_{h}"] = a
    for name, ids in (("v", g.valid_ids), ("s", g.test_ids)):
        eshards = shard_node_set(np.asarray(ids), world, part)
        steps = (max(len(x) for x in eshards) - 1) // EB + 1
        keys = jax.random.split(jax.random.PRNGKey(12345), steps)
        for t in range(steps):
            for r in range(world):
                for h, a in enumerate(jax_uniforms(
                        jax.random.fold_in(keys[t], r), ecaps, FANOUTS)):
                    u[f"{name}{r}_{t}_{h}"] = a
    np.savez(os.path.join(d, f"grids{world}.npz"), **u)


def _reference(d, arch, world=2):
    """The reference driver on ``world`` virtual devices, spied on for its
    initial weights (written to ``d``); its history, test figure and edge
    cut."""
    import jax
    from jax.sharding import Mesh

    from legion_tpu import config as jax_config
    from legion_tpu.train import partitioned_driver as jpd
    from legion_tpu_torch.models.convert import params_from_flax
    seen = {}
    state0 = jpd.create_train_state

    def spy_state(params, *a, **k):
        seen["params"] = jax.tree_util.tree_map(np.array, params)
        return state0(params, *a, **k)
    jpd.create_train_state = spy_state
    try:
        res = jpd.run_partitioned_training(
            _cfg(jax_config, world, arch, _epochs(arch)), _graph(),
            mesh=Mesh(np.array(jax.devices()[:world]), ("data",)),
            log=lambda s: None)
    finally:
        jpd.create_train_state = state0
    torch.save(params_from_flax(seen["params"]),
               os.path.join(d, f"init_{arch}.pt"))
    return {"history": [{k: float(h[k]) for k in ("loss", "mean_loss",
                                                  "valid", "halo_overflow")}
                        for h in res["history"]],
            "test_acc": float(res["test_acc"]), "edge_cut": res["edge_cut"]}


@pytest.fixture(scope="module")
def run2():
    with tempfile.TemporaryDirectory() as d:
        refs = {arch: _reference(d, arch) for arch in ARCHS}
        _grids(d, 2)
        mesh.spawn(_driver_rank, 2, "cpu", args=(d,), threads=1)
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    return refs, ranks


# -- the checks ---------------------------------------------------------------

def _same_run(got, want, arch, rtol=1e-4):
    """Losses within ``rtol``; accuracies equal, and LP-SAGE's eval
    figures (LP losses) within ``rtol``."""
    same = (np.testing.assert_allclose if arch == "lp_sage"
            else np.testing.assert_equal)
    kw = {"rtol": rtol} if arch == "lp_sage" else {}
    assert len(got["history"]) == len(want["history"])
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=rtol)
        np.testing.assert_allclose(a["mean_loss"], b["mean_loss"], rtol=rtol)
        same(a["valid"], b["valid"], **kw)
        assert a["halo_overflow"] == b["halo_overflow"] == 0
    same(got["test_acc"], want["test_acc"], **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_matches_the_reference_at_two_ranks(run2, arch):
    """From the reference's weights and grids: each epoch's last and mean
    loss within rtol 1e-4, the same validation and test accuracy (LP-SAGE:
    eval LP loss within rtol 1e-4), no halo overflow, the same edge cut,
    and bitwise the same parameters on both ranks."""
    refs, ranks = run2
    for got in ranks:
        _same_run(got[arch], refs[arch], arch)
        assert got[arch]["edge_cut"] == refs[arch]["edge_cut"]
        assert got[arch]["mesh"] == {"data": 2}
        assert all(h["cap_overflow"] == 0 for h in got[arch]["history"])
    a, b = ranks[0][arch], ranks[1][arch]
    assert a["history"] == b["history"] and a["test_acc"] == b["test_acc"]
    assert all(torch.equal(v, b["params"][k]) for k, v in a["params"].items())


def test_psum_exchange_trains_bitwise_as_the_exact_one(run2):
    """The same draws and rows through the cap-free oracle: the same
    losses, figures and parameters, bit for bit."""
    _, ranks = run2
    for got in ranks:
        ex, ps = got["sage"], got["psum"]
        assert ps["dist_caps"] is None and ex["dist_caps"]
        assert ps["history"] == ex["history"]
        assert ps["test_acc"] == ex["test_acc"]
        assert all(torch.equal(v, ps["params"][k])
                   for k, v in ex["params"].items())


def test_kernel_calls_per_step(run2):
    """Per train and eval step at two ranks through the exact exchange:
    the sampling kernel twice a hop (the self-served draws and one
    round's), K3 three times (the self-served rows, the round's served
    rows, the reassembly), K2's forward once a layer (both narrow here:
    32 -> 16 -> 7). ``chip_smoke.py`` holds the card's launches to the
    same counts."""
    _, ranks = run2
    c = ranks[0]["counts"]
    steps = ranks[0]["sage"]["history"][0]["steps"]
    want_train = {"sample": 2 * 2 * steps, "gather": 3 * steps,
                  "k2": 2 * steps}
    assert c["train0"] == c["train1"] == want_train
    for key in ("eval0", "eval1", "eval2"):
        n = c[key]["gather"] // 3
        assert n > 0 and c[key] == {"sample": 4 * n, "gather": 3 * n,
                                    "k2": 2 * n}


def test_kill_and_resume_at_two_ranks(run2):
    """A run checkpointed after epoch 0 and resumed by a fresh driver on
    every rank gives exactly the uninterrupted run's epoch 1, validation
    and test (dropout 0.3: every rank's generator comes back)."""
    _, ranks = run2
    for got in ranks:
        r = got["resume"]
        assert r["first"]["history"] == r["whole"]["history"][:1]
        assert r["rest"]["history"] == r["whole"]["history"][1:]
        assert r["rest"]["test_acc"] == r["whole"]["test_acc"]
    assert any("resumed from checkpoint at step" in s
               for s in ranks[0]["resume"]["logs"])


def test_precomputed_partition_is_used(run2, small_graph):
    _, ranks = run2
    logs = ranks[0]["precomputed"]["logs"]
    assert "using precomputed 2-way partition from dataset" in logs
    part = partition_graph(small_graph, 2, mode="hash")
    for got in ranks:
        s = got["precomputed"]["summary"]
        assert s["edge_cut"] == edge_cut_fraction(small_graph, part)
        assert np.isfinite(s["history"][0]["loss"])


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


CLI = ["--device", "cpu", "--partitioned", "--synthetic", "2000",
       "--batch-size", "64", "--fanouts", "4,3", "--hidden-dim", "16",
       "--epochs", "2", "--devices", "2"]


def _figures(stdout):
    return (re.findall(r"Loss:([0-9.]+), Val Acc: ([0-9.]+)", stdout),
            re.findall(r"Accuracy on test data: ([0-9.]+)", stdout))


def test_torchrun_variables_launch_equals_the_spawn():
    """Two processes given torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
    MASTER_ADDR / MASTER_PORT join one group (env://) and print the same
    epochs and test line as ``--devices 2`` spawning its ranks."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "legion_tpu_torch.train"] + CLI,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    spawned = subprocess.run(
        [sys.executable, "-m", "legion_tpu_torch.train"] + CLI,
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert spawned.returncode == 0, spawned.stderr[-2000:]
    want = _figures(spawned.stdout)
    assert len(want[0]) == 2 and len(want[1]) == 1
    assert _figures(outs[0][0]) == want
    assert "[2-way partitioned]" in outs[0][0]
    assert "Epoch" not in outs[1][0]            # rank 0 logs


def test_world_size_one(small_graph, tmp_path):
    """One gloo rank in this process, through the exact and the psum
    exchange: bitwise the same run (no request leaves the rank), empty
    per-distance caps, finite falling losses and a figure above chance."""
    from legion_tpu_torch.train.partitioned_driver import (
        run_partitioned_training)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        ex = run_partitioned_training(_cfg(port_config, 1), small_graph,
                                      "cpu", log=lambda s: None)
        ps = run_partitioned_training(_cfg(port_config, 1, halo="psum"),
                                      small_graph, "cpu", log=lambda s: None)
    finally:
        dist.destroy_process_group()
    assert ex["dist_caps"] == () and ex["edge_cut"] == 0.0
    assert _summary(ex)["history"] == _summary(ps)["history"]
    h = ex["history"]
    assert all(np.isfinite(r["losses"]).all() for r in h)
    assert h[1]["mean_loss"] < h[0]["mean_loss"]
    assert ex["test_acc"] == ps["test_acc"] > 1.5 / 7


def test_driver_refuses_a_device_count_it_does_not_have(small_graph,
                                                        tmp_path):
    from legion_tpu_torch.train.partitioned_driver import (
        run_partitioned_training)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="num_devices=3"):
            run_partitioned_training(_cfg(port_config, 3), small_graph,
                                     "cpu", log=lambda s: None)
    finally:
        dist.destroy_process_group()


def test_partition_cell_rehearses_on_the_cpu(tmp_path):
    """``tools/partition_cell.py --device cpu --small``, the card's
    ``mesh_partitioned_k2`` phase at a small size: at 2 ranks and at 1,
    every rank's batch bitwise the same through both exchanges, the
    exact exchange's bytes the closed forms' (none at 1 rank), no halo
    overflow, and the figures of every rank equal."""
    from legion_tpu_torch.tools import partition_cell
    out = str(tmp_path / "cell.json")
    partition_cell.main([out, "--device", "cpu", "--small"])
    with open(out) as f:
        runs = json.load(f)
    assert sorted(runs) == ["world1", "world2"]
    for world, run in ((2, runs["world2"]), (1, runs["world1"])):
        assert run["world"] == world and len(run["ranks"]) == world
        assert run["edge_cut"]["greedy"] <= run["edge_cut"]["hash"]
        for r in run["ranks"]:
            ob = r["one_batch"]
            assert ob["draws_equal"] and ob["x_equal"]
            assert ob["exact_bytes"] == ob["closed_form_bytes"]
            assert bool(ob["exact_bytes"]) == (world > 1)
            assert ob["overflow"] == r["extra_epoch_halo_overflow"] == 0
            assert r["extra_eval_halo_overflow"] == 0
            assert all(h["halo_overflow"] == 0 for h in r["history"])
            assert len(r["dist_caps"]) == world - 1
            r0 = run["ranks"][0]
            assert ([(h["losses"], h["valid"]) for h in r["history"]]
                    == [(h["losses"], h["valid"]) for h in r0["history"]])
