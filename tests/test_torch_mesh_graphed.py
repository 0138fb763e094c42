"""Captured mesh steps: ``MeshTrainer`` (``parallel/dp.py::make_dp_epoch_fns``)
and the edge-partitioned path (``parallel/multihost.py::
make_partitioned_epoch_fns``) run every epoch and eval pass through the
scans of ``train/graphed.py``, whose steps a NCCL group captures as CUDA
graphs with their collectives inside.

One spawn of two single-threaded gloo ranks (a module fixture) runs each
path: ``MeshTrainer`` with ``feature_placement`` "hbm" and "hbm_sharded"
(the table striped over a cache group of both ranks) and the partitioned
driver with the exact and the psum exchange, each through the
static-buffer scans eagerly (what gloo runs) and through the stand-in
capture of ``tests/test_torch_graphed.py`` (``faked_capture``: the
warm-up runs the first step, the "capture" runs the step's Python while
no tensor that outlives it changes and no collective runs, and a
"replay" runs the step again without counting launches or collectives).
Checked:

* from ``legion_tpu``'s weights and draws, the epoch and the eval pass
  against the reference's ``make_dp_epoch_fns`` (its ``MeshTrainer``'s
  ``jit_epoch`` / ``jit_eval_scan``) and ``make_partitioned_epoch_fns``
  (its partitioned driver) runs, within the limits of
  ``tests/test_torch_dp.py`` (losses rtol 1e-4 / atol 1e-5, parameters
  1e-4 absolute, eval counts equal) and ``tests/test_torch_partitioned.py``
  (losses rtol 1e-4, accuracies equal, no halo overflow); captured and
  eager bitwise equal;
* with the generators' own draws and dropout 0.3, steps of the scan (the
  warm-up, then replays) bitwise what the parent's eager loop of
  ``train_step`` gives from the same state: losses, edges, frontier, cap
  and halo overflow, and the state after them;
* the collectives counted after the replays equal the closed forms: one
  all-reduce of the parameter bytes a step and one of the figures an
  epoch, two all-to-alls of ``exact_exchange_bytes`` a step on
  "hbm_sharded", the halo exchange's ring shifts
  (``halo_exact_{hop,fetch}_bytes``) or its all-gathers and
  reduce-scatters (``psum_exchange_bytes``) a step;
* the gloo collectives that ran: as many captured as eager, so the
  stand-in capture ran none and left nothing behind;
* no host sync in a train and an eval step of each (``_NoHostSync``);
* in the share-device mode (collectives staged through host memory) a
  collective called while a stream captures raises.

The ``cuda`` legs init a one-rank NCCL group on the card and hold the
captured steps against the same steps run eagerly from the same state
(``pytest --noconftest -m cuda tests/test_torch_mesh_graphed.py``).
Only the reference helpers import JAX, inside the functions the parent
runs."""

import contextlib
import dataclasses
import os
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from legion_tpu_torch import config as port_config
from legion_tpu_torch.ops import gather, identity_agg, sample, spmm
from legion_tpu_torch.parallel import mesh, multihost
from legion_tpu_torch.parallel import trainer as mesh_trainer
from legion_tpu_torch.parallel.trainer import MeshTrainer
from legion_tpu_torch.sampling.seeds import shard_node_set
from legion_tpu_torch.train import graphed
from legion_tpu_torch.train import partitioned_driver as pd
from legion_tpu_torch.train.train_state import (load_optimizer_in_place,
                                                state_tensors)
from legion_tpu_torch.utils import comm
from tests import test_torch_dp as dp_t
from tests import test_torch_partitioned as part_t
from tests.test_torch_graphed import _NoHostSync, _exempt, faked_capture

torch.set_num_threads(2)

WORLD = 2
DP = ("hbm", "hbm_sharded")
HALO = ("exact", "psum")
VARIANTS = DP + HALO
COLLECTIVES = ("all_reduce", "all_to_all_single", "all_gather",
               "reduce_scatter", "batch_isend_irecv")
ROWS = 4                      # the warm-up, then three replays


# -- shared by the ranks and the card legs -----------------------------------

@contextlib.contextmanager
def _executed():
    """Counts of the ``torch.distributed`` calls that ran, by name."""
    ran = dict.fromkeys(COLLECTIVES, 0)

    def counted(name, fn):
        def call(*args, **kwargs):
            ran[name] += 1
            return fn(*args, **kwargs)
        return call

    with mock.patch.multiple(dist, **{n: counted(n, getattr(dist, n))
                                      for n in COLLECTIVES}):
        yield ran


@contextlib.contextmanager
def _mode(captured):
    """``captured``: the stand-in capture, with both mesh paths told that
    their group captures (``captures_steps``); else the eager scans gloo
    gives them. Yields the list of captures (None when eager)."""
    if not captured:
        yield None
        return
    with faked_capture() as captures, \
            mock.patch.object(mesh_trainer, "captures_steps",
                              lambda device: True), \
            mock.patch.object(pd, "captures_steps", lambda device: True):
        yield captures


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            _clone(state.optimizer.state_dict()),
            state.generator.get_state(), state.step)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone(v) for v in x]
    return x


def _load(state, snap):
    """``snap`` loaded into the state's own tensors (a graph captured on
    them stays valid)."""
    state.model.load_state_dict(snap[0])
    load_optimizer_in_place(state.optimizer, _clone(snap[1]))
    state.generator.set_state(snap[2])
    state.step = snap[3]


def _eager_loop(fns, state, graph, feats, seeds, labels):
    """The parent's eager loop: ``fns.train_step`` a row, its metrics as
    the scan's (steps, len(METRICS)) float64 rows."""
    nb = torch.tensor(seeds.shape[1], dtype=torch.int32, device=feats.device)
    return torch.stack([torch.stack([m[k].to(torch.float64)
                                     for k in graphed.METRICS])
                        for m in (fns.train_step(state, graph, feats,
                                                 seeds[i], nb, labels[i])
                                  for i in range(seeds.shape[0]))])


def _parent_run_epoch(tr, state, seeds, labels):
    """The parent's ``PartitionedTrainer.run_epoch``: a Python loop of the
    eager train step, its record."""
    shard = tr.path.shard
    dev = shard.owned_ids.device
    tr.path.overflow.zero_()
    m = _eager_loop(tr.fns, state, shard, shard.feat_rows,
                    torch.from_numpy(seeds).to(dev),
                    torch.from_numpy(labels).to(dev))[:, [0, 1, 3]]
    packed = comm.all_reduce(torch.cat([
        m.reshape(-1), tr.path.overflow.to(torch.float64)[None]])).cpu()
    m = packed[:-1].reshape(-1, 3)
    return {"losses": (m[:, 0] / tr.path.k).to(torch.float32).tolist(),
            "steps": m.shape[0], "edges": int(m[:, 1].to(torch.int64).sum()),
            "cap_overflow": int(m[:, 2].sum()),
            "halo_overflow": int(packed[-1])}


def _dp_cfg(placement, world, **kw):
    cfg = dp_t._cfg(port_config, world, feature_placement=placement, **kw)
    if placement == "hbm_sharded":
        cfg = dataclasses.replace(
            cfg, cache=port_config.CacheConfig(group_size=world))
    return cfg


def _shard_rows(ids, rows, batch, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(ids)[:batch]
                     for _ in range(rows)]).astype(np.int32)


# -- the ranks ----------------------------------------------------------------

def _dp_parity(device, d, placement, captured):
    rank = dist.get_rank()
    g = dp_t._graph()
    u = np.load(os.path.join(d, "uniforms.npz"))

    def train_u(s, k):
        return torch.from_numpy(u[f"t{rank}_{s}_{k}"])

    def eval_u(t, k):
        return torch.from_numpy(u[f"e{rank}_{t}_{k}"])

    with _executed() as ran, _mode(captured) as captures:
        tr = MeshTrainer(_dp_cfg(placement, WORLD), g, device)
        tr.model.load_state_dict(torch.load(os.path.join(d, "init.pt")))
        comm.reset_counts()
        rec = tr.train_one_epoch(0, uniforms=train_u)
        counts, calls, executed = (comm.read_counts(), comm.read_calls(),
                                   dict(ran))
        ev = tr.eval_counts("valid", uniforms=eval_u)
    return {"losses": rec["losses"], "steps": rec["steps"], "eval": ev,
            "params": {k: v.clone() for k, v in tr.model.state_dict().items()},
            "counts": counts, "calls": calls, "executed": executed,
            "captures": None if captures is None else len(captures),
            "param_bytes": comm.param_bytes(tr.model), "caps": tr.caps,
            "width": tr.features.shape[1], "mesh": tr.mesh.shape}


def _dp_generator(device, placement, captured):
    """ROWS steps of the scan against the eager loop of a twin from the
    same weights, both with their generators' own draws."""
    rank = dist.get_rank()
    g = dp_t._graph()
    cfg = _dp_cfg(placement, WORLD, dropout=0.3)
    twin = MeshTrainer(cfg, g, device)
    seeds = _shard_rows(twin.shards_train[rank], ROWS, dp_t.B, seed=3)
    labels = torch.from_numpy(np.asarray(g.labels, np.int32)[seeds])
    with _mode(captured) as captures:
        tr = MeshTrainer(cfg, g, device)
        got = tr._train_steps(seeds, None)
    want = _eager_loop(twin.fns, twin.state, twin.graph, twin.features,
                       torch.from_numpy(seeds), labels)
    return {"equal": torch.equal(got, want),
            "state_equal": all(torch.equal(a, b) for a, b in zip(
                state_tensors(tr.state), state_tensors(twin.state))),
            "steps": (tr.state.step, twin.state.step),
            "captured": bool(tr.fns.epoch_scan.runs[False].step.graph),
            "captures": None if captures is None else len(captures)}


@contextlib.contextmanager
def _per_epoch(ran, out):
    """Around every ``PartitionedTrainer.run_epoch``: the collectives it
    counted and the ones that ran, appended to ``out``."""
    run_epoch = multihost.PartitionedTrainer.run_epoch

    def counted(self, *args, **kwargs):
        comm.reset_counts()
        before = dict(ran)
        rec = run_epoch(self, *args, **kwargs)
        out.append({"counts": comm.read_counts(), "calls": comm.read_calls(),
                    "executed": {k: ran[k] - before[k] for k in ran},
                    "steps": rec["steps"]})
        return rec

    with mock.patch.object(multihost.PartitionedTrainer, "run_epoch",
                           counted):
        yield


def _part_parity(device, d, halo, captured):
    g = part_t._graph()
    epochs = []
    with _executed() as ran, _mode(captured) as captures, \
            part_t._keyed(d, "sage", WORLD, part_t.EPOCHS), \
            _per_epoch(ran, epochs):
        res = pd.run_partitioned_training(
            part_t._cfg(port_config, WORLD, halo=halo), g, device,
            log=lambda s: None)
    return {**part_t._summary(res), "epochs": epochs,
            "captures": None if captures is None else len(captures),
            "param_bytes": comm.param_bytes(res["state"].model),
            "caps": res["caps"], "width": g.feature_dim,
            "pool": res["trainer"].fns.epoch_scan.pool is not None}


def _part_generator(device, halo, captured):
    """After a one-epoch run with dropout 0.3, ROWS more steps through
    ``run_epoch`` against the parent's loop from the same state."""
    rank = dist.get_rank()
    g = part_t._graph()
    cfg = part_t._cfg(port_config, WORLD, epochs=1, dropout=0.3, halo=halo)
    with _mode(captured) as captures:
        res = pd.run_partitioned_training(cfg, g, device, log=lambda s: None)
        tr, state = res["trainer"], res["state"]
        shards = shard_node_set(np.asarray(g.train_ids), WORLD,
                                res["partition"])
        seeds = _shard_rows(shards[rank], ROWS, part_t.B, seed=4)
        labels = np.asarray(g.labels, np.int32)[seeds]
        start = _snapshot(state)
        got = tr.run_epoch(state, seeds, labels)
        after = [t.clone() for t in state_tensors(state)]
        _load(state, start)
        want = _parent_run_epoch(tr, state, seeds, labels)
    return {"got": got, "want": want,
            "state_equal": all(torch.equal(a, b) for a, b in zip(
                after, state_tensors(state))),
            "captured": bool(tr.fns.epoch_scan.runs[False].step.graph),
            "captures": None if captures is None else len(captures)}


def _no_host_sync(device, variant):
    """One train and one eval step of the variant's eager scans under
    ``_NoHostSync``; exempt, as in ``tests/test_torch_graphed.py``: the
    kernel wrappers' plain versions and Adam's step."""
    rank = dist.get_rank()
    mp = pytest.MonkeyPatch()
    mode = _NoHostSync()
    try:
        for module, name in ((identity_agg, "identity_masked_mean_plain"),
                             (identity_agg, "gathered_masked_mean_plain"),
                             (identity_agg,
                              "gathered_masked_mean_backward_plain"),
                             (gather, "gather_rows_plain"),
                             (sample, "sample_neighbors_plain"),
                             (spmm, "grouped_masked_sum_plain")):
            _exempt(mp, mode, module, name)
        if variant in DP:
            g = dp_t._graph()
            tr = MeshTrainer(_dp_cfg(variant, WORLD, dropout=0.3), g, device)
            _exempt(mp, mode, tr.state.optimizer, "step")
            seeds = _shard_rows(tr.shards_train[rank], 1, dp_t.B, seed=5)
            vs, vc = (x[rank][:1] for x in tr._eval_seeds("valid"))
            with mode:
                tr._train_steps(seeds, None)
                tr._eval_counts(vs, vc, 12345, None)
        else:
            g = part_t._graph()
            res = pd.run_partitioned_training(
                part_t._cfg(port_config, WORLD, epochs=1, dropout=0.3,
                            halo=variant), g, device, log=lambda s: None)
            tr, state = res["trainer"], res["state"]
            _exempt(mp, mode, state.optimizer, "step")
            shard = tr.path.shard
            ids = np.asarray(g.valid_ids)[
                res["partition"][g.valid_ids] == rank][:part_t.EB]
            seeds = torch.from_numpy(ids[None].astype(np.int32))
            labels = torch.from_numpy(
                np.asarray(g.labels, np.int32)[ids][None])
            counts = torch.tensor([len(ids)], dtype=torch.int32)
            gen = torch.Generator().manual_seed(12345)
            with mode:
                tr.fns.epoch_scan(state, shard, shard.feat_rows,
                                  seeds[:, :part_t.B], labels[:, :part_t.B])
                tr.fns_eval.eval_scan(state.model, shard, shard.feat_rows,
                                      seeds, counts, labels, gen)
    finally:
        mp.undo()
    return {"ops": mode.ops, "found": mode.found}


def _rank_checks(device, d):
    out = {}
    for captured in (False, True):
        for placement in DP:
            out[("parity", placement, captured)] = _dp_parity(
                device, d, placement, captured)
            out[("generator", placement, captured)] = _dp_generator(
                device, placement, captured)
        for halo in HALO:
            out[("parity", halo, captured)] = _part_parity(device, d, halo,
                                                           captured)
            out[("generator", halo, captured)] = _part_generator(
                device, halo, captured)
    for variant in VARIANTS:
        out[("sync", variant)] = _no_host_sync(device, variant)
    torch.save(out, os.path.join(d, f"rank{dist.get_rank()}.pt"))


# -- the run ------------------------------------------------------------------

@pytest.fixture(scope="module")
def run():
    with tempfile.TemporaryDirectory() as d:
        dp_ref = dp_t._reference(WORLD, d)
        part_ref = part_t._reference(d, "sage")
        part_t._grids(d, WORLD)
        mesh.spawn(_rank_checks, WORLD, "cpu", args=(d,), threads=1)
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
    return {"dp": dp_ref, "partitioned": part_ref}, ranks


CAPTURED = pytest.mark.parametrize("captured", [False, True],
                                   ids=["eager", "captured"])


@CAPTURED
@pytest.mark.parametrize("placement", DP)
def test_dp_epoch_matches_make_dp_epoch_fns(run, placement, captured):
    """From the reference's weights and uniforms, ``MeshTrainer``'s epoch
    and validation pass against ``legion_tpu``'s ``jit_epoch`` /
    ``jit_eval_scan`` (``make_dp_epoch_fns``): per-step losses within rtol
    1e-4 / atol 1e-5, parameters within 1e-4, eval counts equal; both
    ranks bitwise equal; the captured run bitwise the eager one, with one
    train and one eval capture."""
    refs, ranks = run
    ref = refs["dp"]
    for r in ranks:
        got = r[("parity", placement, captured)]
        eager = r[("parity", placement, False)]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4,
                                   atol=1e-5)
        for k, want in ref["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), want.numpy(),
                                       rtol=0, atol=1e-4, err_msg=k)
        assert got["eval"] == ref["eval"]
        assert got["losses"] == eager["losses"] == \
            ranks[0][("parity", placement, captured)]["losses"]
        assert all(torch.equal(v, eager["params"][k])
                   for k, v in got["params"].items())
        assert got["captures"] == (2 if captured else None)
        assert got["mesh"] == ({"data": 2, "cache": 1} if placement == "hbm"
                               else {"data": 1, "cache": 2})


@CAPTURED
@pytest.mark.parametrize("halo", HALO)
def test_partitioned_run_matches_make_partitioned_epoch_fns(run, halo,
                                                            captured):
    """From the reference's weights and grids, the partitioned driver's
    two epochs, validation and test against ``legion_tpu``'s driver (its
    ``make_partitioned_epoch_fns``): losses within rtol 1e-4, accuracies
    equal, no halo overflow; the captured run bitwise the eager one, and
    the psum exchange bitwise the exact one."""
    refs, ranks = run
    for r in ranks:
        got = r[("parity", halo, captured)]
        part_t._same_run(got, refs["partitioned"], "sage")
        for other in (r[("parity", halo, False)], r[("parity", "exact",
                                                          captured)]):
            assert got["history"] == other["history"]
            assert got["test_acc"] == other["test_acc"]
            assert all(torch.equal(v, other["params"][k])
                       for k, v in got["params"].items())
        assert got["pool"] == captured
        # a train and an eval capture, and one more when the test pass
        # has more steps than the valid pass's graph serves
        assert got["captures"] in ((2, 3) if captured else (None,))


@CAPTURED
@pytest.mark.parametrize("variant", VARIANTS)
def test_replays_are_the_parents_eager_loop(run, variant, captured):
    """With the generators' own draws and dropout 0.3, steps of the scan
    (captured: the warm-up, then replays) give bitwise the metrics rows
    (loss, edges, frontier, cap overflow; partitioned: the epoch record
    with its halo overflow) and the state that the parent's eager loop of
    ``train_step`` gives from the same state."""
    _, ranks = run
    for r in ranks:
        got = r[("generator", variant, captured)]
        if variant in DP:
            assert got["equal"]
            assert got["steps"] == (ROWS, ROWS)
        else:
            assert got["got"] == got["want"]
            assert got["got"]["steps"] == ROWS
        assert got["state_equal"]
        assert got["captured"] == captured


def _closed_forms(r, variant):
    """(calls, bytes) of one epoch of ``r``'s run by op kind, from the
    closed forms, and the ``torch.distributed`` calls that run them."""
    steps, pb = r["steps"], r["param_bytes"]
    calls = {"all_reduce": steps + 1}
    if variant in DP:
        # the gradients a step, and the epoch's (steps, 5) float64 metrics
        nbytes = {"all_reduce": steps * pb
                  + steps * len(graphed.METRICS) * 8}
        ran = {"all_reduce": steps + 1}
        if variant == "hbm_sharded":
            calls["all_to_all"] = ran["all_to_all_single"] = 2 * steps
            nbytes["all_to_all"] = steps * comm.exact_exchange_bytes(
                r["caps"][-1], WORLD, r["width"])["all_to_all"]
        return calls, nbytes, ran
    nbytes = {"all_reduce": steps * pb + (3 * steps + 1) * 8}
    ran = {"all_reduce": steps + 1}
    caps, fanouts = r["caps"], part_t.FANOUTS
    if variant == "exact":
        per = comm.halo_exact_fetch_bytes(r["dist_caps"], r["width"])
        for f in fanouts:
            per = {k: v + per[k] for k, v in comm.halo_exact_hop_bytes(
                r["dist_caps"], f).items()}
        rounds = 2 * (WORLD - 1) * (len(fanouts) + 1)
        calls["collective-permute"] = ran["batch_isend_irecv"] = \
            rounds * steps
    else:
        per = comm.psum_exchange_bytes(caps[-1], WORLD, r["width"])
        for c, f in zip(caps, fanouts):
            per = {k: v + per[k] for k, v in comm.psum_exchange_bytes(
                c, WORLD, f).items()}
        calls["all_gather"] = calls["reduce_scatter"] = \
            ran["all_gather"] = ran["reduce_scatter"] = 3 * steps
    nbytes.update({k: steps * v for k, v in per.items()})
    return calls, nbytes, ran


def _epoch_runs(r, variant, captured):
    got = r[("parity", variant, captured)]
    if variant in DP:
        return [got]
    return [{**e, "param_bytes": got["param_bytes"], "caps": got["caps"],
             "width": got["width"], "dist_caps": got["dist_caps"]}
            for e in got["epochs"]]


@CAPTURED
@pytest.mark.parametrize("variant", VARIANTS)
def test_collectives_after_replays_are_the_closed_forms(run, variant,
                                                        captured):
    """The counting wrapper after an epoch, captured (each replay adds
    what its capture counted) or eager: one all-reduce of the parameter
    bytes a step and one of the epoch's figures (``epoch_calls == steps +
    1``), and each exchange's closed form a step."""
    _, ranks = run
    for r in ranks:
        for e in _epoch_runs(r, variant, captured):
            calls, nbytes, _ = _closed_forms(e, variant)
            assert e["calls"] == calls
            assert e["counts"] == nbytes


@pytest.mark.parametrize("variant", VARIANTS)
def test_the_stand_in_capture_runs_no_collective(run, variant):
    """The gloo collectives that ran in an epoch: as many under the
    stand-in capture (warm-up, dry run, replays) as eagerly, and as the
    closed forms say; the dry run ran none."""
    _, ranks = run
    for r in ranks:
        eager = _epoch_runs(r, variant, False)
        captured = _epoch_runs(r, variant, True)
        for a, b in zip(captured, eager):
            want = dict.fromkeys(COLLECTIVES, 0)
            want.update(_closed_forms(b, variant)[2])
            assert a["executed"] == b["executed"] == want


@pytest.mark.parametrize("variant", VARIANTS)
def test_no_host_sync_in_a_mesh_step(run, variant):
    """A train and an eval step of each path's scans, as the card
    captures them, hold no op that syncs the host (collectives
    included)."""
    _, ranks = run
    for r in ranks:
        got = r[("sync", variant)]
        assert got["ops"] > 100, "the mode saw the steps' ops"
        assert got["found"] == [], f"host syncs in a {variant} step"


@pytest.mark.parametrize("op", ["all_reduce", "all_to_all", "all_gather",
                                "reduce_scatter"])
def test_staged_collectives_refuse_a_capture(tmp_path, monkeypatch, op):
    """In the share-device mode each wrapper stages through host memory,
    which a CUDA graph cannot hold: called while the current stream
    captures, it raises before it copies; otherwise it stages and runs as
    before (one gloo rank here)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    comm.stage_through_host(True)
    try:
        x = torch.arange(4.0)
        assert torch.equal(getattr(comm, op)(x.clone()), x)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        with pytest.raises(RuntimeError, match="being captured"):
            getattr(comm, op)(x.clone())
    finally:
        comm.stage_through_host(False)
        comm.reset_counts()
        dist.destroy_process_group()


# -- on the card -------------------------------------------------------------

@pytest.fixture()
def nccl_rank(tmp_path):
    """This process as one NCCL rank on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    device = mesh.init_process(0, 1, os.fspath(tmp_path / "init"), "cuda")
    try:
        yield device
    finally:
        dist.destroy_process_group()


def _card_graph():
    from legion_tpu_torch.data.synthetic import random_power_law_graph
    return random_power_law_graph(num_nodes=20_000, avg_degree=12,
                                  feature_dim=32, num_classes=7, seed=1)


def _card_cfg(**kw):
    c = port_config
    return c.Config(
        dataset=c.DatasetConfig(num_classes=7, **kw.pop("dataset", {})),
        sampler=c.SamplerConfig(fanouts=(5, 3), batch_size=128,
                                eval_batch_size=128, probe_caps=False),
        model=c.ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                            dropout=0.3, dtype="bfloat16"),
        train=c.TrainConfig(learning_rate=0.01, seed=0, epochs=1),
        parallel=c.ParallelConfig(num_devices=1, **kw))


def _held_equal(got, want):
    """Edges, frontier and overflow equal step for step, losses within
    1e-3 relative (K2 backward's atomics add in any order)."""
    got, want = got.cpu(), want.cpu()
    assert torch.equal(got[:, 1:], want[:, 1:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", DP)
def test_cuda_mesh_trainer_captured_equals_eager(nccl_rank, placement):
    """One NCCL rank: ``MeshTrainer`` captures (its collectives inside)
    and its captured steps against the same steps run eagerly from the
    same state: metrics as ``_held_equal``, the collectives counted after
    the replays equal the eager steps' (one all-reduce a step; two
    all-to-alls on "hbm_sharded"), the captured validation counts equal
    the eager loop's, and an eager step passes
    ``set_sync_debug_mode("error")``."""
    g = _card_graph()
    tr = MeshTrainer(_card_cfg(dataset={"feature_placement": placement}),
                     g, nccl_rank)
    assert tr.capture_steps and dist.get_backend() == "nccl"
    seeds = _shard_rows(tr.shards_train[0], ROWS, 128, seed=3)
    sd = torch.from_numpy(seeds).to(nccl_rank)
    ld = torch.from_numpy(np.asarray(g.labels, np.int32)[seeds]).to(nccl_rank)
    start = _snapshot(tr.state)
    comm.reset_counts()
    got = tr._train_steps(seeds, None)
    counted = comm.read_counts(), comm.read_calls()
    assert isinstance(tr.fns.epoch_scan.runs[False].step.graph,
                      torch.cuda.CUDAGraph)
    _load(tr.state, start)
    comm.reset_counts()
    want = _eager_loop(tr.fns, tr.state, tr.graph, tr.features, sd, ld)
    assert counted == (comm.read_counts(), comm.read_calls())
    assert counted[1]["all_reduce"] == ROWS
    assert counted[1].get("all_to_all", 0) == (
        2 * ROWS if placement == "hbm_sharded" else 0)
    _held_equal(got, want)
    vs, vc = (x[0] for x in tr._eval_seeds("valid"))
    a = tr._eval_counts(vs, vc, 12345, None).tolist()
    gen = torch.Generator(device=nccl_rank).manual_seed(12345)
    lab = np.where(vs >= 0, np.asarray(g.labels)[np.clip(vs, 0, None)], -1)
    acc = torch.zeros(2, device=nccl_rank)
    for t in range(vs.shape[0]):
        x, y = tr.fns_eval.eval_step(
            tr.model, tr.graph, tr.features,
            torch.from_numpy(vs[t]).to(nccl_rank),
            torch.tensor(int(vc[t]), dtype=torch.int32, device=nccl_rank),
            torch.from_numpy(lab[t].astype(np.int32)).to(nccl_rank),
            generator=gen)
        acc += torch.stack([x.float(), y.float()])
    assert a == acc.tolist()
    nb = torch.tensor(128, dtype=torch.int32, device=nccl_rank)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.fns.train_step(tr.state, tr.graph, tr.features, sd[0], nb, ld[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
@pytest.mark.parametrize("halo", HALO)
def test_cuda_partitioned_captured_equals_eager(nccl_rank, halo):
    """One NCCL rank: the partitioned driver trains an epoch and evaluates
    through captured steps; ROWS more steps through ``run_epoch`` against
    the parent's eager loop from the same state (edges, cap and halo
    overflow equal, losses within 1e-3 relative), and the collectives
    counted after the replays equal the eager loop's."""
    g = _card_graph()
    res = pd.run_partitioned_training(_card_cfg(halo_exchange=halo), g,
                                      nccl_rank, log=lambda s: None)
    tr, state = res["trainer"], res["state"]
    assert isinstance(tr.fns.epoch_scan.runs[False].step.graph,
                      torch.cuda.CUDAGraph)
    assert isinstance(tr.fns_eval.eval_scan.runs[False].step.graph,
                      torch.cuda.CUDAGraph)
    seeds = _shard_rows(np.asarray(g.train_ids), ROWS, 128, seed=4)
    labels = np.asarray(g.labels, np.int32)[seeds]
    start = _snapshot(state)
    comm.reset_counts()
    got = tr.run_epoch(state, seeds, labels)
    counted = comm.read_counts(), comm.read_calls()
    _load(state, start)
    comm.reset_counts()
    want = _parent_run_epoch(tr, state, seeds, labels)
    assert counted == (comm.read_counts(), comm.read_calls())
    assert counted[1]["all_reduce"] == ROWS + 1
    assert counted[1].get("all_gather", 0) == (
        3 * ROWS if halo == "psum" else 0)
    for k in ("steps", "edges", "cap_overflow", "halo_overflow"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
