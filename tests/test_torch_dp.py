"""Data-parallel training of the port (``parallel/{mesh,dp,trainer}.py``,
``utils/comm.py``) against ``legion_tpu``'s ``MeshTrainer``, with gloo
ranks on the CPU.

Each world size runs in one spawn of single-threaded ranks (a
module-scoped fixture), which write what they saw to files. The reference
runs in this process on the virtual CPU devices ``tests/conftest.py``
sets up; its key schedule gives rank r's uniforms (train:
``fold_in(fold_in(rng, step), r)`` split into the sampling key; eval:
``split(PRNGKey(12345), steps)[t]`` folded with r), which reach the ranks
in a file, and the ranks start from its initial weights. With dropout 0,
per-step losses agree within rtol 1e-4 / atol 1e-5 and the parameters
after the epoch within 1e-4 absolute (the Trainer parity tolerance),
eval counts exactly. Every rank ends with bitwise the same parameters; a
step makes exactly one all-reduce of parameter size; the gradient applied
is the mean of the ranks' gradients within 1e-7; a 2-rank
kill-and-resume gives exactly the uninterrupted losses; world size 1 is
bitwise the ``Trainer`` with ``probe_caps=False``.

Only the parity helpers import JAX, inside the functions the parent
runs: the ranks import this module by name and load no JAX."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from legion_tpu_torch import config as port_config
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.parallel import mesh
from legion_tpu_torch.parallel.dp import GradMean
from legion_tpu_torch.parallel.trainer import MeshTrainer
from legion_tpu_torch.sampling.seeds import seeds_of_epoch
from legion_tpu_torch.train.graphed import METRICS
from legion_tpu_torch.train.loop import Trainer, make_step_fns
from legion_tpu_torch.utils import comm

torch.set_num_threads(2)

B, EB, FANOUTS, HIDDEN = 32, 64, (4, 3), 16
HOPS = len(FANOUTS)


def _graph():
    """conftest's ``small_graph``, built here so that the ranks need no
    conftest."""
    return random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=7, seed=1)


def _cfg(cm, world, epochs=1, dropout=0.0, ck=None, **dataset):
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=7, feature_pad_align=0,
                                 **dataset),
        sampler=cm.SamplerConfig(fanouts=FANOUTS, batch_size=B,
                                 eval_batch_size=EB, probe_caps=False),
        model=cm.ModelConfig(arch="sage", hidden_dim=HIDDEN, num_layers=2,
                             dropout=dropout),
        train=cm.TrainConfig(learning_rate=0.01, seed=0, epochs=epochs,
                             checkpoint_dir=ck),
        parallel=cm.ParallelConfig(num_devices=world))


# -- the ranks ----------------------------------------------------------------

class _Spy(GradMean):
    """GradMean that keeps the flat gradient before and after it."""

    def __call__(self, model):
        self.before = torch.cat([p.grad.reshape(-1) for p in self.params])
        super().__call__(model)
        self.after = torch.cat([p.grad.reshape(-1) for p in self.params])


def _rank_checks(device, d, world):
    """Everything one rank checks, in one spawn: the parity epoch and
    eval, one step counted alone with its gradients, and (2 ranks) the
    kill-and-resume and the striped table."""
    rank = dist.get_rank()
    g = _graph()
    u = np.load(os.path.join(d, "uniforms.npz"))

    def train_u(s, k):
        return torch.from_numpy(u[f"t{rank}_{s}_{k}"])

    def eval_u(t, k):
        return torch.from_numpy(u[f"e{rank}_{t}_{k}"])

    cfg = _cfg(port_config, world)
    tr = MeshTrainer(cfg, g, device)
    tr.model.load_state_dict(torch.load(os.path.join(d, "init.pt")))
    comm.reset_counts()
    rec = tr.train_one_epoch(0, uniforms=train_u)
    out = {"losses": rec["losses"], "steps": rec["steps"],
           "epoch_counts": comm.read_counts(),
           "epoch_calls": comm.read_calls(),
           "params": {k: v.clone() for k, v in tr.model.state_dict().items()},
           "eval": tr.eval_counts("valid", uniforms=eval_u),
           "mesh": tr.mesh.shape}

    # one more step on this rank's first seeds, counted alone
    spy = _Spy(tr.model)
    step = make_step_fns(cfg, tr.caps, reducer=spy).train_step
    seeds = torch.from_numpy(tr.shards_train[rank][:B].astype(np.int32))
    comm.reset_counts()
    step(tr.state, tr.graph, tr.features, seeds,
         torch.tensor(B, dtype=torch.int32),
         torch.from_numpy(np.asarray(g.labels, np.int32)[seeds.numpy()]))
    out.update(step_counts=comm.read_counts(), step_calls=comm.read_calls(),
               param_bytes=comm.param_bytes(tr.model),
               param_count=sum(p.numel() for p in tr.model.parameters()))
    every = [torch.empty_like(spy.before) for _ in range(world)]
    dist.all_gather(every, spy.before)
    out["grad_mean_err"] = float((spy.after - torch.stack(every).mean(0))
                                 .abs().max())
    out["grad_spread"] = float((every[0] - every[-1]).abs().max())

    if world == 2:
        ck = os.path.join(d, "ck")
        kw = dict(dropout=0.3)
        whole_tr = MeshTrainer(_cfg(port_config, world, epochs=2, **kw), g,
                               device)
        whole = whole_tr.fit(log=lambda s: None)
        run = whole_tr.fns.epoch_scan.runs[False]
        steps = whole_tr.plan.train_steps
        want = seeds_of_epoch(0, 1, whole_tr.shards_train,
                              whole_tr.plan)[rank]
        out["prefetch"] = {
            "counts": [h["counts"].get("seeds_prefetched", 0)
                       for h in whole["history"]],
            "seeds": run.seeds[:steps].clone(),
            "labels": run.labels[:steps].clone(),
            "want": torch.from_numpy(want),
            "want_labels": torch.from_numpy(
                np.asarray(g.labels, np.int32)[want])}
        first = MeshTrainer(_cfg(port_config, world, epochs=1, ck=ck, **kw),
                            g, device).fit(log=lambda s: None)
        resumed = MeshTrainer(_cfg(port_config, world, epochs=2, ck=ck, **kw),
                              g, device)
        start = resumed.state.epoch
        rest = resumed.fit(log=lambda s: None)
        out["resume"] = {
            "whole": [h["losses"] for h in whole["history"]],
            "first": [h["losses"] for h in first["history"]],
            "start": start, "rest": [h["losses"] for h in rest["history"]],
            "valid": ([h["valid"] for h in whole["history"]],
                      [h["valid"] for h in rest["history"]]),
            "test": (whole["test_acc"], rest["test_acc"])}
        striped = MeshTrainer(dataclasses.replace(
            _cfg(port_config, world, feature_placement="hbm_sharded"),
            cache=port_config.CacheConfig(group_size=2)), g, device)
        striped.model.load_state_dict(torch.load(os.path.join(d,
                                                              "init.pt")))
        out["striped"] = {"mesh": striped.mesh.shape,
                          "rows": striped.features.shape[0],
                          "losses": striped.train_one_epoch(
                              0, uniforms=train_u)["losses"]}
        sharded = MeshTrainer(_cfg(port_config, world,
                                   feature_placement="hbm_sharded"), g,
                              device)
        sharded.model.load_state_dict(torch.load(os.path.join(d,
                                                              "init.pt")))
        out["sharded_losses"] = sharded.train_one_epoch(
            0, uniforms=train_u)["losses"]
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


# -- the reference ------------------------------------------------------------

def _reference(world, d):
    """The reference's MeshTrainer on ``world`` virtual devices: one
    epoch's per-step losses, the params after it, the valid counts, and
    the uniforms of its key schedule for every rank, written to ``d``."""
    import jax

    from legion_tpu import config as jax_config
    from legion_tpu.parallel.trainer import MeshTrainer as JaxMeshTrainer
    from legion_tpu.sampling.seeds import (epoch_eval_seeds,
                                           epoch_train_seeds,
                                           interleave_shards)
    from legion_tpu_torch.models.convert import params_from_flax
    from tests.test_torch_sampler import jax_uniforms
    g = _graph()
    jtr = JaxMeshTrainer(_cfg(jax_config, world), g)
    assert dict(jtr.mesh.shape) == {"data": world, "cache": 1}
    torch.save(params_from_flax(jtr.state.params),
               os.path.join(d, "init.pt"))
    u = {}
    for s in range(jtr.plan.train_steps):
        base = jax.random.fold_in(jtr.state.rng, s)
        for r in range(world):
            skey, _ = jax.random.split(jax.random.fold_in(base, r))
            for k, a in enumerate(jax_uniforms(skey, jtr.caps, FANOUTS)):
                u[f"t{r}_{s}_{k}"] = a
    keys = jax.random.split(jax.random.PRNGKey(12345), jtr.plan.valid_steps)
    for t in range(jtr.plan.valid_steps):
        for r in range(world):
            for k, a in enumerate(jax_uniforms(jax.random.fold_in(keys[t], r),
                                               jtr.eval_caps, FANOUTS)):
                u[f"e{r}_{t}_{k}"] = a
    np.savez(os.path.join(d, "uniforms.npz"), **u)

    # train_one_epoch's program, read per step
    rng = np.random.default_rng(0 * 100003 + 0)
    seeds, _ = epoch_train_seeds(rng, jtr.shards_train, jtr.plan)
    labels = np.asarray(g.labels)[seeds].astype(np.int32)
    jtr.state, losses, _ = jtr.jit_epoch(
        jtr.state, jtr.graph, jtr.features,
        jax.device_put(interleave_shards(seeds), jtr._mat),
        jax.device_put(interleave_shards(labels), jtr._mat))
    # evaluate("valid")'s program, read as counts
    seeds, counts = epoch_eval_seeds(jtr.shards_valid, jtr.plan.valid_steps,
                                     jtr.plan.valid_batch, EB)
    lab = np.where(seeds >= 0, np.asarray(g.labels)[np.clip(seeds, 0, None)],
                   -1).astype(np.int32)
    c, n = jtr.jit_eval_scan(
        jtr.state.params, jtr.graph, jtr.features,
        jax.device_put(interleave_shards(seeds), jtr._mat),
        jax.device_put(np.ascontiguousarray(counts.swapaxes(0, 1)),
                       jtr._mat),
        jax.device_put(interleave_shards(lab), jtr._mat),
        jax.device_put(jax.random.PRNGKey(12345), jtr._rep))
    return {"losses": np.asarray(losses).tolist(),
            "params": params_from_flax(jtr.state.params),
            "eval": (float(c), float(n)), "steps": jtr.plan.train_steps}


def _run(world):
    with tempfile.TemporaryDirectory() as d:
        ref = _reference(world, d)
        mesh.spawn(_rank_checks, world, "cpu", args=(d, world), threads=1)
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
    return ref, ranks


@pytest.fixture(scope="module")
def run2():
    return 2, *_run(2)


@pytest.fixture(scope="module")
def run4():
    return 4, *_run(4)


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def world_run(request):
    return request.getfixturevalue(f"run{request.param}")


# -- the checks ---------------------------------------------------------------

def test_mesh_trainer_matches_the_reference(world_run):
    world, ref, ranks = world_run
    r0 = ranks[0]
    assert r0["mesh"] == {"data": world, "cache": 1}
    assert r0["steps"] == ref["steps"] > 1
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=1e-4,
                               atol=1e-5)
    for k, want in ref["params"].items():
        np.testing.assert_allclose(r0["params"][k].numpy(), want.numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)
    for r in ranks[1:]:
        assert r["losses"] == r0["losses"]
        assert all(torch.equal(r["params"][k], v)
                   for k, v in r0["params"].items())


def test_eval_counts_are_summed_over_ranks(world_run, small_graph):
    world, ref, ranks = world_run
    assert all(r["eval"] == ranks[0]["eval"] for r in ranks)
    assert ranks[0]["eval"] == ref["eval"]
    assert ranks[0]["eval"][1] == len(small_graph.valid_ids)


def test_one_param_sized_all_reduce_a_step(world_run):
    """The wrapper counts one all-reduce in a step, of the parameter bytes
    (``tests/test_comm_accounting.py:186``'s bound), and the closed forms
    agree with the counts; over the epoch one more, of the (steps, 5)
    float64 metrics (``graphed.METRICS``)."""
    world, _, ranks = world_run
    for r in ranks:
        pb, got = r["param_bytes"], r["step_counts"]
        assert r["step_calls"] == {"all_reduce": 1}
        assert pb <= got["all_reduce"] <= pb + 256
        assert comm.link_bytes(got, world) == int(
            comm.grad_allreduce_bytes(r["param_count"]) * (world - 1)
            / world)
        assert r["epoch_calls"] == {"all_reduce": r["steps"] + 1}
        assert r["epoch_counts"]["all_reduce"] == (
            r["steps"] * pb + r["steps"] * len(METRICS) * 8)


def test_applied_gradient_is_the_mean_of_the_ranks(world_run):
    _, _, ranks = world_run
    for r in ranks:
        assert r["grad_spread"] > 1e-4          # the ranks' batches differ
        assert r["grad_mean_err"] <= 1e-7


def test_kill_and_resume_at_two_ranks(run2):
    """A run checkpointed after epoch 0 and resumed by fresh trainers on
    every rank gives exactly the uninterrupted run's next epoch (dropout
    0.3: each rank's generator comes back)."""
    _, _, ranks = run2
    for r in ranks:
        res = r["resume"]
        assert res["first"] == res["whole"][:1]
        assert res["start"] == 1
        assert res["rest"] == res["whole"][1:]
        assert res["valid"][1] == res["valid"][0][1:]
        assert res["test"][0] == res["test"][1]


def test_each_rank_takes_its_own_prefetched_shard(run2):
    """Two consecutive epochs at two ranks (the uninterrupted run of the
    kill-and-resume case): epoch 1 takes the draw each rank held from
    epoch 0 (one ``seeds_prefetched``, none in epoch 0) and loads its own
    shard's rows of ``seeds_of_epoch`` and their labels."""
    _, _, ranks = run2
    for r in ranks:
        p = r["prefetch"]
        assert p["counts"] == [0, 1]
        assert torch.equal(p["seeds"], p["want"])
        assert torch.equal(p["labels"], p["want_labels"])
    assert not torch.equal(ranks[0]["prefetch"]["seeds"],
                           ranks[1]["prefetch"]["seeds"])


def test_hbm_sharded_across_ranks_is_refused_by_name(run2):
    """Striped over a cache axis of two (each rank holding half the
    table, the frontier's rows fetched over the group) and on a cache
    axis of one (the whole table), it trains bitwise as "hbm" does."""
    _, _, ranks = run2
    for r in ranks:
        assert r["striped"]["mesh"] == {"data": 1, "cache": 2}
        assert r["striped"]["rows"] == 1000          # ceil(2000 / 2)
        assert r["striped"]["losses"] == r["losses"]
        assert r["sharded_losses"] == r["losses"]


def test_world_size_one_is_the_trainer(small_graph, tmp_path):
    """MeshTrainer on one gloo rank, bitwise the Trainer with
    ``probe_caps=False`` (dropout 0.3, two epochs: losses, validation,
    test and parameters), through its one all-reduce a step."""
    cfg = _cfg(port_config, 1, epochs=2, dropout=0.3)
    want_tr = Trainer(cfg, small_graph, "cpu")
    want = want_tr.fit(log=lambda s: None)
    want_valid = want_tr.evaluate("valid")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        comm.reset_counts()
        tr = MeshTrainer(cfg, small_graph, "cpu")
        got = tr.fit(log=lambda s: None)
        calls = comm.read_calls()
        got_valid = tr.evaluate("valid")
    finally:
        dist.destroy_process_group()
    assert tr.caps == want_tr.caps
    assert [h["losses"] for h in got["history"]] == [
        h["losses"] for h in want["history"]]
    assert got["history"][-1]["valid"] == got_valid == want_valid
    assert got["test_acc"] == want["test_acc"]
    assert all(torch.equal(a, b) for a, b in zip(tr.model.parameters(),
                                                 want_tr.model.parameters()))
    steps = tr.plan.train_steps
    # a gradient all-reduce a step, one of the metrics an epoch, one of the
    # counts per evaluation (two valid, one test)
    assert calls == {"all_reduce": 2 * steps + 2 + 3}


def test_comm_closed_forms_match_the_reference():
    """The port's closed forms give the reference's numbers for the ops
    the port calls (its op names are HLO's, the port's
    ``torch.distributed``'s)."""
    from legion_tpu.utils import comm as jax_comm
    names = {"all_reduce": "all-reduce"}
    counts = {"all_reduce": 12_345}
    for k in (1, 2, 4, 8):
        assert comm.link_bytes(counts, k) == jax_comm.link_bytes(
            {names[n]: v for n, v in counts.items()}, k)
    assert comm.grad_allreduce_bytes(91_207) == jax_comm.grad_allreduce_bytes(
        91_207)


def test_the_mesh_checks_its_world():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"this process sees {n}"):
        mesh.check_world(n + 1, "cuda")
    mesh.check_world(3, "cpu")
    assert mesh.backend_for("cuda") == "nccl"
    assert mesh.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        mesh.backend_for("mps")
