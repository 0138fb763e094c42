"""The captured step (``legion_tpu_torch/train/graphed.py``), the port's
counterpart of ``legion_tpu``'s ``jit(epoch_scan)`` / ``jit(eval_scan)``.

On the CPU the scans run their static-buffer step eagerly, so these tests
run the code that a CUDA graph records on the card:

* a ``Trainer`` epoch and validation pass against the reference's
  ``jit_epoch`` / ``jit_eval_scan`` fed its key schedule's uniforms, for
  SAGE bf16, GCN float32 (K5's plain path) and LP-SAGE, eagerly and
  through a stand-in capture (``fake_capture``: the warm-up runs the
  step, the "capture" runs its Python while no tensor that outlives it
  changes and no registered generator draws, and a "replay" runs the
  step again without counting launches);
* no host sync: a ``TorchDispatchMode`` finds no op that reads a device
  value on the host, or copies to another device, in any arch's train
  and eval steps;
* three replays return three rows, a restore keeps every tensor's
  address and the graph, a replaced optimizer state gets a new capture,
  and the launch counts of N replays are N times one eager step's.

Tolerances against the reference: float32 as
``tests/test_torch_train.py::_assert_epoch_matches`` states them (loss
rtol 1e-4 / atol 1e-5, parameters 1e-4 absolute, accuracy equal).
bf16 (SAGE): the losses within 1e-3 relative, each parameter tensor
within 0.1 of the distance it moved (L2) and the accuracy within 1e-2:
the two frameworks round activations to bf16 at different points
(``tests/test_torch_sage.py`` holds one bf16 step's loss to 3e-2), and
an epoch of Adam steps carries one-ulp differences into the weights
(measured: 2.6e-4 on the loss, 5 % of the distance moved, 1 of 400
validation seeds). LP-SAGE (float32): the losses within 4e-4 relative,
each parameter tensor within 1e-2 of the distance it moved, and its
validation figure, a loss, within 1e-3. Its first step matches to 1e-7;
from the first Adam step on it drifts (Adam divides each gradient by its
own magnitude, so summation-order differences in near-zero gradients
become whole steps): measured 1.6e-4 on the last loss, 0.32 % of the
distance moved and 2.9e-5 on the validation loss, where the same case
computed in bf16 reads 8.9e-4, 5.6 % and 2.7e-3, so each limit fails a
bf16 LP-SAGE. Against the port's own eager step the scans are bitwise
equal in every case. The ``cuda``-marked legs run on the card
(``pytest --noconftest -m cuda tests/test_torch_graphed.py``).
"""

import contextlib
import copy
import dataclasses
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from legion_tpu_torch import config as port_config
from legion_tpu_torch.models import sage as port_sage
from legion_tpu_torch.models.convert import params_from_flax
from legion_tpu_torch.ops import (act_dropout, dedup, gather, identity_agg,
                                  sample, spmm)
from legion_tpu_torch.parallel.trainer import MeshTrainer
from legion_tpu_torch.sampling import sampler as port_sampler
from legion_tpu_torch.train import graphed
from legion_tpu_torch.train.loop import Trainer
from legion_tpu_torch.train.train_state import (restore_checkpoint,
                                                save_checkpoint,
                                                state_tensors)
from legion_tpu_torch.utils import comm
torch.set_num_threads(2)

BATCH, FANOUTS = 128, (5, 3)      # tests/test_torch_train.py's fanouts
# (arch, compute dtype) of the parity cases
ARCHS = [("sage", "bfloat16"), ("gcn", "float32"), ("lp_sage", "float32")]


def _cfg(cm, arch, dtype, num_classes, dropout=0.0, **train):
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=num_classes),
        sampler=cm.SamplerConfig(fanouts=FANOUTS, batch_size=BATCH,
                                 eval_batch_size=BATCH),
        model=cm.ModelConfig(arch=arch, hidden_dim=16, num_layers=2,
                             dropout=dropout, dtype=dtype),
        train=cm.TrainConfig(learning_rate=0.01, epochs=3, seed=0, **train))


class _FakeGraph:
    """A CUDA graph's stand-in on the CPU: a replay runs the step again,
    with the wrappers' launch counts and the collectives' counts held, as
    a replay makes no Python call."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        counts = [fn.launches for fn in graphed.COUNTED]
        collectives = comm.snapshot()
        self.body()
        for fn, n in zip(graphed.COUNTED, counts):
            fn.launches = n
        comm.restore(collectives)


class _DryRun(TorchDispatchMode):
    """What a capture does to the tensors around it: nothing. An op that
    writes into a tensor made before the mode was entered writes into a
    copy instead, which later ops of the run read in its place; tensors
    the run made are written as usual."""

    def __init__(self):
        super().__init__()
        self.fresh = set()        # storages the run allocated
        self.copies = {}          # id(tensor made before) -> (it, its copy)

    def _stored(self, t):
        return t.untyped_storage().data_ptr()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        args = list(args)

        def swap(t):
            return (self.copies[id(t)][1]
                    if isinstance(t, torch.Tensor) and id(t) in self.copies
                    else t)
        args = [[swap(x) for x in a] if isinstance(a, (list, tuple))
                else swap(a) for a in args]
        kwargs = {k: swap(v) for k, v in kwargs.items()}
        for i, spec in enumerate(func._schema.arguments):
            if spec.alias_info is None or not spec.alias_info.is_write:
                continue
            t = args[i] if i < len(args) else kwargs.get(spec.name)
            if isinstance(t, torch.Tensor) and self._stored(t) not in self.fresh:
                copy_ = t.clone()
                self.fresh.add(self._stored(copy_))
                self.copies[id(t)] = (t, copy_)
                if i < len(args):
                    args[i] = copy_
                else:
                    kwargs[spec.name] = copy_
        held = {self._stored(t) for t in args if isinstance(t, torch.Tensor)}
        out = func(*args, **kwargs)
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and self._stored(t) not in held:
                self.fresh.add(self._stored(t))
        return out


@contextlib.contextmanager
def _local_collectives():
    """A capture runs no collective, so neither does its stand-in: under
    this each ``torch.distributed`` call the wrappers of ``utils.comm``
    make fills its result from this rank's own input (any values of the
    result's shape do, ``_DryRun`` throws them away) and no rank waits
    for another."""
    def all_to_all_single(out, src, group=None):
        out.copy_(src)

    def all_gather(parts, src, group=None):
        for p in parts:
            p.copy_(src)

    def reduce_scatter(out, parts, group=None):
        out.copy_(parts[0])

    def batch_isend_irecv(ops):
        sent = next(op.tensor for op in ops if op.op is dist.isend)
        for op in ops:
            if op.op is dist.irecv:
                op.tensor.copy_(sent)
        return []

    with mock.patch.multiple(dist, all_reduce=lambda t, group=None: None,
                             all_to_all_single=all_to_all_single,
                             all_gather=all_gather,
                             reduce_scatter=reduce_scatter,
                             batch_isend_irecv=batch_isend_irecv):
        yield


@contextlib.contextmanager
def faked_capture():
    """Capture on the CPU: ``GraphPool`` captures, the warm-up runs the
    step, and the "capture" runs its Python under ``_DryRun`` and
    ``_local_collectives`` with the registered generators' states put
    back after it, so that, as on the card, it changes nothing and the
    launches and collectives it counts are those a replay adds. Yields
    the list of captured steps."""
    captures = []

    def init(self, device):
        self.device, self.captures, self.handle = torch.device(device), True, None

    def capture(body, generators, pool):
        states = [g.get_state() for g in generators]
        with _DryRun(), _local_collectives():
            body()
        for g, st in zip(generators, states):
            g.set_state(st)
        captures.append(body)
        return _FakeGraph(body)

    with mock.patch.object(graphed.GraphPool, "__init__", init), \
            mock.patch.object(graphed, "warm_up",
                              lambda body, device: body()), \
            mock.patch.object(graphed, "capture", capture), \
            mock.patch.object(torch.cuda, "synchronize",
                              lambda device=None: None):
        yield captures


@pytest.fixture
def fake_capture():
    with faked_capture() as captures:
        yield captures


@pytest.fixture(scope="module", params=ARCHS, ids=["-".join(a) for a in ARCHS])
def ref_case(request, small_graph):
    # the reference is imported here: the card's machine, which runs the
    # cuda legs of this file, has no JAX
    from legion_tpu import config as jax_config
    from tests.test_torch_train import _ref_epoch
    arch, dtype = request.param
    g = small_graph
    return arch, dtype, _ref_epoch(g, _cfg(jax_config, arch, dtype,
                                           g.num_classes))


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
def test_epoch_and_eval_scan_match_the_reference(small_graph, ref_case,
                                                 captured, request):
    """The Trainer's epoch (``epoch_scan``) and validation pass
    (``eval_scan``) from the reference's initial parameters and with its
    uniforms, against ``legion_tpu``'s ``jit_epoch`` / ``jit_eval_scan``
    (tolerances: the module's docstring)."""
    arch, dtype, ref = ref_case
    if captured:
        request.getfixturevalue("fake_capture")
    g = small_graph
    tr = Trainer(_cfg(port_config, arch, dtype, g.num_classes), g,
                 device="cpu")
    tr.model.load_state_dict(params_from_flax(ref["params0"]))
    p0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    rec = tr.train_one_epoch(0, uniforms=ref["train_u"])
    bf16 = dtype == "bfloat16"
    loose = bf16 or arch == "lp_sage"
    # (loss rtol, parameter distance as a share of the distance moved)
    loss_rtol, moved_share = ((1e-3, 0.1) if bf16 else
                              (4e-4, 1e-2) if arch == "lp_sage" else
                              (1e-4, None))
    for k in ("loss", "mean_loss"):
        np.testing.assert_allclose(rec[k], ref["rec"][k], rtol=loss_rtol,
                                   atol=1e-5, err_msg=k)
    got = tr.model.state_dict()
    for k, want in ref["params1"].items():
        if loose:
            moved = (want - p0[k]).norm()
            assert (got[k] - want).norm() <= moved_share * moved, k
        else:
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=0,
                                       atol=1e-4, err_msg=k)
    valid = tr.evaluate("valid", uniforms=ref["eval_u"])
    if arch == "lp_sage":      # a loss: the losses' tolerance
        np.testing.assert_allclose(valid, ref["valid"], rtol=1e-3, atol=1e-5)
    else:
        assert valid == pytest.approx(ref["valid"], abs=1e-2 if bf16 else 1e-6)
    assert tr.state.step == tr.plan.train_steps
    assert bool(tr.fns.epoch_scan.runs[True].step.graph) == captured


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("arch,dtype", ARCHS + [("gcn", "bfloat16")])
def test_scan_is_the_eager_step(small_graph, arch, dtype, captured,
                                request):
    """With the generator's own draws and dropout, an epoch through
    ``epoch_scan`` and a validation pass through ``eval_scan`` give
    bitwise what a loop of the eager ``train_step`` / ``eval_step`` gives
    from the same state: the static buffers, the row counter and the
    metrics rows change nothing."""
    if captured:
        request.getfixturevalue("fake_capture")
    g = small_graph
    cfg = _cfg(port_config, arch, dtype, g.num_classes, dropout=0.3)
    tr, twin = (Trainer(cfg, g, device="cpu") for _ in range(2))
    rng = np.random.default_rng(3)
    seeds = np.stack([rng.permutation(g.train_ids)[:BATCH]
                      for _ in range(4)]).astype(np.int32)
    labels = np.asarray(g.labels, np.int32)[seeds]
    got = tr._train_steps(seeds, None)
    want = torch.stack([torch.stack([m[k].double() for k in graphed.METRICS])
                        for m in (twin.fns.train_step(
                            twin.state, twin.graph, twin.features,
                            torch.from_numpy(seeds[i]),
                            torch.tensor(BATCH, dtype=torch.int32),
                            torch.from_numpy(labels[i]))
                            for i in range(4))])
    assert torch.equal(got, want)
    for a, b in zip(state_tensors(tr.state), state_tensors(twin.state)):
        assert torch.equal(a, b)
    assert tr.state.step == twin.state.step == 4
    vs, vc = (x[0] for x in tr._eval_seeds("valid"))
    lab = np.where(vs >= 0, np.asarray(g.labels)[np.clip(vs, 0, None)],
                   -1).astype(np.int32)
    gen = torch.Generator().manual_seed(12345)
    acc = torch.zeros(2)
    for t in range(vs.shape[0]):
        a, b = twin.fns_eval.eval_step(
            twin.model, twin.graph, twin.features, torch.from_numpy(vs[t]),
            torch.tensor(int(vc[t]), dtype=torch.int32),
            torch.from_numpy(lab[t]), generator=gen)
        acc += torch.stack([a.float(), b.float()])
    assert torch.equal(tr._eval_counts(vs, vc, 12345, None), acc)


def test_capture_leaves_no_trace(small_graph, fake_capture):
    """With the generator's own draws and dropout, a captured epoch and
    validation pass give exactly the eager ones: the warm-up is the first
    step, and the capture after it changed nothing (parameters, Adam's
    state, which the warm-up made, the generators, the counters)."""
    g = small_graph
    cfg = _cfg(port_config, "sage", "float32", g.num_classes, dropout=0.3)
    eager = Trainer(cfg, g, device="cpu")
    eager.fns = eager.fns._replace(epoch_scan=graphed.EpochScan(
        eager.fns.epoch_scan.step_fn, None, ()))
    eager.fns_eval = eager.fns_eval._replace(eval_scan=graphed.EvalScan(
        eager.fns_eval.eval_scan.step_fn, None, ()))
    tr = Trainer(cfg, g, device="cpu")
    for t in (eager, tr):
        t.recs = [t.train_one_epoch(e) for e in range(2)]
        t.valid = t.evaluate("valid")
    assert len(fake_capture) == 2            # one train, one eval capture
    assert [r["losses"] for r in tr.recs] == [r["losses"] for r in eager.recs]
    assert tr.valid == eager.valid
    for a, b in zip(state_tensors(tr.state), state_tensors(eager.state)):
        assert torch.equal(a, b)
    assert torch.equal(tr.state.generator.get_state(),
                       eager.state.generator.get_state())


def test_three_replays_three_rows(small_graph, fake_capture):
    """Each replay writes its own row of the metrics: three steps give
    three different rows, equal to three eager steps' metrics."""
    g = small_graph
    cfg = _cfg(port_config, "sage", "float32", g.num_classes, dropout=0.3)
    tr, twin = (Trainer(cfg, g, device="cpu") for _ in range(2))
    seeds = np.stack([g.train_ids[i * BATCH:(i + 1) * BATCH]
                      for i in range(3)]).astype(np.int32)
    m = tr._train_steps(seeds, None)
    labels = np.asarray(g.labels, np.int32)[seeds]
    want = [twin.fns.train_step(
        twin.state, twin.graph, twin.features, torch.from_numpy(seeds[i]),
        torch.tensor(BATCH, dtype=torch.int32),
        torch.from_numpy(labels[i])) for i in range(3)]
    assert m.shape == (3, len(graphed.METRICS))
    assert len(set(m[:, 0].tolist())) == 3
    for i, w in enumerate(want):
        assert m[i].tolist() == [float(w[k]) for k in graphed.METRICS]
    assert tr.state.step == twin.state.step == 3


class _NoHostSync(TorchDispatchMode):
    """Records every aten op that would make the host wait for the device
    or copy across devices. Calls made inside ``exempt`` code are not
    recorded (``depth`` > 0)."""

    SYNCS = ("local_scalar_dense", "nonzero", "masked_select", "is_nonzero",
             "equal", "unique")

    def __init__(self):
        super().__init__()
        self.found, self.depth, self.ops = [], 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__
        if self.depth == 0:
            self.ops += 1
            if self._syncs(func, name, args, kwargs):
                self.found.append(name)
        return func(*args, **kwargs)

    def _syncs(self, func, name, args, kwargs):
        base = name.split(".")[0].lstrip("_")
        if base in self.SYNCS or base.startswith("unique"):
            return True
        if base == "repeat_interleave" and isinstance(args[0], torch.Tensor) \
                and args[0].dim() > 0 and kwargs.get("output_size") is None \
                and func is torch.ops.aten.repeat_interleave.Tensor:
            return True
        if base in ("index", "index_put", "index_put_"):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                                 torch.uint8)
                   for i in idx):
                return True
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if base in ("to_copy", "copy") and tensors:
            dev = kwargs.get("device")
            if dev is not None and torch.device(dev) != tensors[0].device:
                return True
            if base == "copy" and len(tensors) > 1 \
                    and tensors[0].device != tensors[1].device:
                return True
        return False


def _exempt(monkeypatch, mode, module, name):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        mode.depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            mode.depth -= 1

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("arch,dtype", ARCHS + [("sage", "float32"),
                                               ("gcn", "bfloat16")])
def test_no_host_sync_in_a_step(small_graph, monkeypatch, arch, dtype):
    """A train step and an eval step through the scans, as the card
    captures them, hold no op that syncs the host. Exempt: the six kernel
    wrappers' plain versions (on the card the kernels run instead), and
    Adam's step, which on the CPU is not ``capturable`` and reads its step
    count on the host (on the card it is capturable; ``chip_smoke.py``'s
    ``graphed`` phase runs an eager step under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    g = small_graph
    tr = Trainer(_cfg(port_config, arch, dtype, g.num_classes, dropout=0.3),
                 g, device="cpu")
    mode = _NoHostSync()
    for module, name in ((identity_agg, "identity_masked_mean_plain"),
                         (identity_agg, "gathered_masked_mean_plain"),
                         (identity_agg, "gathered_masked_mean_backward_plain"),
                         (gather, "gather_rows_plain"),
                         (sample, "sample_neighbors_plain"),
                         (spmm, "grouped_masked_sum_plain")):
        _exempt(monkeypatch, mode, module, name)
    _exempt(monkeypatch, mode, tr.state.optimizer, "step")
    seeds = g.train_ids[:2 * BATCH].reshape(2, BATCH).astype(np.int32)
    (vs, vc) = (x[0] for x in tr._eval_seeds("valid"))
    with mode:
        tr._train_steps(seeds, None)
        tr._eval_counts(vs, vc, 12345, None)
    assert mode.ops > 100, "the mode saw the steps' ops"
    assert mode.found == [], f"host syncs in a {arch} step: {mode.found}"


def test_the_mode_finds_a_sync():
    mode = _NoHostSync()
    x = torch.arange(6)
    with mode:
        int(x.sum())
        x[x > 2]
        torch.unique(x)
        x.repeat_interleave(x)
    assert {"_local_scalar_dense", "index", "repeat_interleave"} <= {
        n.split(".")[0] for n in mode.found}
    assert any(n.startswith("_unique") or n.startswith("unique")
               for n in mode.found)


def test_restore_in_place_keeps_the_graph(small_graph, tmp_path,
                                          fake_capture):
    """``restore_checkpoint`` loads into the tensors the state holds: every
    parameter's and Adam tensor's address stays, the captured graph stays
    (no new capture), and the epoch after the restore gives exactly the
    losses the uninterrupted run gave."""
    g = small_graph
    ck = str(tmp_path / "ck")
    cfg = _cfg(port_config, "sage", "float32", g.num_classes, dropout=0.3)
    tr = Trainer(cfg, g, device="cpu")
    tr.train_one_epoch(0)
    save_checkpoint(ck, tr.state)
    run = tr.fns.epoch_scan.runs[False]
    want = tr.train_one_epoch(1)["losses"]
    ptrs = [t.data_ptr() for t in state_tensors(tr.state)]
    assert restore_checkpoint(ck, tr.state) is tr.state
    assert [t.data_ptr() for t in state_tensors(tr.state)] == ptrs
    assert tr.state.step == tr.plan.train_steps
    assert tr.train_one_epoch(1)["losses"] == want
    assert tr.fns.epoch_scan.runs[False] is run and len(fake_capture) == 1


def test_a_replaced_optimizer_state_is_captured_anew(small_graph,
                                                     fake_capture):
    """A graph reads the addresses it was captured on: once the optimizer's
    tensors are replaced (``load_state_dict`` of a copy), the scan
    drops its graph and captures again, and still trains as the eager
    twin does."""
    g = small_graph
    cfg = _cfg(port_config, "sage", "float32", g.num_classes, dropout=0.3)
    tr, twin = (Trainer(cfg, g, device="cpu") for _ in range(2))
    for t in (tr, twin):
        t.train_one_epoch(0)
        t.state.optimizer.load_state_dict(
            copy.deepcopy(t.state.optimizer.state_dict()))
    run = tr.fns.epoch_scan.runs[False]
    twin.fns = twin.fns._replace(epoch_scan=graphed.EpochScan(
        twin.fns.epoch_scan.step_fn, None, ()))
    assert (tr.train_one_epoch(1)["losses"]
            == twin.train_one_epoch(1)["losses"])
    assert tr.fns.epoch_scan.runs[False] is not run
    assert len(fake_capture) == 3      # each epoch 0, then tr's epoch 1


def test_replays_count_the_launches_their_capture_recorded(
        small_graph, monkeypatch, fake_capture):
    """The wrappers count nothing on the CPU, so shims count for them
    here, as a kernel launch would. Over an epoch of N captured steps and
    a validation pass each count equals the eager run's: N times one
    step's (the warm-up counts as the first step, the capture nothing)."""
    def counting(module, name, wrapper):
        fn = getattr(module, name)

        def shim(*args, **kwargs):
            wrapper.launches += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, shim)

    counting(port_sampler, "sample_kernel", sample.sample_neighbors)
    counting(port_sampler, "dedup_tail", dedup.dedup_tail)
    counting(port_sampler, "gather_rows", gather.gather_rows)
    counting(port_sage, "identity_masked_mean",
             identity_agg.identity_masked_mean)
    counting(port_sage, "gathered_masked_mean",
             identity_agg.gathered_masked_mean)
    counting(port_sage, "gathered_feature_mean",
             identity_agg.gathered_feature_mean)
    counting(port_sage, "act_dropout", act_dropout.act_dropout)
    g = small_graph
    cfg = _cfg(port_config, "sage", "float32", g.num_classes, dropout=0.3)
    counts = {}
    for captured in (False, True):
        tr = Trainer(cfg, g, device="cpu")
        if not captured:
            tr.fns = tr.fns._replace(epoch_scan=graphed.EpochScan(
                tr.fns.epoch_scan.step_fn, None, ()))
            tr.fns_eval = tr.fns_eval._replace(eval_scan=graphed.EvalScan(
                tr.fns_eval.eval_scan.step_fn, None, ()))
        for fn in graphed.COUNTED:
            fn.launches = 0
        tr.train_one_epoch(0)
        train = [fn.launches for fn in graphed.COUNTED]
        tr.evaluate("valid")
        counts[captured] = (train, [fn.launches for fn in graphed.COUNTED])
    n, e = tr.plan.train_steps, tr.plan.valid_steps
    # K1, K2, K2 backward (not counted here), K3, sampling, K5, the
    # dedup's tail (hop 1; the last hop is appended), GAT's attention and
    # its backward (SAGE runs neither), the gathered feature mean (layer 0
    # takes K1 on the appended hop), the activation-dropout (a train step's
    # one position between layers) and its backward (not counted here)
    assert counts[True] == counts[False] == (
        [n, n, 0, n, 2 * n, 0, n, 0, 0, 0, n, 0],
        [n + e, n + e, 0, n + e, 2 * (n + e), 0, n + e, 0, 0, 0, n, 0])
    assert len(fake_capture) == 2
    for fn in graphed.COUNTED:
        fn.launches = 0


def test_mesh_paths_capture_on_nccl_only(small_graph, tmp_path,
                                        monkeypatch):
    """The data-parallel and partitioned paths capture their steps, the
    collectives inside, on a NCCL group of CUDA ranks only
    (``parallel.mesh.captures_steps``); gloo on the CPU and the
    share-device mode (CUDA ranks on gloo, collectives staged through
    host memory) run the same static-buffer steps eagerly.
    ``MeshTrainer`` and the partitioned driver give their scans a pool
    exactly when the predicate says so; ``Trainer`` always does."""
    from legion_tpu_torch.parallel import mesh
    from legion_tpu_torch.parallel import trainer as mesh_trainer
    from legion_tpu_torch.train import partitioned_driver as pd
    assert Trainer.capture_steps is True
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        # (device, backend, share-device staging) -> captures
        assert mesh.backend_for("cuda", share_device=True) == "gloo"
        for (dev, backend, staged), want in {
                ("cuda", "nccl", False): True,
                ("cuda", "gloo", False): False,
                ("cuda", "gloo", True): False,
                ("cpu", "gloo", False): False,
                ("cpu", "nccl", False): False}.items():
            with mock.patch.object(dist, "get_backend",
                                   lambda group=None: backend):
                comm.stage_through_host(staged)
                try:
                    assert mesh.captures_steps(dev) is want
                finally:
                    comm.stage_through_host(False)
        assert not mesh.captures_steps("cpu")            # the real gloo
        cfg = _cfg(port_config, "sage", "float32", small_graph.num_classes)
        pcfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, epochs=1))
        for told in (False, True):
            monkeypatch.setattr(mesh_trainer, "captures_steps",
                                lambda device: told)
            monkeypatch.setattr(pd, "captures_steps", lambda device: told)
            mt = MeshTrainer(cfg, small_graph, "cpu")
            assert mt.capture_steps is told
            part = pd.run_partitioned_training(pcfg, small_graph, "cpu",
                                               log=lambda s: None)["trainer"]
            for fns in (mt.fns, mt.fns_eval, part.fns, part.fns_eval):
                for scan in (fns.epoch_scan, fns.eval_scan):
                    assert (scan.pool is not None) is told
    finally:
        dist.destroy_process_group()


def test_the_pool_captures_on_a_cuda_device_only():
    pool = graphed.GraphPool("cpu")
    assert not pool.captures and pool.handle is None
    step = graphed.GraphedStep(lambda: None, pool)
    step()
    assert step.graph is None and not step.captures


# -- on the card -------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_graph():
    from legion_tpu_torch.data.synthetic import random_power_law_graph
    return random_power_law_graph(num_nodes=20_000, avg_degree=12,
                                  feature_dim=32, num_classes=7, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", ARCHS + [("gcn", "bfloat16")])
def test_cuda_capture_equals_eager(cuda, arch, dtype):
    """On the card, a captured epoch against the same epoch stepped eagerly
    (``fns.train_step``) from the same state: edges, frontier and cap
    overflow equal step for step, losses within 1e-3 relative (K2
    backward's atomics add in any order); the captured validation counts
    equal the eager loop's on the same weights; the launch counts equal;
    Adam is capturable."""
    g = _card_graph()
    cfg = _cfg(port_config, arch, dtype, g.num_classes, dropout=0.3)
    tr, eager = (Trainer(cfg, g, device=cuda) for _ in range(2))
    assert all(grp["capturable"] for grp in tr.state.optimizer.param_groups)
    eager.model.load_state_dict(tr.model.state_dict())
    seeds = g.train_ids[:4 * BATCH].reshape(4, BATCH).astype(np.int32)
    labels = np.asarray(g.labels, np.int32)[seeds]
    for fn in graphed.COUNTED:
        fn.launches = 0
    got = tr._train_steps(seeds, None).cpu()
    captured = [fn.launches for fn in graphed.COUNTED]
    for fn in graphed.COUNTED:
        fn.launches = 0
    want = torch.stack([torch.stack([m[k].double() for k in graphed.METRICS])
                        for m in (eager.fns.train_step(
                            eager.state, eager.graph, eager.features,
                            torch.from_numpy(seeds[i]).to(cuda),
                            torch.tensor(BATCH, dtype=torch.int32,
                                         device=cuda),
                            torch.from_numpy(labels[i]).to(cuda))
                            for i in range(4))]).cpu()
    assert captured == [fn.launches for fn in graphed.COUNTED]
    assert torch.equal(got[:, 1:], want[:, 1:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3)
    assert tr.fns.epoch_scan.runs[False].step.graph is not None
    vs, vc = (x[0] for x in tr._eval_seeds("valid"))
    a = tr._eval_counts(vs, vc, 12345, None).tolist()
    gen = torch.Generator(device=cuda).manual_seed(12345)
    lab = np.where(vs >= 0, np.asarray(g.labels)[np.clip(vs, 0, None)], -1)
    acc = torch.zeros(2, device=cuda)
    for t in range(vs.shape[0]):
        x, y = tr.fns_eval.eval_step(
            tr.model, tr.graph, tr.features, torch.from_numpy(vs[t]).to(cuda),
            torch.tensor(int(vc[t]), dtype=torch.int32, device=cuda),
            torch.from_numpy(lab[t].astype(np.int32)).to(cuda), generator=gen)
        acc += torch.stack([x.float(), y.float()])
    assert a == acc.tolist()
    for fn in graphed.COUNTED:
        fn.launches = 0


@pytest.mark.cuda
def test_cuda_restore_keeps_the_graph(cuda, tmp_path):
    """On the card a restore loads in place, the captured graph stays and
    goes on training: the epoch after it repeats the edges of the
    uninterrupted epoch exactly."""
    g = _card_graph()
    cfg = _cfg(port_config, "sage", "bfloat16", g.num_classes, dropout=0.3)
    tr = Trainer(cfg, g, device=cuda)
    tr.train_one_epoch(0)
    ck = os.fspath(tmp_path / "ck")
    save_checkpoint(ck, tr.state)
    run = tr.fns.epoch_scan.runs[False]
    seeds = g.train_ids[:4 * BATCH].reshape(4, BATCH).astype(np.int32)
    want = tr._train_steps(seeds, None).cpu()
    ptrs = [t.data_ptr() for t in state_tensors(tr.state)]
    restore_checkpoint(ck, tr.state)
    assert [t.data_ptr() for t in state_tensors(tr.state)] == ptrs
    got = tr._train_steps(seeds, None).cpu()
    assert tr.fns.epoch_scan.runs[False] is run
    assert torch.equal(got[:, 1:], want[:, 1:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3)
