"""Checkpoint and resume of legion_tpu_torch (counterpart of
``legion_tpu/train/train_state.py``'s orbax round trip and of
tests/test_checkpoint_drivers.py): every payload field round-trips, and a
run killed after an epoch and resumed by a fresh driver gives exactly the
losses of the uninterrupted run, since the parameters, Adam's moments,
the counters and the generator's state all come back. Exactness holds on
the CPU, where every sum has one order."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from legion_tpu_torch import config as port_config
from legion_tpu_torch.models import build_model
from legion_tpu_torch.train.cached_driver import run_cached_training
from legion_tpu_torch.train.loop import Trainer
from legion_tpu_torch.train.train_state import (create_train_state,
                                                latest_checkpoint,
                                                maybe_checkpoint_step,
                                                restore_checkpoint,
                                                save_checkpoint)

torch.set_num_threads(2)

ARCHS = ("sage", "gcn", "lp_sage")


def _cfg(arch, num_classes, epochs, ck=None, every=0, cached=False):
    return port_config.Config(
        dataset=port_config.DatasetConfig(
            num_classes=num_classes,
            feature_placement="host" if cached else "hbm"),
        sampler=port_config.SamplerConfig(
            fanouts=(4, 3), batch_size=48, eval_batch_size=48,
            probe_caps=False, dedup_last=cached),
        model=port_config.ModelConfig(arch=arch, hidden_dim=16, num_layers=2,
                                      dropout=0.3),
        train=port_config.TrainConfig(learning_rate=0.01, seed=0,
                                      epochs=epochs, checkpoint_dir=ck,
                                      checkpoint_every_steps=every),
        cache=port_config.CacheConfig(enabled=cached, budget_bytes=64 << 10,
                                      presample_steps=2))


def _stepped_state(seed=0, steps=2):
    """A state a few Adam steps and generator draws in."""
    model = build_model("gcn", 12, 8, 3, 2, 0.0,
                        generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, 0.01, seed, "cpu")
    for _ in range(steps):
        x = torch.rand((5, 12), generator=state.generator)
        loss = sum((p * p).sum() for p in model.parameters()) + x.sum()
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
    state.epoch = 1
    return state


def test_checkpoint_round_trips_every_field(tmp_path):
    ck = str(tmp_path / "ck")
    state = _stepped_state()
    path = save_checkpoint(ck, state)
    assert path == os.path.join(ck, "step_2") == latest_checkpoint(ck)
    assert os.listdir(ck) == ["step_2"]              # no temporary left
    fresh = _stepped_state(seed=5, steps=0)
    fresh.epoch = 0
    assert restore_checkpoint(ck, fresh) is fresh
    assert (fresh.step, fresh.epoch) == (2, 1)
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), k
    want, got = (s.optimizer.state_dict() for s in (state, fresh))
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"]) and want["state"]
    for i, moments in want["state"].items():
        for name, v in moments.items():
            assert torch.equal(torch.as_tensor(got["state"][i][name]),
                               torch.as_tensor(v)), (i, name)
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())
    # the restored state goes on exactly as the saved one does
    assert torch.equal(torch.rand(7, generator=fresh.generator),
                       torch.rand(7, generator=state.generator))


def test_checkpoint_of_the_one_generator_format_restores(tmp_path):
    """A file that holds one ``generator`` (the format before every
    rank's ``generators``) restores at world size 1, and a world of two
    is told how many ranks wrote it."""
    ck = str(tmp_path / "ck")
    state = _stepped_state()
    path = save_checkpoint(ck, state)
    payload = torch.load(path, weights_only=True)
    payload["generator"] = payload.pop("generators")[0]
    torch.save(payload, path)
    fresh = _stepped_state(seed=5, steps=0)
    assert restore_checkpoint(ck, fresh) is fresh
    assert (fresh.step, fresh.epoch) == (2, 1)
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())
    with pytest.raises(ValueError, match="of 1 rank"):
        restore_checkpoint(ck, _stepped_state(steps=0), rank=1, world=2)


def test_a_capturable_checkpoint_round_trips(tmp_path):
    """On the card Adam is ``capturable`` and its checkpoint says so (and
    holds each step count as a float32 tensor). Such a file restores into
    a state whose optimizer is not capturable, as on the CPU, and a
    non-capturable one into a capturable optimizer: the flag stays the
    restoring optimizer's, every value round-trips, and the restored
    state goes on stepping as the saved one does."""
    ck = str(tmp_path / "ck")
    state = _stepped_state()
    path = save_checkpoint(ck, state)
    payload = torch.load(path, weights_only=True)
    for g in payload["optimizer"]["param_groups"]:
        g["capturable"] = True
    for moments in payload["optimizer"]["state"].values():
        moments["step"] = torch.as_tensor(moments["step"],
                                          dtype=torch.float32)
    torch.save(payload, path)
    fresh = _stepped_state(seed=5, steps=1)
    restore_checkpoint(ck, fresh)
    assert not any(g["capturable"] for g in fresh.optimizer.param_groups)
    want, got = (s.optimizer.state_dict()["state"] for s in (state, fresh))
    for i, moments in want.items():
        for name, v in moments.items():
            assert torch.equal(torch.as_tensor(got[i][name]),
                               torch.as_tensor(v)), (i, name)
    for s in (state, fresh):
        loss = sum((p * p).sum() for p in s.model.parameters())
        s.optimizer.zero_grad()
        loss.backward()
        s.optimizer.step()
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    # the other way: a plain checkpoint into a capturable optimizer
    save_checkpoint(ck, state)
    cap = _stepped_state(seed=5, steps=0)
    for g in cap.optimizer.param_groups:
        g["capturable"] = True
    restore_checkpoint(ck, cap)
    assert all(g["capturable"] for g in cap.optimizer.param_groups)
    for moments in cap.optimizer.state.values():     # 2 steps, then 1
        assert moments["step"].dtype == torch.float32
        assert float(moments["step"]) == 3.0


def test_latest_checkpoint_takes_the_highest_step(tmp_path):
    ck = str(tmp_path / "ck")
    assert latest_checkpoint(ck) is None             # no directory
    state = _stepped_state(steps=0)
    assert restore_checkpoint(ck, state) is None
    assert state.step == 0
    os.makedirs(ck)
    assert latest_checkpoint(ck) is None             # an empty one
    for step in (9, 10, 2):
        state.step = step
        save_checkpoint(ck, state)
    open(os.path.join(ck, "step_99.tmp1"), "w").close()   # not a checkpoint
    assert latest_checkpoint(ck) == os.path.join(ck, "step_10")
    state.step = 0
    assert restore_checkpoint(ck, state).step == 10


def test_checkpoint_every_steps_cadence(tmp_path):
    ck = str(tmp_path / "ck")
    state = _stepped_state(steps=0)
    for every, want in ((0, []), (3, ["step_3", "step_6"])):
        tc = port_config.TrainConfig(checkpoint_dir=ck,
                                     checkpoint_every_steps=every)
        for i in range(7):
            state.step = i + 1
            maybe_checkpoint_step(tc, state, i)
        got = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
        assert got == want
    # no directory set: nothing is written
    maybe_checkpoint_step(port_config.TrainConfig(checkpoint_every_steps=1),
                          state, 0)
    assert sorted(os.listdir(ck)) == ["step_3", "step_6"]


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_kill_and_resume(small_graph, tmp_path, arch):
    g, ck = small_graph, str(tmp_path / "ck")
    whole = Trainer(_cfg(arch, g.num_classes, 2), g, device="cpu")
    want = whole.fit(log=lambda s: None)

    first = Trainer(_cfg(arch, g.num_classes, 1, ck), g, device="cpu")
    first.fit(log=lambda s: None)
    steps = first.plan.train_steps
    assert latest_checkpoint(ck) == os.path.join(ck, f"step_{steps}")

    # the first run is gone; a fresh trainer on the directory resumes
    resumed = Trainer(_cfg(arch, g.num_classes, 2, ck), g, device="cpu")
    assert (resumed.state.epoch, resumed.state.step) == (1, steps)
    for a, b in zip(resumed.model.parameters(), first.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(resumed.state.generator.get_state(),
                       first.state.generator.get_state())
    got = resumed.fit(log=lambda s: None)
    assert [h["epoch"] for h in got["history"]] == [1]
    assert got["history"][0]["losses"] == want["history"][1]["losses"]
    assert got["test_acc"] == want["test_acc"]
    assert latest_checkpoint(ck) == os.path.join(ck, f"step_{2 * steps}")
    # a finished run restarts nothing
    done = Trainer(_cfg(arch, g.num_classes, 2, ck), g, device="cpu")
    assert done.fit(log=lambda s: None)["history"] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_driver_kill_and_resume(small_graph, tmp_path, arch):
    g, ck = small_graph, str(tmp_path / "ck")
    want = run_cached_training(_cfg(arch, g.num_classes, 2, cached=True), g,
                               "cpu", log=lambda s: None)
    logs1 = []
    out1 = run_cached_training(
        _cfg(arch, g.num_classes, 1, ck, every=2, cached=True), g, "cpu",
        log=logs1.append)
    assert not any("resumed from checkpoint" in s for s in logs1)
    steps = out1["history"][0]["steps"]
    # mid-epoch saves every 2 steps, and the epoch's end
    assert sorted(os.listdir(ck), key=lambda d: int(d[5:])) == [
        f"step_{n}" for n in sorted({*range(2, steps + 1, 2), steps})]
    assert out1["history"][0]["losses"] == want["history"][0]["losses"]

    logs2 = []
    out2 = run_cached_training(_cfg(arch, g.num_classes, 2, ck, cached=True),
                               g, "cpu", log=logs2.append)
    assert any(f"resumed from checkpoint at step {steps}, epoch 1" in s
               for s in logs2)
    assert [r["epoch"] for r in out2["history"]] == [1]
    assert out2["history"][0]["losses"] == want["history"][1]["losses"]
    assert out2["history"][0]["valid"] == want["history"][1]["valid"]
    assert out2["test_acc"] == want["test_acc"]
    assert out2["state"].epoch == 2 and out2["state"].step == 2 * steps


def test_profile_dir_still_raises(small_graph, tmp_path):
    """``profile_dir`` now runs (``Trainer`` profiles epoch 0, the
    reference's only reader of it): a profiled run that checkpoints gives
    exactly the unprofiled run's losses, writes the trace, and a fresh
    trainer on its checkpoint resumes at epoch 1. (The name dates from
    when the setting was refused.)"""
    g = small_graph
    want = Trainer(_cfg("sage", g.num_classes, 1), g,
                   device="cpu").fit(log=lambda s: None)
    prof, ck = tmp_path / "p", str(tmp_path / "ck")
    cfg = _cfg("sage", g.num_classes, 1, ck)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, profile_dir=str(prof)))
    got = Trainer(cfg, g, device="cpu").fit(log=lambda s: None)
    assert got["history"][0]["losses"] == want["history"][0]["losses"]
    assert got["test_acc"] == want["test_acc"]
    assert (prof / "epoch_0.pt.trace.json").is_file()
    assert Trainer(cfg, g, device="cpu").state.epoch == 1
