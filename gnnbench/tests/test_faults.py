"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, a tiny cell driven on the CPU, one
fault planted in the port at a time (a single card exchanges nothing, so
the exchange fault does not arise)."""

from __future__ import annotations

import contextlib
import sys
from unittest import mock

import pytest
import torch

from gnnbench import run
from gnnbench.tests.conftest import SEED, tiny_cell

CELLS = ["sage-products.b8000", "sage-papers100m.cache15",
         "sage-products.b8000.3layers"]


def _run(name):
    c = tiny_cell(name)
    return run.run_cell(c, SEED, 0.2, False, "cpu", [], c["limits"])


def _unchanged_state():
    """The optimizer's step leaves the state as it was."""
    return mock.patch.object(torch.optim.Adam, "step",
                             lambda self, closure=None: None)


def _half_batch():
    """The loss's mean over the first half of the valid seeds only."""
    from legion_tpu_torch.train import loop
    orig = loop.masked_softmax_ce

    def half(logits, labels, mask):
        keep = torch.arange(mask.shape[0], device=mask.device) < \
            mask.sum() // 2
        return orig(logits, labels, mask & keep)
    return mock.patch.object(loop, "masked_softmax_ce", half)


def _altered_row():
    """The row gather returns one row altered."""
    from legion_tpu_torch.ops import gather
    orig = gather.gather_rows

    def altered(table, ids):
        out = orig(table, ids).clone()
        out[1] += 1
        return out
    return _patch_everywhere("gather_rows", altered)


def _altered_neighbour():
    """The sampling kernel names a node that is no neighbour in one
    slot."""
    from legion_tpu_torch.sampling import sampler
    orig = sampler.sample_kernel

    def altered(indptr, indices, frontier, u):
        out = orig(indptr, indices, frontier, u).clone()
        out[0, 0] = (frontier[0] + 1) % (indptr.shape[0] - 1)
        return out
    return mock.patch.object(sampler, "sample_kernel", altered)


def _patch_everywhere(attr, fn):
    """The row gather's ``attr`` replaced in every port module that
    imported it."""
    stack = contextlib.ExitStack()
    for name, mod in list(sys.modules.items()):
        if name.startswith("legion_tpu_torch") and \
                getattr(mod, attr, None) is not None and \
                getattr(getattr(mod, attr), "__module__", "") == \
                "legion_tpu_torch.ops.gather":
            stack.enter_context(mock.patch.object(mod, attr, fn))
    return stack


FAULTS = {"unchanged_state": (_unchanged_state, "change_gap"),
          "half_batch": (_half_batch, "loss_gap"),
          "altered_row": (_altered_row, "row_faults"),
          "altered_neighbour": (_altered_neighbour, "sampler_faults")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    import legion_tpu_torch.cache.feature_cache  # noqa: F401 (patched)
    import legion_tpu_torch.train.loop  # noqa: F401
    plant, number = FAULTS[fault]
    with plant():
        res = _run(name)
    assert not res["correct"], res["checks"]
    value, limit = res["checks"][number]
    assert value > limit, (number, value, limit)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in float8 in the program's place fails a limit."""
    c = tiny_cell(name)
    res = run.run_cell(c, SEED, 0.0, False, "cpu", [], c["limits"],
                       control=True)
    assert res["correct"]
    ctl = {k.split(".", 1)[1]: v for k, v in res["readings"].items()
           if k.startswith("control.") and k.split(".", 1)[1] in c["limits"]}
    assert any(ctl[k] > c["limits"][k] for k in ctl), (ctl, c["limits"])
