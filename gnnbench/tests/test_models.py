"""The architecture seam: the reference's forward is the configuration's
model module's, it follows every layer's dropout mask, and each key of a
configuration's ``model`` reaches the port or the harness."""

from __future__ import annotations

import json
import os
from unittest import mock

import pytest

from gnnbench import cell as cells
from gnnbench import counting, models, reference, run
from gnnbench.models import sage
from gnnbench.tests.conftest import SEED, tiny_cell


def _run(name):
    c = tiny_cell(name)
    return run.run_cell(c, SEED, 0.0, False, "cpu", [], c["limits"])


def test_a_withheld_first_mask_is_not_correct():
    """With layer 0's mask left out of the reference, as when only the
    last layer's input was noted, the 3-layer cell fails: its passing run
    follows that mask."""
    orig = reference.drop_masks

    def withheld(step, layers, device):
        return [None] + orig(step, layers, device)[1:]
    with mock.patch.object(reference, "drop_masks", withheld):
        res = _run("sage-products.b8000.3layers")
    assert not res["correct"], res["checks"]


def test_a_forward_without_the_self_path_is_not_correct():
    """The reference takes its forward from the model module: one that
    drops ``W_self h_dst + b`` fails the 2-layer cell."""
    orig = sage.logits

    def no_self(weights, x, blocks, drop, keep, lowp=False):
        w = {k: v * 0 if ".fc_self." in k else v for k, v in weights.items()}
        return orig(w, x, blocks, drop, keep, lowp)
    with mock.patch.object(sage, "logits", no_self):
        res = _run("sage-products.b8000")
    assert not res["correct"], res["checks"]


def test_an_unknown_arch_raises():
    with pytest.raises(ValueError, match="nope.py"):
        models.module("nope")


def test_sage_counts_two_layers_only():
    sizes = {"seeds": 4.2, "hop1_rows": 9.4, "hidden_dim": 6,
             "feature_dim": 5, "num_classes": 3}
    assert sage.flops(sizes, {"num_layers": 2}) == \
        counting.sage_flops(4, 9, 6, 5, 3)
    assert sage.flops(sizes, {"num_layers": 3}) is None


@pytest.mark.parametrize("name", sorted(os.listdir(
    os.path.join(cells.HERE, "configs"))))
def test_configuration_model_keys_are_known(name):
    """Each key of a configuration's ``model`` is a field of the port's
    ``ModelConfig`` or one the harness reads itself, and names a module
    here: a misspelt key fails here before a card run."""
    with open(os.path.join(cells.HERE, "configs", name)) as f:
        model = json.load(f)["model"]
    known = set(cells.model_keys()) | set(cells.HARNESS_MODEL_KEYS)
    assert set(model) <= known, sorted(set(model) - known)
    assert models.module(model["arch"]) is not None


def test_port_config_refuses_an_unknown_model_key():
    c = tiny_cell("sage-products.b8000")
    c["configuration"]["model"]["num_head"] = 4
    with pytest.raises(ValueError, match="num_head"):
        cells.port_config(c, SEED, 1)
