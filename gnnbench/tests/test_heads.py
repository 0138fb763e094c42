"""A model with a head and a table too large to copy, on the CPU: the
reference hands a model one dropout mask per entry of ``model.layers``
(a test-only module with two entries past its last block), the observer
notes the rows of a head's entry called on them alone, the check gathers
each step's rows from the host table, and ``sizes.realized`` counts a
typed cell's rows by node type. Frozen copies of the parent's mask call,
row gather, readings and sizes hold every committed cell's numbers as
they were."""

from __future__ import annotations

import copy
import types
from unittest import mock

import numpy as np
import pytest
import torch

from gnnbench import check, graphgen, models, reference, run, sizes
from gnnbench.observe import Observer
from gnnbench.tests.conftest import SEED, tiny_cell
from gnnbench.tests.test_typed import MAG, _steps

HOMOGENEOUS = ["sage-products.b8000", "gat-products.b8000f10",
               "sage-papers100m.cache100"]
MODEL = {"learning_rate": 1e-3, "adam_betas": [0.9, 0.999],
         "adam_eps": 1e-8, "dropout": 0.5, "arch": "headed"}


# -- the parent's code, frozen ------------------------------------------------

def _frozen_drop_masks(step, layers, device):
    """``reference.drop_masks`` as the parent called it: one mask a
    block."""
    masks = [None] * layers
    for i, h in enumerate(step["h"][1:layers], start=1):
        if h is not None:
            masks[i - 1] = h.to(device) != 0
    return masks


def _frozen_row_faults(x, frontier, features):
    dev = features.device
    fr = frontier.to(dev).long()
    want = torch.zeros((fr.shape[0], x.shape[1]), dtype=x.dtype, device=dev)
    live = fr >= 0
    d = features.shape[1]
    want[live, :d] = features[fr[live]].to(x.dtype)
    return int((x.to(dev) != want).any(1).sum())


def _frozen_x(features, frontier, pad):
    """The rows ``follow`` built from the table copied to the device."""
    dev = features.device
    fr = frontier.to(dev).long()
    x = torch.zeros((fr.shape[0], pad), dtype=torch.float32, device=dev)
    live = fr >= 0
    x[live, :features.shape[1]] = features[fr[live]].float()
    return x


def _frozen_follow(steps, weights0, features, model, lowp=False,
                   keep_half=False):
    arch = models.module(model["arch"])
    dev = features.device
    params = {k: v.to(dev, torch.float32).clone() for k, v in weights0.items()}
    opt = reference.Adam(params, model["learning_rate"],
                         tuple(model["adam_betas"]), model["adam_eps"])
    keep = 1.0 - model["dropout"]
    losses, first_grad = [], None
    for step in steps:
        x = _frozen_x(features, step["frontier"], arch.in_width(params))
        blocks = [(b[0].to(dev).long(), b[1].to(dev)) for b in step["blocks"]]
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        logits = arch.logits(leaves, x, blocks,
                             _frozen_drop_masks(step, len(blocks), dev), keep,
                             lowp)
        num = int(step["num_seeds"])
        loss = reference.masked_ce(logits, step["labels"].to(dev),
                                   num // 2 if keep_half else num)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        params = opt.step(params, grads)
    return {"losses": losses, "first_grad": first_grad, "params": params}


def _frozen_readings(observer, setup, inputs, cell, device, dropped):
    """``check.readings`` as it was: the whole table copied to the
    device."""
    reference.no_tf32()
    model = cell["configuration"]["model"]
    dev = torch.device(device)
    graph = [None if a is None else torch.from_numpy(a).to(dev)
             for a in (inputs.indptr, inputs.indices, inputs.edge_rel,
                       inputs.node_type_offsets)]
    out = {"observed_steps": len(observer.steps),
           "sampler_faults": sum(reference.sampler_faults(s, *graph)
                                 for s in observer.steps),
           "dropped_rows": int(dropped)}
    feats = torch.from_numpy(inputs.features).to(dev)
    out["row_faults"] = sum(_frozen_row_faults(s["x"], s["frontier"], feats)
                            for s in observer.steps if s["x"] is not None)
    out["rows_checked_steps"] = sum(s["x"] is not None
                                    for s in observer.steps)
    ref = _frozen_follow(observer.steps, setup["weights"], feats, model)
    out.update(reference.compare(check.program_run(observer, setup, model),
                                 ref, setup["weights"]))
    return out


def _frozen_realized(steps, cell):
    """``sizes.realized`` as it was, for a homogeneous cell."""
    conf = cell["configuration"]
    n = max(len(steps), 1)

    def mean(f):
        return sum(f(s) for s in steps) / n

    blocks = []
    for k in range(len(steps[0]["blocks"]) if steps else 0):
        def blk(s, k=k):
            return s["blocks"][k]
        blocks.append({
            "slots": mean(lambda s: blk(s)[0].numel()),
            "valid": mean(lambda s: int(blk(s)[1].sum())),
            "distinct": mean(lambda s: int(torch.unique(
                blk(s)[0][blk(s)[1]]).numel())),
            "num_dst": mean(lambda s: blk(s)[3]),
            "num_src": mean(lambda s: blk(s)[2])})
    x = next((s["x"] for s in steps if s.get("x") is not None), None)
    return {"seeds": mean(lambda s: s["num_seeds"]),
            "hop1_rows": blocks[0]["num_src"] if blocks else 0.0,
            "frontier_rows": mean(lambda s: s["frontier"].numel()),
            "valid_rows": mean(lambda s: int((s["frontier"] >= 0).sum())),
            "blocks": blocks,
            "feature_dim": conf["feature_dim"],
            "num_classes": conf["num_classes"],
            "hidden_dim": conf["model"]["hidden_dim"],
            "row_itemsize": x.element_size() if x is not None else 4}


# -- the committed cells, run once each with both checks ---------------------

_RUNS = {}


def _observed(name):
    """Tiny cell ``name`` run on the CPU, its check made both ways: the
    observed steps, the inputs, both readings, and the masks each side
    handed the model's ``logits``, in call order (this PR's first)."""
    if name in _RUNS:
        return _RUNS[name]
    c = tiny_cell(name)
    arch = models.module(c["configuration"]["model"]["arch"])
    got = {"drops": []}
    orig_logits, orig_readings = arch.logits, check.readings

    def logits(weights, x, blocks, drop, *args, **kwargs):
        got["drops"].append(list(drop))
        return orig_logits(weights, x, blocks, drop, *args, **kwargs)

    def readings(observer, setup, inputs, cell, device, dropped,
                 control=False):
        # one thread: a threaded CPU reduction may differ in its last bit
        # from call to call, even for the same code
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            got["new"] = orig_readings(observer, setup, inputs, cell, device,
                                       dropped, control)
            got["old"] = _frozen_readings(observer, setup, inputs, cell,
                                          device, dropped)
        finally:
            torch.set_num_threads(threads)
        got.update(steps=observer.steps, inputs=inputs, cell=cell)
        return got["new"]
    with mock.patch.object(arch, "logits", logits), \
            mock.patch.object(check, "readings", readings):
        run.run_cell(c, SEED, 0.0, False, "cpu", [], c["limits"])
    _RUNS[name] = got
    return got


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.uint8)


@pytest.mark.parametrize("name", HOMOGENEOUS[:2])
def test_the_masks_are_the_parents(name):
    """SAGE (2 entries, 2 blocks) and GAT (3 and 3) get the masks the
    parent's one-a-block call gave, and at least one is a real mask."""
    drops = _observed(name)["drops"]
    steps = len(drops) // 2
    assert steps == run.OBSERVED_STEPS and len(drops) == 2 * steps
    for new, old in zip(drops[:steps], drops[steps:]):
        assert len(new) == len(old)
        for a, b in zip(new, old):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
    assert any(m is not None for d in drops for m in d)


@pytest.mark.parametrize("name", HOMOGENEOUS)
def test_host_rows_are_the_device_copys_bits(name):
    """Each observed step's rows gathered from the host table equal, bit
    for bit, those the parent gathered from the table copied whole: in
    the table's dtype, as ``follow``'s float32 rows and in the program's
    row dtype."""
    got = _observed(name)
    table = torch.from_numpy(got["inputs"].features)
    on_device = table.to("cpu", copy=True)        # the parent's whole copy
    for s in got["steps"]:
        fr = s["frontier"]
        rows = reference.frontier_rows(got["inputs"].features, fr, "cpu")
        live = fr.long() >= 0
        assert rows.dtype == table.dtype
        assert torch.equal(_bits(rows[live]),
                           _bits(on_device[fr.long()[live]]))
        assert not _bits(rows[~live]).any()
        pad = table.shape[1] + 3
        x = torch.zeros((rows.shape[0], pad))
        x[:, :rows.shape[1]] = rows.float()
        assert torch.equal(_bits(x), _bits(_frozen_x(on_device, fr, pad)))
        if s["x"] is not None:
            assert reference.row_faults(s["x"], fr, table, "cpu") == \
                _frozen_row_faults(s["x"], fr, on_device) == 0


@pytest.mark.parametrize("name", HOMOGENEOUS)
def test_the_readings_are_the_parents(name):
    """``check.readings`` reads the same numbers, exactly, as the
    parent's copy of it on one seed."""
    got = _observed(name)
    assert got["new"] == got["old"]
    assert got["new"]["observed_steps"] == run.OBSERVED_STEPS


@pytest.mark.parametrize("name", HOMOGENEOUS)
def test_homogeneous_sizes_are_the_parents(name):
    got = _observed(name)
    assert sizes.realized(got["steps"], got["cell"]) == \
        _frozen_realized(got["steps"], got["cell"])


def test_a_row_gather_moves_only_the_rows():
    """``frontier_rows`` over a numpy table indexes it where it is and
    hands back the rows alone, padding as zero rows."""
    table = np.arange(40, dtype=np.float16).reshape(10, 4)
    fr = torch.tensor([3, -1, 0, 9, -1], dtype=torch.int32)
    rows = reference.frontier_rows(table, fr, "cpu")
    assert rows.dtype == torch.float16 and rows.shape == (5, 4)
    assert torch.equal(rows[[0, 2, 3]], torch.from_numpy(table[[3, 0, 9]]))
    assert not rows[[1, 4]].any()


# -- a model with a head ------------------------------------------------------

def _dropped(h, mask, keep):
    return h if mask is None else torch.where(mask, h / keep,
                                              torch.zeros_like(h))


class _Headed(types.SimpleNamespace):
    """A test-only model of 4 entries over 2 blocks: per block ``h' =
    W_self h_dst + W_neigh mean(h_src[nbr])``, ELU and dropout (entries 0
    and 1), then a head: ``Linear``, ReLU and dropout (entry 2), and the
    ``Linear`` to the classes (entry 3); each call's masks noted."""

    def __init__(self):
        super().__init__(drops=[])

    def logits(self, weights, x, blocks, drop, keep, lowp=False):
        self.drops.append(list(drop))
        h = x
        n = len(blocks)
        for i in range(n):
            pos, mask = blocks[n - 1 - i]
            p = pos.shape[0]
            m = mask.to(h.dtype)
            rows = h[pos.reshape(-1)].reshape(p, pos.shape[1], -1)
            agg = (rows * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp(
                min=1.0)
            h = (h[:p] @ weights[f"layers.{i}.self.weight"].T
                 + agg @ weights[f"layers.{i}.neigh.weight"].T)
            h = _dropped(torch.nn.functional.elu(h), drop[i], keep)
        h = torch.relu(h @ weights[f"layers.{n}.weight"].T
                       + weights[f"layers.{n}.bias"])
        h = _dropped(h, drop[n], keep)
        return (h @ weights[f"layers.{n + 1}.weight"].T
                + weights[f"layers.{n + 1}.bias"])

    @staticmethod
    def in_width(weights):
        return weights["layers.0.self.weight"].shape[1]


HIDDEN, CLASSES = 8, 47        # the products cell's classes


def _headed_shapes(f):
    return {"layers.0.self.weight": (HIDDEN, f),
            "layers.0.neigh.weight": (HIDDEN, f),
            "layers.1.self.weight": (HIDDEN, HIDDEN),
            "layers.1.neigh.weight": (HIDDEN, HIDDEN),
            "layers.2.weight": (HIDDEN, HIDDEN), "layers.2.bias": (HIDDEN,),
            "layers.3.weight": (CLASSES, HIDDEN),
            "layers.3.bias": (CLASSES,)}


@pytest.fixture(scope="module")
def headed():
    """Two sampled steps of the tiny products graph, each with the rows a
    4-entry model would hand entries 1-3: a kept half of ones."""
    conf = tiny_cell("sage-products.b8000")["configuration"]
    inputs = graphgen.make_inputs(conf, SEED, "cpu")
    steps = _steps(inputs, conf, n=2, fanouts=(4, 3))
    gen = torch.Generator().manual_seed(SEED)
    for s in steps:
        outer, inner = (b[0].shape[0] for b in s["blocks"][::-1])
        s["h"] = [None] + [
            (torch.rand((p, HIDDEN), generator=gen) < 0.5).float()
            for p in (outer, inner, inner)]
    w0 = reference.initial_weights(_headed_shapes(conf["feature_dim"]), SEED,
                                   "cpu")
    return steps, w0, torch.from_numpy(inputs.features)


def _follow(headed, masks=reference.drop_masks):
    arch = _Headed()
    steps, w0, feats = headed
    with mock.patch.object(reference.models, "module", lambda name: arch), \
            mock.patch.object(reference, "drop_masks", masks):
        return arch, reference.follow(steps, w0, feats, MODEL)


def test_a_head_gets_a_mask_for_every_entry(headed):
    arch, ref = _follow(headed)
    steps = headed[0]
    assert len(arch.drops) == len(steps)
    for drop, s in zip(arch.drops, steps):
        assert len(drop) == 4 and drop[3] is None
        for i in range(3):
            assert torch.equal(drop[i], s["h"][i + 1] != 0)
    assert all(np.isfinite(ref["losses"]))


def _withheld(site):
    orig = reference.drop_masks

    def masks(step, layers, device):
        out = orig(step, layers, device)
        out[site] = None
        return out
    return masks


@pytest.mark.parametrize("site", range(3))
def test_a_withheld_mask_changes_the_loss(headed, site):
    """Each of the three dropout sites (after conv 0, after conv 1, in the
    head) moves the reference's loss: none may go unfollowed."""
    _, ref = _follow(headed)
    arch, cut = _follow(headed, _withheld(site))
    assert all(d[site] is None for d in arch.drops)
    assert all(abs(a - b) > 1e-4 * abs(b)
               for a, b in zip(cut["losses"], ref["losses"]))


class _Conv(torch.nn.Module):
    """A layer over a block, called ``(block, h)``."""

    def __init__(self, f, o):
        super().__init__()
        self.lin = torch.nn.Linear(f, o)

    def forward(self, block, h):
        return self.lin(h[:block])


class _HeadModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = torch.nn.ModuleList([_Conv(4, 6), _Conv(6, 6),
                                           torch.nn.Linear(6, 3)])

    def forward(self, blocks, x):
        h = x
        for layer, b in zip(self.layers, blocks):
            h = torch.relu(layer(b, h)) * 2
        return self.layers[2](h)


def test_the_observer_notes_a_head_entrys_rows():
    """A model whose last entry is called on its rows alone: the observer
    notes ``args[1]`` of each entry over a block and ``args[0]`` of the
    head's, and raises nothing."""
    model = _HeadModel()
    seen = {}
    for i, layer in enumerate(model.layers):
        layer.register_forward_pre_hook(
            lambda mod, args, i=i: seen.__setitem__(i, args[-1]))
    obs = Observer(steps=1)
    obs.watch_model(model)
    obs._live = {"eager": {}, "capture": {}}
    x = torch.randn(7, 4)
    model([5, 3], x)
    noted = obs._live["eager"]
    assert torch.equal(noted["x"], x)
    assert set(noted) == {"x", "h1", "h2"}
    assert torch.equal(noted["h1"], seen[1]) and noted["h1"].shape == (5, 6)
    assert torch.equal(noted["h2"], seen[2]) and noted["h2"].shape == (3, 6)


# -- rows by node type ----------------------------------------------------------

@pytest.fixture(scope="module")
def mag():
    inputs = graphgen.make_inputs(MAG, SEED, "cpu")
    return inputs, _steps(inputs, MAG, n=3)


def test_rows_by_type_against_a_count(mag):
    inputs, steps = mag
    cell = {"configuration": {**copy.deepcopy(MAG),
                              "model": {"hidden_dim": 8}}}
    got = sizes.realized(steps, cell)
    bounds = np.cumsum([0] + [t["num_nodes"] for t in MAG["node_types"]])

    def type_of(v):
        return next(t for t in range(3) if bounds[t] <= v < bounds[t + 1])

    for k, blk in enumerate(got["blocks"]):
        for key, col in (("src_by_type", 2), ("dst_by_type", 3)):
            want = [0] * 3
            for s in steps:
                for v in s["frontier"][:s["blocks"][k][col]].tolist():
                    if v >= 0:
                        want[type_of(v)] += 1
            assert blk[key] == [w / len(steps) for w in want], (k, key)
        assert sum(blk["dst_by_type"]) == blk["num_dst"]
    # the seeds are papers
    assert got["blocks"][0]["dst_by_type"][1:] == [0, 0]
    # each relation's types, read off the generated edges
    dst = np.repeat(np.arange(inputs.indptr.shape[0] - 1),
                    np.diff(inputs.indptr))
    want = []
    for r in range(len(MAG["relations"])):
        at = inputs.edge_rel == r
        want.append([type_of(int(inputs.indices[at][0])),
                     type_of(int(dst[at][0]))])
    assert got["relation_types"] == want == [[0, 0], [1, 0], [0, 1], [1, 2],
                                             [2, 1]]


def test_a_homogeneous_cell_counts_no_types(mag):
    conf = tiny_cell("sage-products.b8000")["configuration"]
    inputs = graphgen.make_inputs(conf, SEED, "cpu")
    steps = _steps(inputs, conf, n=1)
    got = sizes.realized(steps, {"configuration": conf})
    assert "relation_types" not in got
    assert all("src_by_type" not in b and "dst_by_type" not in b
               for b in got["blocks"])
