"""Typed graphs in the harness, on the CPU: the typed generator on a small
MAG240M-shaped schema (three node types, five relations), the schema's
refusals, each sampled slot's relation checked against the edge it names,
the ``TYPED`` keywords of the reference's forward, the normalisation's
scale in the initial weights, and the homogeneous configurations'
arrays and weights frozen as they were before typed graphs came."""

from __future__ import annotations

import copy
import math
import types
from unittest import mock

import numpy as np
import pytest
import torch

from gnnbench import cell as cells
from gnnbench import graphgen, reference, sizes
from gnnbench.drivers import graph_data
from gnnbench.models import gat, sage
from gnnbench.observe import Observer
from gnnbench.tests.conftest import SEED, tiny_cell, tiny_graph

# MAG240M's schema (OGB-LSC: papers, authors, institutions; writes and its
# reverse, affiliated-with and its reverse, cites made symmetric) at a size
# a CPU test holds; in-degrees as published but for the institutions'
MAG = {
    "name": "mag-shaped", "num_nodes": 2412, "feature_dim": 24,
    "feature_dtype": "float16", "num_classes": 7,
    "train_nodes": 300, "valid_nodes": 40, "test_nodes": 40,
    "node_types": [{"name": "paper", "num_nodes": 1200},
                   {"name": "author", "num_nodes": 1200},
                   {"name": "institution", "num_nodes": 12}],
    "relations": [
        {"name": "cites", "src": "paper", "dst": "paper",
         "avg_in_degree": 21.32, "zipf_alpha": 0.8},
        {"name": "writes", "src": "author", "dst": "paper",
         "avg_in_degree": 3.17, "zipf_alpha": 0.8},
        {"name": "written_by", "src": "paper", "dst": "author",
         "avg_in_degree": 3.15, "zipf_alpha": 0.8},
        {"name": "affiliated_with", "src": "author", "dst": "institution",
         "avg_in_degree": 40.0, "zipf_alpha": 0.8},
        {"name": "employs", "src": "institution", "dst": "author",
         "avg_in_degree": 0.364, "zipf_alpha": 0.8}],
}
HOMOGENEOUS = ["sage-products.b8000", "sage-papers100m.cache100",
               "gat-products.b8000f10"]


@pytest.fixture(scope="module")
def mag():
    return graphgen.make_inputs(MAG, SEED, "cpu")


def _type_of(offsets, ids):
    return np.searchsorted(offsets, ids, side="right") - 1


# -- the typed generator ------------------------------------------------------

def test_layout_and_dtypes(mag):
    off = mag.node_type_offsets
    assert off.dtype == np.int64 and off.tolist() == [0, 1200, 2400, 2412]
    assert mag.indptr.dtype == np.int64 and mag.indptr.shape == (2413,)
    assert mag.indices.dtype == np.int32
    assert mag.edge_rel.dtype == np.uint8
    assert mag.edge_rel.shape == mag.indices.shape == (mag.indptr[-1],)
    assert mag.features.dtype == np.float16
    assert mag.features.shape == (2412, 24)
    assert np.isfinite(mag.features).all() and mag.features.std() > 0.5
    assert mag.labels.shape == (2412,) and mag.labels.max() < 7


def test_each_relation_joins_its_own_types(mag):
    off = mag.node_type_offsets
    names = [t["name"] for t in MAG["node_types"]]
    dst = np.repeat(np.arange(2412), np.diff(mag.indptr))
    for k, r in enumerate(MAG["relations"]):
        at = mag.edge_rel == k
        assert at.any(), r["name"]
        assert (_type_of(off, dst[at]) == names.index(r["dst"])).all()
        assert (_type_of(off, mag.indices[at]) ==
                names.index(r["src"])).all()
    assert mag.edge_rel.max() < len(MAG["relations"])


def test_a_rows_edges_are_grouped_in_relation_order(mag):
    rel = mag.edge_rel.astype(np.int64)
    step = np.diff(rel)
    inside = np.ones(step.shape, bool)
    inside[mag.indptr[1:-1][mag.indptr[1:-1] > 0] - 1] = False
    assert (step[inside] >= 0).all()


def test_mean_in_degree_by_relation(mag):
    sizes_ = {t["name"]: t["num_nodes"] for t in MAG["node_types"]}
    for k, r in enumerate(MAG["relations"]):
        n = sizes_[r["dst"]]
        mean = (mag.edge_rel == k).sum() / n
        sigma = math.sqrt(r["avg_in_degree"] / n)
        assert abs(mean - r["avg_in_degree"]) < 5 * sigma, (r["name"], mean)


def test_splits_come_from_the_labelled_type(mag):
    ids = np.concatenate([mag.train_ids, mag.valid_ids, mag.test_ids])
    assert [len(a) for a in (mag.train_ids, mag.valid_ids,
                             mag.test_ids)] == [300, 40, 40]
    assert ids.min() >= 0 and ids.max() < mag.node_type_offsets[1]
    assert len(np.unique(ids)) == len(ids)


def test_the_same_seed_gives_the_same_bytes(mag):
    again = graphgen.make_inputs(MAG, SEED, "cpu")
    other = graphgen.make_inputs(MAG, SEED + 1, "cpu")
    for k in ("indptr", "indices", "edge_rel", "node_type_offsets",
              "features", "labels", "train_ids", "valid_ids", "test_ids"):
        assert getattr(again, k).tobytes() == getattr(mag, k).tobytes(), k
    assert other.indices.tobytes() != mag.indices.tobytes()


# -- the homogeneous configurations, as before ------------------------------

def _frozen_make_inputs(graph: dict, seed: int, device):
    """``graphgen.make_inputs`` as it was before typed graphs came."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = int(graph["num_nodes"])
    f = int(graph["feature_dim"])
    rate = torch.full((n,), float(graph["avg_in_degree"]),
                      dtype=torch.float32, device=dev)
    counts = torch.poisson(rate, generator=gen).to(torch.int64)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=indptr[1:])
    e = int(indptr[-1])
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks.pow_(-float(graph["zipf_alpha"])), 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    indices = np.empty(e, np.int32)
    for s in range(0, e, graphgen.EDGE_CHUNK):
        m = min(graphgen.EDGE_CHUNK, e - s)
        u = torch.rand(m, dtype=torch.float64, generator=gen, device=dev)
        pos = torch.searchsorted(cdf, u).clamp_(max=n - 1)
        torch.from_numpy(indices[s:s + m]).copy_(perm[pos])
    features = np.empty((n, f), np.float32)
    for s in range(0, n, graphgen.ROW_CHUNK):
        m = min(graphgen.ROW_CHUNK, n - s)
        torch.from_numpy(features[s:s + m]).copy_(
            torch.randn((m, f), generator=gen, device=dev))
    labels = torch.randint(0, int(graph["num_classes"]), (n,),
                           generator=gen, device=dev, dtype=torch.int32)
    t, v, s_ = (int(graph[k]) for k in
                ("train_nodes", "valid_nodes", "test_nodes"))
    ids = torch.randperm(n, generator=gen, device=dev)[:t + v + s_].to(
        torch.int32).cpu().numpy()
    return dict(indptr=indptr.cpu().numpy(), indices=indices,
                features=features, labels=labels.cpu().numpy(),
                train_ids=ids[:t], valid_ids=ids[t:t + v],
                test_ids=ids[t + v:])


@pytest.mark.parametrize("name", HOMOGENEOUS)
def test_homogeneous_arrays_are_as_before(name):
    conf = tiny_cell(name)["configuration"]
    got = graphgen.make_inputs(conf, SEED, "cpu")
    want = _frozen_make_inputs(conf, SEED, "cpu")
    for k, v in want.items():
        a = getattr(got, k)
        assert a.dtype == v.dtype and a.tobytes() == v.tobytes(), k
    assert got.edge_rel is None and got.node_type_offsets is None


def _frozen_initial_weights(shapes, seed, device):
    """``reference.initial_weights`` as it was before typed graphs came."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    flat = torch.randn(sum(math.prod(s) for s in mats.values()),
                       generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if len(s) == 2:
            n = math.prod(s)
            out[k] = flat[at:at + n].reshape(s) / math.sqrt(s[1])
            at += n
        else:
            out[k] = torch.zeros(s, device=device)
    return out


SAGE_SHAPES = {"layers.0.fc_self.weight": (256, 128),
               "layers.0.fc_self.bias": (256,),
               "layers.0.fc_neigh.weight": (256, 128),
               "layers.1.fc_self.weight": (47, 256),
               "layers.1.fc_self.bias": (47,),
               "layers.1.fc_neigh.weight": (47, 256)}
GAT_SHAPES = {f"layers.{i}.{k}": s for i, (w, o, h) in
              enumerate([(128, 128, 4), (512, 128, 4), (512, 47, 4)])
              for k, s in (("lin.weight", (h * o, w)), ("att_src", (h, o)),
                           ("att_dst", (h, o)), ("bias", (h * o if i < 2
                                                          else o,)),
                           ("skip.weight", (h * o if i < 2 else o, w)),
                           ("skip.bias", (h * o if i < 2 else o,)))}


@pytest.mark.parametrize("shapes", [SAGE_SHAPES, GAT_SHAPES],
                         ids=["sage", "gat"])
def test_initial_weights_are_as_before(shapes):
    got = reference.initial_weights(shapes, SEED, "cpu")
    want = _frozen_initial_weights(shapes, SEED, "cpu")
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_a_normalisations_scale_starts_at_one():
    shapes = {"layers.0.lin.weight": (4, 3), "norms.0.weight": (4,),
              "norms.0.bias": (4,), "layers.0.bias": (4,)}
    w = reference.initial_weights(shapes, SEED, "cpu")
    assert torch.equal(w["norms.0.weight"], torch.ones(4))
    assert torch.equal(w["norms.0.bias"], torch.zeros(4))
    assert torch.equal(w["layers.0.bias"], torch.zeros(4))
    # the matrices are drawn as before: vectors take no draws
    assert torch.equal(w["layers.0.lin.weight"], _frozen_initial_weights(
        shapes, SEED, "cpu")["layers.0.lin.weight"])


# -- the schema's refusals ----------------------------------------------------

def _mag(**change):
    conf = copy.deepcopy(MAG)
    for k, fn in change.items():
        fn(conf)
    return conf


BAD = {
    "is not the node types' sum": _mag(
        n=lambda c: c.update(num_nodes=2413)),
    "unknown src type": _mag(
        r=lambda c: c["relations"][1].update(src="venue")),
    "unknown dst type": _mag(
        r=lambda c: c["relations"][4].update(dst="venue")),
    "share the \\(src, dst\\) types": _mag(
        r=lambda c: c["relations"].append(dict(
            c["relations"][0], name="cited_by"))),
    "more than 127": _mag(
        r=lambda c: c.update(relations=[
            {"name": f"r{i}", "src": "paper", "dst": "paper",
             "avg_in_degree": 1.0, "zipf_alpha": 0.8}
            for i in range(128)])),
    "feature_dtype 'bfloat16'": _mag(
        d=lambda c: c.update(feature_dtype="bfloat16")),
    "needs both node_types and relations": _mag(
        r=lambda c: c.pop("relations")),
    "node type names .* repeat": _mag(
        t=lambda c: c["node_types"][2].update(name="author")),
}


@pytest.mark.parametrize("fault", sorted(BAD))
def test_an_invalid_schema_is_refused(fault):
    with pytest.raises(ValueError, match=fault):
        cells.check_schema(BAD[fault])


def test_every_committed_configuration_loads():
    cells.check_schema(MAG)
    for w in cells.benchmark()["workloads"]:
        conf = cells.load_cell(w["name"])["configuration"]
        assert "node_types" not in conf and "relations" not in conf


def test_load_cell_checks_the_schema():
    bad = BAD["is not the node types' sum"]
    orig = cells.load_json

    def load(*parts):
        return copy.deepcopy(bad) if parts[0] == "configs" else orig(*parts)
    with mock.patch.object(cells, "load_json", load), \
            pytest.raises(ValueError, match="node types' sum"):
        cells.load_cell("sage-products.b8000")


def test_tiny_graph_keeps_each_types_share():
    conf = copy.deepcopy(MAG)
    conf["node_types"][0]["num_nodes"] = 15_218_958
    conf["node_types"][1]["num_nodes"] = 15_297_889
    conf["node_types"][2]["num_nodes"] = 3_215
    conf["num_nodes"] = 15_218_958 + 15_297_889 + 3_215
    conf["relations"][3]["avg_in_degree"] = 1733.7
    tiny_graph(conf)
    assert [t["num_nodes"] for t in conf["node_types"]] == [1496, 1504, 8]
    assert conf["num_nodes"] == 3008
    assert max(r["avg_in_degree"] for r in conf["relations"]) == 8.0
    assert conf["relations"][4]["avg_in_degree"] == 0.364
    cells.check_schema(conf)
    inputs = graphgen.make_inputs(conf, SEED, "cpu")
    assert inputs.node_type_offsets[-1] == 3008
    assert inputs.train_ids.max() < 1496


# -- the sampled slots' relations ---------------------------------------------

def _relation_of_types(conf):
    """(T, T) int64: the relation from src type to dst type, -1 for none."""
    names = [t["name"] for t in conf["node_types"]]
    table = torch.full((len(names), len(names)), -1, dtype=torch.int64)
    for k, r in enumerate(conf["relations"]):
        table[names.index(r["src"]), names.index(r["dst"])] = k
    return table


def _steps(inputs, conf, n=2, fanouts=(4, 3), batch=32, dedup=True):
    """``n`` steps of the port's sampler over ``inputs`` in the observer's
    layout; on a typed graph each slot's relation read from its two
    endpoints' types."""
    from legion_tpu_torch.sampling.block import frontier_caps
    from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
    graph = DeviceGraph.from_host(inputs.indptr, inputs.indices,
                                  torch.device("cpu"))
    off = inputs.node_type_offsets
    table = None if off is None else _relation_of_types(conf)
    caps = frontier_caps(batch, fanouts)
    if not dedup:
        caps = caps[:-1] + (caps[-2] * (1 + fanouts[-1]),)
    out = []
    for i in range(n):
        ids = inputs.train_ids[i * batch:(i + 1) * batch]
        seeds = torch.from_numpy(ids.astype(np.int32))
        b = sample_batch(graph, seeds, torch.tensor(batch, dtype=torch.int32),
                         torch.from_numpy(inputs.labels[ids]), fanouts, caps,
                         dedup_last=dedup,
                         generator=torch.Generator().manual_seed(SEED + i))
        fr = b.frontier.long()
        rels = []
        for k in b.blocks:
            if table is None:
                rels.append(None)
                continue
            t = torch.from_numpy(_type_of(off, fr.clamp(min=0).numpy()))
            src = t[k.nbr_pos.long()]
            dst = t[:k.nbr_pos.shape[0], None].expand_as(src)
            rels.append(torch.where(k.nbr_mask, table[src, dst], 0).to(
                torch.uint8))
        out.append({
            "seeds": b.seeds, "labels": b.labels,
            "num_seeds": int(b.num_seeds), "frontier": b.frontier,
            "num_frontier": int(b.num_frontier),
            "blocks": [(k.nbr_pos, k.nbr_mask, int(k.num_src),
                        int(k.num_dst), k.identity_offset) for k in b.blocks],
            "rels": rels, "h": [None] * len(fanouts), "x": None})
    return out


def _graph(inputs):
    return [None if a is None else torch.from_numpy(a) for a in
            (inputs.indptr, inputs.indices, inputs.edge_rel,
             inputs.node_type_offsets)]


@pytest.fixture(scope="module")
def typed_steps(mag):
    return _steps(mag, MAG)


def test_a_sound_typed_step_has_no_fault(mag, typed_steps):
    for s in typed_steps:
        assert reference.sampler_faults(s, *_graph(mag)) == 0
        assert {int(v) for r, (_, m, *_) in zip(s["rels"], s["blocks"])
                for v in r[m]} <= set(range(5))


def test_one_flipped_relation_is_one_fault(mag, typed_steps):
    s = copy.deepcopy(typed_steps[0])
    pos, mask = s["blocks"][1][:2]
    d, j = (int(v[0]) for v in torch.nonzero(mask, as_tuple=True))
    s["rels"][1][d, j] = (int(s["rels"][1][d, j]) + 1) % 5
    assert reference.sampler_faults(s, *_graph(mag)) == 1


def test_missing_relations_count_every_live_row(mag, typed_steps):
    s = dict(typed_steps[0])
    live = sum(b[3] for b in s["blocks"])
    assert reference.sampler_faults(dict(s, rels=None), *_graph(mag)) == live
    one = [None] + s["rels"][1:]
    assert reference.sampler_faults(dict(s, rels=one), *_graph(mag)) == \
        s["blocks"][0][3]


def test_a_seed_outside_the_labelled_type_is_a_fault(mag):
    inputs = copy.copy(mag)
    # one author in the seeds: the port samples it as any other row
    inputs.train_ids = np.concatenate([[1500], mag.train_ids[1:]]).astype(
        np.int32)
    s = _steps(inputs, MAG, n=1)[0]
    assert reference.sampler_faults(s, *_graph(mag)) == 1
    assert reference.sampler_faults(s, *_graph(mag)[:3]) == 0


@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "appended"])
def test_homogeneous_steps_count_as_before(dedup):
    conf = tiny_cell("sage-products.b8000")["configuration"]
    inputs = graphgen.make_inputs(conf, SEED, "cpu")
    s = _steps(inputs, conf, n=1, dedup=dedup)[0]
    g = _graph(inputs)
    assert g[2] is None and g[3] is None
    assert reference.sampler_faults(s, *g) == 0
    assert reference.sampler_faults(dict(s, rels=None), *g) == 0
    bad = copy.deepcopy(s)
    pos, mask = bad["blocks"][0][:2]
    d, j = (int(v[0]) for v in torch.nonzero(mask, as_tuple=True))
    v = int(bad["frontier"][d])
    row = inputs.indices[inputs.indptr[v]:inputs.indptr[v + 1]]
    stranger = next(u for u in range(conf["num_nodes"]) if u not in row)
    bad["frontier"][int(pos[d, j])] = stranger
    assert reference.sampler_faults(bad, *g) >= 1


def test_sizes_count_valid_slots_by_relation(typed_steps):
    cell = {"configuration": {**MAG, "model": {"hidden_dim": 8}}}
    got = sizes.realized(typed_steps, cell)
    for k, blk in enumerate(got["blocks"]):
        assert len(blk["valid_by_rel"]) == 5
        assert sum(blk["valid_by_rel"]) == pytest.approx(blk["valid"])
        want = [sum(int((s["rels"][k][s["blocks"][k][1]] == r).sum())
                    for s in typed_steps) / len(typed_steps)
                for r in range(5)]
        assert blk["valid_by_rel"] == want
    homo = [dict(s, rels=[None, None]) for s in typed_steps]
    assert all("valid_by_rel" not in b
               for b in sizes.realized(homo, cell)["blocks"])


# -- the seams into the program ---------------------------------------------

def test_the_observer_copies_each_blocks_relations():
    def block(rel):
        b = types.SimpleNamespace(
            nbr_pos=torch.zeros((2, 3), dtype=torch.int32),
            nbr_mask=torch.ones((2, 3), dtype=torch.bool),
            num_src=torch.tensor(4), num_dst=torch.tensor(2),
            identity_offset=None)
        if rel is not None:
            b.nbr_rel = rel
        return b
    rel = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    batch = types.SimpleNamespace(
        seeds=torch.arange(2), labels=torch.zeros(2),
        num_seeds=torch.tensor(2), frontier=torch.arange(4),
        num_frontier=torch.tensor(4),
        blocks=[block(rel), block(None)])
    obs = Observer(steps=1)
    model = torch.nn.Module()
    model.layers = torch.nn.ModuleList([torch.nn.Linear(2, 2)] * 2)
    obs.model = model
    obs.optimizer = types.SimpleNamespace(state={})
    obs._take({"batch": batch})
    got = obs.steps[0]["rels"]
    assert torch.equal(got[0], rel) and got[0] is not rel
    assert got[1] is None


def test_graph_data_hands_the_typed_arrays_only_when_present(mag):
    from legion_tpu_torch.data import format as fmt
    homo = graphgen.make_inputs(tiny_cell("sage-products.b8000")[
        "configuration"], SEED, "cpu")
    assert isinstance(graph_data(homo), fmt.GraphData)
    with mock.patch.object(fmt, "GraphData") as made:
        graph_data(mag)
    kw = made.call_args.kwargs
    assert kw["edge_rel"] is mag.edge_rel
    assert kw["node_type_offsets"] is mag.node_type_offsets


class _Typed(types.SimpleNamespace):
    """A test-only relational model: per layer ``h' = W_self h_dst +
    sum_r W_r mean_r(h_src)``, then a normalisation over the live dst rows
    (scale ``norms.<i>.weight``, shift ``norms.<i>.bias``); each call's
    keywords noted."""
    TYPED = True

    def __init__(self, rels):
        super().__init__(calls=[], rels=rels)

    def logits(self, weights, x, blocks, drop, keep, lowp=False, *, rels,
               num_dst):
        self.calls.append((rels, num_dst))
        h = x
        n = len(blocks)
        for i in range(n):
            pos, mask = blocks[n - 1 - i]
            rel, live = rels[n - 1 - i], num_dst[n - 1 - i]
            p = pos.shape[0]
            rows = h[pos.reshape(-1)].reshape(p, pos.shape[1], -1)
            out = h[:p] @ weights[f"layers.{i}.self.weight"].T
            for r in range(self.rels):
                m = (mask & (rel == r)).to(h.dtype)
                agg = (rows * m[..., None]).sum(1) / m.sum(
                    1, keepdim=True).clamp(min=1.0)
                out = out + agg @ weights[f"layers.{i}.rel.{r}.weight"].T
            mu = out[:live].mean(0)
            sd = out[:live].var(0, unbiased=False).add(1e-5).sqrt()
            h = ((out - mu) / sd * weights[f"norms.{i}.weight"]
                 + weights[f"norms.{i}.bias"])
            if i != n - 1:
                h = torch.relu(h)
        return h

    @staticmethod
    def in_width(weights):
        return weights["layers.0.self.weight"].shape[1]


def _typed_shapes(f, hidden, classes, rels, layers=2):
    out = {}
    for i in range(layers):
        w, o = (f if i == 0 else hidden), (classes if i == layers - 1
                                           else hidden)
        out[f"layers.{i}.self.weight"] = (o, w)
        for r in range(rels):
            out[f"layers.{i}.rel.{r}.weight"] = (o, w)
        out[f"norms.{i}.weight"] = (o,)
        out[f"norms.{i}.bias"] = (o,)
    return out


MODEL = {"learning_rate": 1e-3, "adam_betas": [0.9, 0.999],
         "adam_eps": 1e-8, "dropout": 0.0}


def test_follow_hands_a_typed_module_rels_and_num_dst(mag, typed_steps):
    arch = _Typed(rels=5)
    w0 = reference.initial_weights(_typed_shapes(24, 16, 7, 5), SEED, "cpu")
    feats = torch.from_numpy(mag.features)
    with mock.patch.object(reference.models, "module", lambda name: arch):
        ref = reference.follow(typed_steps, w0, feats,
                               {**MODEL, "arch": "rgat"})
    assert len(arch.calls) == len(typed_steps)
    for (rels, num_dst), s in zip(arch.calls, typed_steps):
        assert num_dst == [b[3] for b in s["blocks"]]
        for got, want in zip(rels, s["rels"]):
            assert got.dtype == torch.int64 and torch.equal(got, want.long())
    assert all(math.isfinite(v) and v > 0 for v in ref["losses"])
    # the scales start at one, so the first layer's product gets a
    # gradient (a scale of zero would leave every layer's rows constant)
    for k in ("layers.0.self.weight", "norms.0.weight", "norms.1.bias"):
        assert float(ref["first_grad"][k].abs().sum()) > 0, k


@pytest.mark.parametrize("arch", [sage, gat], ids=["sage", "gat"])
def test_follow_hands_other_modules_nothing_more(arch):
    conf = tiny_cell("sage-products.b8000")["configuration"]
    inputs = graphgen.make_inputs(conf, SEED, "cpu")
    steps = _steps(inputs, conf, n=1,
                   fanouts=(4, 3) if arch is sage else (4, 3, 2))
    w0 = reference.initial_weights(
        SAGE_SHAPES if arch is sage else GAT_SHAPES, SEED, "cpu")
    seen = []
    orig = arch.logits

    def noted(*args, **kwargs):
        seen.append(kwargs)
        return orig(*args, **kwargs)
    feats = torch.from_numpy(inputs.features)
    with mock.patch.object(arch, "logits", noted):
        reference.follow(steps, w0, feats, {**MODEL, "arch": arch.__name__
                                            .rsplit(".", 1)[1]})
    assert seen == [{}]
