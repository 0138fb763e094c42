"""Port parity past edge 2^31 (the twin of ``tests/test_bigcsr.py``): every
component of ``legion_tpu_torch`` that touches the host CSR addresses it in
int64, against ``legion_tpu`` on the same sparse memmap.

The indices file is sparse (only the touched pages exist on disk), so a
run sits just past int32 (``past-2^31``) and at the tail of a uk2014-sized
file (``uk2014-tail``: a 176 GB logical file occupying a few KB) without
a billion-edge array. Each case runs the port's function on it and,
where ``legion_tpu`` has the function, compares the output with it:
the C++ and numpy cold samplers bitwise, ``TopoCache.build``,
``StripedTopoCache.build`` at 2 gloo ranks, ``presample_hotness_host``,
the streaming generator's files byte for byte, ``solve_cost_model``,
``make_seed_plan`` and ``frontier_caps``, the presample's int32
counters, and ``sum_edge_counts``. Then the hybrid driver end to end on a
3000-node graph whose every real adjacency run starts past edge 2^31
(``tools/scale.py::holed_twins``), against the reference's driver on the
same memmap: float32, dropout 0, the reference's weights and device
uniforms, each epoch's loss within rtol 1e-4 / atol 1e-5 and the eval
accuracy equal.

JAX and ``legion_tpu`` are imported inside the tests, so that the gloo
ranks, which import this module by name, load neither."""

import dataclasses
import json
import os
import tempfile
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from legion_tpu_torch import config as port_config
from legion_tpu_torch import runtime
from legion_tpu_torch.cache.cost_model import solve_cost_model
from legion_tpu_torch.cache.hotness import presample_hotness
from legion_tpu_torch.cache.hybrid import HybridTrainer
from legion_tpu_torch.cache.striped import StripedTopoCache
from legion_tpu_torch.cache.topo_cache import TopoCache, host_sample_cold
from legion_tpu_torch.data import format as port_format
from legion_tpu_torch.data import synthetic as port_synthetic
from legion_tpu_torch.parallel import mesh
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import DeviceGraph
from legion_tpu_torch.sampling.seeds import make_seed_plan
from legion_tpu_torch.tools import scale
from legion_tpu_torch.train import hybrid_driver as port_driver
from legion_tpu_torch.train.loop import sum_edge_counts

torch.set_num_threads(2)

UKL_EDGES = port_config.DATASET_REGISTRY["UKL"].num_edges  # 47.3B > 2^35
N = 1024
DEG = 16
CASES = {"past-2^31": 2 ** 31 + 512, "uk2014-tail": UKL_EDGES - DEG}


def _write_case(d, e_far):
    """(indptr, indices path) of ``tests/test_bigcsr.py``'s layout: node
    0's run at [0, 16), node N-1's at [E_FAR, E_FAR+16), every other node
    of degree 0. A filesystem that writes holes out fails here before the
    hole is written."""
    assert scale.hole_bytes(d) < scale.HOLE_PROBE, \
        "these cases need a filesystem that keeps holes unwritten"
    indptr = np.zeros(N + 1, np.int64)
    indptr[1:] = DEG
    indptr[N] = e_far + DEG
    indptr[N - 1] = e_far
    fp = os.path.join(d, "indices.bin")
    with open(fp, "wb") as f:
        (np.arange(DEG, dtype=np.int32) + 100).tofile(f)
        f.seek(e_far * 4)                        # sparse hole
        (np.arange(DEG, dtype=np.int32) + 900).tofile(f)
        f.truncate((e_far + DEG) * 4)
    assert os.stat(fp).st_blocks * 512 < 1 << 20, "file must stay sparse"
    return indptr, fp


def _map(fp, total):
    return np.memmap(fp, dtype=np.int32, mode="r", shape=(total,))


@pytest.fixture(scope="module")
def case_files(tmp_path_factory):
    out = {}
    for name, e_far in CASES.items():
        indptr, fp = _write_case(str(tmp_path_factory.mktemp("bigcsr")),
                                 e_far)
        out[name] = (indptr, fp)
    return out


@pytest.fixture(scope="module", params=list(CASES))
def big_csr(request, case_files):
    indptr, fp = case_files[request.param]
    return indptr, _map(fp, int(indptr[-1]))


FAR, NEAR = set(range(900, 900 + DEG)), set(range(100, 100 + DEG))


def test_runtime_sampler_beyond_2_31(big_csr):
    """The threaded C++ host sampler reads runs past edge 2^31: bitwise
    the reference's draws."""
    from legion_tpu import runtime as jax_runtime
    indptr, indices = big_csr
    ids = np.array([0, N - 1, -1], np.int32)
    out = runtime.sample_neighbors(indptr, indices, ids, DEG, seed=3)
    np.testing.assert_array_equal(out, jax_runtime.sample_neighbors(
        indptr, indices, ids, DEG, seed=3))
    assert set(out[0]) <= NEAR and set(out[1]) <= FAR, out[1]
    assert (out[2] == -1).all()


def test_numpy_cold_sampler_beyond_2_31(big_csr):
    from legion_tpu.cache.topo_cache import host_sample_cold as jax_cold
    indptr, indices = big_csr
    ids = np.array([N - 1, 0], np.int32)
    out = host_sample_cold(indptr, indices, ids, DEG,
                           np.random.default_rng(0))
    np.testing.assert_array_equal(out, jax_cold(
        indptr, indices, ids, DEG, np.random.default_rng(0)))
    assert set(out[0]) <= FAR and set(out[1]) <= NEAR


def test_topo_cache_build_beyond_2_31(big_csr):
    """The hot adjacency is gathered across the int32 boundary into an
    int32 sub-CSR equal to the reference's."""
    from legion_tpu.cache.topo_cache import TopoCache as JaxTopo
    indptr, indices = big_csr
    hot = np.array([N - 1, 0], np.int32)
    topo = TopoCache.build(indptr, indices, hot, 2, "cpu")
    want = JaxTopo.build(indptr, indices, hot, capacity=2)
    for name in ("hot_ids", "sub_indptr", "sub_indices"):
        got = getattr(topo, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(want, name)), name)
    sub = topo.sub_indices.numpy()
    assert set(sub[:DEG]) == NEAR and set(sub[DEG:]) == FAR


def _striped_rank(device, cases, out_dir):
    out = {}
    for name, (indptr, fp) in cases.items():
        indices = _map(fp, int(indptr[-1]))
        st = StripedTopoCache.build(indptr, indices,
                                    np.array([0, N - 1], np.int32), 2,
                                    mesh.make_mesh(2), device)
        out[name] = (st.hot_ids.numpy(), st.sub_indptr.numpy(),
                     st.sub_indices.numpy())
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


@pytest.fixture(scope="module")
def striped_ranks(case_files):
    """Each of 2 gloo ranks' stripe of both cases."""
    with tempfile.TemporaryDirectory() as d:
        mesh.spawn(_striped_rank, 2, "cpu", args=(case_files, d), threads=1)
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]


@pytest.mark.parametrize("case", list(CASES))
def test_striped_topo_build_beyond_2_31(case, case_files, striped_ranks):
    """Each of 2 ranks holds the reference's stripe of hot runs read from
    past 2^31: id 0's run on stripe 0, id N-1's on stripe 1."""
    import jax
    from jax.sharding import Mesh

    from legion_tpu.cache.striped import StripedTopoCache as JaxStriped
    indptr, fp = case_files[case]
    indices = _map(fp, int(indptr[-1]))
    jm = Mesh(np.array(jax.devices()[:2]), ("cache",))
    want = JaxStriped.build(indptr, indices, np.array([0, N - 1], np.int32),
                            capacity=2, mesh=jm)
    sp, si = np.asarray(want.sub_indptr), np.asarray(want.sub_indices)
    for r, ranks in enumerate(striped_ranks):
        hot, got_sp, got_si = ranks[case]
        np.testing.assert_array_equal(hot, np.asarray(want.hot_ids))
        np.testing.assert_array_equal(got_sp, sp[r])
        n_edges = int(sp[r][-1])
        np.testing.assert_array_equal(got_si[:n_edges], si[r][:n_edges])
    assert set(striped_ranks[0][case][2][:DEG]) == NEAR
    assert set(striped_ranks[1][case][2][:DEG]) == FAR


def test_presample_hotness_beyond_2_31(big_csr):
    from legion_tpu.train.hybrid_driver import (
        presample_hotness_host as jax_presample_host)
    indptr, indices = big_csr
    seeds = np.full((1, 4), -1, np.int32)
    seeds[0, :2] = (0, N - 1)
    got = port_driver.presample_hotness_host(indptr, indices, seeds, (4,), N,
                                             seed=0)
    for a, b in zip(got, jax_presample_host(indptr, indices, seeds, (4,), N,
                                            seed=0)):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    node_hot, edge_hot, _ = got
    assert edge_hot[0] == 1 and edge_hot[N - 1] == 1
    assert node_hot[900:900 + DEG].sum() > 0    # the far run was reached


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_streaming_generator_roundtrip(tmp_path):
    """The uk-scale generator (``tools/smoke_uk_scale.py``'s) writes the
    reference's bytes in every file, and its output loads, validates and
    shows the Zipf source skew the cache exists for."""
    from legion_tpu.data.synthetic import (
        streaming_power_law_graph as jax_streaming)
    kw = dict(num_nodes=5000, avg_degree=7, feature_dim=8, num_classes=5,
              train_num=300, valid_num=50, test_num=50, chunk_nodes=1024,
              log=lambda s: None)
    p = port_synthetic.streaming_power_law_graph(str(tmp_path / "p"), **kw)
    jax_streaming(str(tmp_path / "r"), **kw)
    assert _files(p) == _files(tmp_path / "r")
    g = port_format.load_dataset(p)
    g.validate()
    assert g.num_nodes == 5000
    with open(os.path.join(p, "meta.json")) as f:
        assert json.load(f)["num_edges"] == g.num_edges
    assert 5 < g.degrees().mean() < 9
    counts = np.bincount(np.asarray(g.indices), minlength=5000)
    assert np.sort(counts)[::-1][:50].sum() > 3 * g.num_edges / 100
    assert len(np.intersect1d(g.train_ids, g.valid_ids)) == 0


# -- the uk2014 / clueweb arithmetic envelope ---------------------------------

def test_cost_model_arithmetic_at_ukl_magnitudes():
    """Saved-byte sums past 2^35 do not wrap (int64 and float64), the split
    honours a 38 GB budget, and the plan is the reference's."""
    from legion_tpu.cache.cost_model import solve_cost_model as jax_solve
    n = 4096
    node_hot = np.full(n, 16_000_000, np.int64)
    edge_hot = np.full(n, 16_000_000, np.int64)
    degrees = np.full(n, 60, np.int64)
    budget = 38 << 30
    args = (node_hot, edge_hot, degrees, budget)
    kw = dict(feat_row_bytes=512, group_size=8)
    cost, want = solve_cost_model(*args, **kw), jax_solve(*args, **kw)
    for f in ("feat_capacity", "topo_capacity", "alpha", "saved_feat_bytes",
              "saved_topo_bytes"):
        assert getattr(cost, f) == getattr(want, f), f
    np.testing.assert_array_equal(cost.feat_order, want.feat_order)
    np.testing.assert_array_equal(cost.topo_order, want.topo_order)
    assert 0 <= cost.feat_capacity <= n and 0 <= cost.topo_capacity <= n
    assert (cost.feat_capacity * 512 + cost.topo_capacity * (60 * 4 + 8)
            <= budget * 8 * 1.01)


def test_seed_plan_and_caps_at_ukl_registry_shapes():
    """Step math and frontier caps at uk2014's registry row (787.8M
    nodes): the reference's, with no wrap."""
    from legion_tpu.sampling.block import frontier_caps as jax_caps
    from legion_tpu.sampling.seeds import make_seed_plan as jax_plan
    ukl = port_config.DATASET_REGISTRY["UKL"]
    assert ukl.num_edges > 2 ** 35
    args = ([1_000_000 // 8] * 8, [16_000] * 8, [16_000] * 8, 8000, 512)
    plan = make_seed_plan(*args)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jax_plan(*args))
    assert plan.train_steps == (1_000_000 // 8) // 8000
    caps = frontier_caps(8000, (25, 10))
    assert caps == tuple(jax_caps(8000, (25, 10)))
    assert caps[-1] == 8000 * 26 * 11
    miss_cap = int(min(caps[-1], (caps[-1] // 16 + 1024 + 127) // 128 * 128))
    assert 0 < miss_cap <= caps[-1]
    rows = (38 << 30) // (ukl.feature_dim * 2)
    assert rows * ukl.feature_dim * 2 == 38 << 30


def test_hotness_histogram_accumulator_headroom():
    """The presample's per-node counters are int32. A node is counted at
    most once per level per step, so the worst count is steps x levels:
    reached here by a hub that every node points at and every step
    seeds (its row read at each hop), equal to the reference's
    counts on the same uniforms, and far below 2^31 at uk2014's
    presample (125 steps of 3 levels)."""
    import jax
    import jax.numpy as jnp

    from legion_tpu.cache.hotness import presample_hotness as jax_presample
    from legion_tpu.sampling.sampler import DeviceGraph as JaxGraph
    from tests.test_torch_sampler import torch_uniforms
    n, b, fanouts, steps = 300, 16, (3, 2), 5
    caps = frontier_caps(b, fanouts)
    indptr = np.arange(n + 1, dtype=np.int64)             # one edge a node
    indices = np.zeros(n, np.int32)                       # into hub 0
    seeds = (np.arange(steps * b, dtype=np.int32).reshape(steps, b) + 1)
    seeds[:, 0] = 0                                       # the hub seeds too
    num = np.full(steps, b, np.int32)
    k = jax.random.PRNGKey(3)
    want = jax_presample(k, JaxGraph.from_host(indptr, indices),
                         jnp.asarray(seeds), jnp.asarray(num), fanouts, caps,
                         n)
    got = presample_hotness(
        DeviceGraph.from_host(indptr, indices, "cpu"),
        torch.from_numpy(seeds), torch.from_numpy(num), fanouts, caps, n,
        uniforms=[torch_uniforms(sk, caps, fanouts)
                  for sk in jax.random.split(k, steps)])
    for name in ("node_hot", "edge_hot"):
        a = getattr(got, name)
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want,
                                                                    name)))
    levels = len(fanouts) + 1
    assert int(got.node_hot.max()) <= steps * levels
    assert int(got.edge_hot[0]) == steps * len(fanouts)   # the hub, each hop
    assert (1_000_000 // 8000) * 3 < 2 ** 31


def test_edge_total_accumulator_past_2_31():
    """Per-step int32 edge counts summed on the host in int64 survive past
    2^31, as the reference's."""
    from legion_tpu.train.loop import sum_edge_counts as jax_sum
    per_step = np.full(200, 17_000_000, np.int32)        # 3.4e9 > 2^31
    got = sum_edge_counts(torch.from_numpy(per_step))
    assert got == jax_sum(per_step) == 200 * 17_000_000


# -- the hybrid driver on a graph whose runs all start past 2^31 --------------

B, FANOUTS, HIDDEN = 64, (5, 4), 16


def _cfg(cm, num_classes):
    return cm.Config(
        dataset=cm.DatasetConfig(num_classes=num_classes,
                                 topology_placement="host",
                                 feature_placement="host"),
        sampler=cm.SamplerConfig(fanouts=FANOUTS, batch_size=B,
                                 eval_batch_size=32),
        model=cm.ModelConfig(arch="sage", hidden_dim=HIDDEN, num_layers=2,
                             dropout=0.0),
        train=cm.TrainConfig(epochs=2, learning_rate=0.01),
        cache=cm.CacheConfig(enabled=True, budget_bytes=128 << 10,
                             presample_steps=3))


@pytest.fixture(scope="module")
def holed(tmp_path_factory):
    g = port_synthetic.random_power_law_graph(
        num_nodes=3000, avg_degree=8, feature_dim=32, num_classes=7, seed=1)
    big, twin, facts = scale.holed_twins(
        g, str(tmp_path_factory.mktemp("holed")))
    return g, big, twin, facts


def test_holed_twins_put_every_run_past_2_31(holed):
    """The big CSR's real runs start past edge 2^31 and hold the original
    adjacency shifted by one, read through the hole's file in place; the
    twin maps the same file past the hole; the file stays sparse."""
    g, big, twin, facts = holed
    assert facts["sparse"] and facts["allocated_bytes"] < 1 << 20
    assert facts["smallest_real_run_start"] == scale.HOLE > 2 ** 31
    assert big.num_nodes == twin.num_nodes == g.num_nodes + 1
    assert big.indptr[1] == scale.HOLE and twin.indptr[1] == 0
    np.testing.assert_array_equal(np.diff(big.indptr)[1:],
                                  np.diff(twin.indptr)[1:])
    for v in (0, 17, g.num_nodes - 1):
        want = np.asarray(g.indices[g.indptr[v]:g.indptr[v + 1]]) + 1
        np.testing.assert_array_equal(
            big.indices[big.indptr[v + 1]:big.indptr[v + 2]], want)
        np.testing.assert_array_equal(
            twin.indices[twin.indptr[v + 1]:twin.indptr[v + 2]], want)
    assert twin.indices.filename == big.indices.filename
    assert twin.indices.offset == 4 * scale.HOLE
    np.testing.assert_array_equal(big.features[1:], g.features)
    np.testing.assert_array_equal(big.labels[1:], g.labels)
    for name in ("train_ids", "valid_ids", "test_ids"):
        np.testing.assert_array_equal(getattr(big, name),
                                      getattr(g, name) + 1)


def _jax_graph(data):
    from legion_tpu.data.format import GraphData as JaxGraphData
    return JaxGraphData(**{f: getattr(data, f) for f in (
        "indptr", "indices", "features", "labels", "train_ids", "valid_ids",
        "test_ids")})


def test_run_hybrid_training_past_2_31_matches_the_reference(holed,
                                                             monkeypatch):
    """``run_hybrid_training`` on the CPU on the graph whose every real run
    starts past edge 2^31, against the reference's driver on the same
    memmap: the reference's initial weights and device uniforms (its
    ``fold_in(state.rng, epoch)`` schedule; eval: ``PRNGKey(4242)``),
    float32, dropout 0. Both caches are fed, the cost-model split and the
    caps are equal, the hot / cold split, hit rate, host bytes and reads
    of every epoch are equal, each epoch's loss is within rtol 1e-4 / atol
    1e-5 and the validation and test accuracies are equal; the trainer
    reads the mapped indices in place."""
    import jax

    from legion_tpu import config as jax_config
    from legion_tpu.cache.hybrid import HybridTrainer as JaxTrainer
    from legion_tpu.train import hybrid_driver as jax_driver
    from legion_tpu_torch.models.convert import params_from_flax as to_torch
    _, big, _, _ = holed
    rec = types.SimpleNamespace(params=None, keys=[])
    jstate = jax_driver.create_train_state

    def spy_state(params, *a, **k):
        rec.params = jax.tree_util.tree_map(np.array, params)
        return jstate(params, *a, **k)
    monkeypatch.setattr(jax_driver, "create_train_state", spy_state)
    jrun = JaxTrainer.run_epoch

    def spy_epoch(self, state, seeds, labels, epoch):
        rec.keys.append(jax.random.fold_in(state.rng, epoch))
        return jrun(self, state, seeds, labels, epoch)
    monkeypatch.setattr(JaxTrainer, "run_epoch", spy_epoch)
    want = jax_driver.run_hybrid_training(_cfg(jax_config, 7),
                                          _jax_graph(big),
                                          log=lambda s: None)

    build = port_driver.build_model

    def build_from_ref(*a, **k):
        m = build(*a, **k)
        m.load_state_dict(to_torch(rec.params))
        return m
    monkeypatch.setattr(port_driver, "build_model", build_from_ref)

    def schedule(caps, key):
        def uniforms(step, hop):
            k = jax.random.fold_in(jax.random.fold_in(key, step), hop)
            return torch.from_numpy(np.asarray(jax.random.uniform(
                k, (caps[hop], FANOUTS[hop]), dtype=np.float32)).copy())
        return uniforms
    prun, peval = HybridTrainer.run_epoch, HybridTrainer.eval_epoch
    monkeypatch.setattr(HybridTrainer, "run_epoch", lambda self, st, s, lab,
                        epoch: prun(self, st, s, lab, epoch, uniforms=schedule(
                            self.caps, rec.keys[epoch])))
    monkeypatch.setattr(HybridTrainer, "eval_epoch", lambda self, m, s, c,
                        lab: peval(self, m, s, c, lab, uniforms=schedule(
                            self.caps, jax.random.PRNGKey(4242))))
    res = port_driver.run_hybrid_training(_cfg(port_config, 7), big, "cpu",
                                          log=lambda s: None)

    tr = res["trainer"]
    assert np.shares_memory(tr.host_indices, big.indices)
    assert int(tr.host_indptr[1]) > 2 ** 31
    for f in ("alpha", "feat_capacity", "topo_capacity"):
        assert getattr(res["cost"], f) == getattr(want["cost"], f), f
    assert 0.0 < res["cost"].alpha < 1.0
    assert res["cost"].feat_capacity > 0 and res["cost"].topo_capacity > 0
    assert tr.caps == tuple(want["trainer"].caps)
    assert len(res["history"]) == len(want["history"]) == 2
    for h, jh in zip(res["history"], want["history"]):
        for k in ("steps", "fetches", "feat_hit_rate", "topo_hot_fraction",
                  "host_feat_gb", "host_topo_gb", "staging_overflow"):
            assert h[k] == jh[k], k
        assert 0.0 < h["topo_hot_fraction"] < 1.0
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-4,
                                   atol=1e-5)
        assert h["valid"] == pytest.approx(jh["valid"], abs=1e-6)
    assert res["test_acc"] == pytest.approx(want["test_acc"], abs=1e-6)
