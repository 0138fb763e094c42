"""The port's benchmark entry point (``legion_tpu_torch.bench``), its roof
model (``tools/sol_model.py``) and its kernel gate
(``tools/bench_kernels.py``) on the CPU.

* the seeds matrix is bench.py's numpy expression, element for element;
* ``python -m legion_tpu_torch.bench --device cpu`` on a tiny graph
  prints one stdout line with exactly bench.py's keys and a
  ``kernel_gate`` that says the gate did not run; a second run reads the
  graph, caps and baseline memos, and a JAX-named caps memo is never read;
* the baseline's code hash moves with each file on its path;
* a cap overflow fails the run;
* each roof stage against a hand computation at the JAX preview's shapes;
  the roof is null on a card other than the one its rates name;
* the cap probe's maxima are those of a loop of ``sample_batch``;
* each ``compare_*`` function (the gate's and the smoke's rules) accepts
  the plain versions and rejects a wrapper that is off by one;
* the gate raises off the card; on the card (``cuda`` marker) it passes.
"""

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from legion_tpu_torch import bench
from legion_tpu_torch.cache.hotness import probe_frontier_maxima
from legion_tpu_torch.sampling.block import frontier_caps
from legion_tpu_torch.sampling.sampler import sample_batch
from legion_tpu_torch.tools import bench_kernels, sol_model
from legion_tpu_torch.tools.bench_kernels import run_gate

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--nodes", "4000", "--deg", "10", "--batch",
        "256", "--steps", "3"]


@pytest.mark.parametrize("seed", [0, 3])
def test_seeds_matrix_is_bench_py_expression(small_graph, seed):
    steps, batch = 6, 50
    got = bench.seeds_matrix(small_graph.train_ids, steps, batch, seed)
    # bench.py:241-243
    rng = np.random.default_rng(seed)
    ids = np.asarray(small_graph.train_ids)
    want = np.stack([rng.permutation(ids)[:batch] for _ in range(steps)])
    np.testing.assert_array_equal(got, want)


def _run(cache_dir):
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "legion_tpu_torch.bench", *TINY,
         "--cache-dir", str(cache_dir)], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout, res.stderr


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    """Two runs of the command line on one cache directory, which also
    holds a caps memo under bench.py's own name (a wrong one)."""
    cache = tmp_path_factory.mktemp("bench_cache")
    with open(cache / "caps_nd_4000_10_256_s1.03.json", "w") as f:
        json.dump([1, 2, 3], f)
    return _run(cache), _run(cache), cache


def _line(stdout):
    lines = stdout.splitlines()
    assert len(lines) == 1, stdout
    return json.loads(lines[0])


@pytest.mark.parametrize("run", [0, 1])
def test_cli_prints_one_line_with_bench_py_keys(two_runs, run):
    rec = _line(two_runs[run][0])
    assert tuple(rec) == bench.KEYS
    assert rec["metric"] == "train_edges_per_s" and rec["unit"] == "edges/s"
    for k in ("value", "step_ms", "vs_baseline"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    # the gate and the roof are the card's: said so, never "pass"
    assert rec["kernel_gate"] == "not_run:cpu" and rec["kernels"] == []
    assert rec["roof_ms"] is None and rec["sol_frac"] is None
    assert rec["roof_stages_ms"] == {}


def test_cli_first_run_probes_and_measures(two_runs):
    err = two_runs[0][1]
    assert "generating 4000 nodes" in err
    assert "cap probe" in err and "from cache" not in err
    # both variants, both trials on record
    for agg in ("fanout", "coo_segment"):
        for trial in (0, 1):
            assert f"[{agg}] trial {trial}:" in err


def test_cli_second_run_reads_every_memo(two_runs):
    err = two_runs[1][1]
    assert "graph loaded from cache" in err
    assert "observed caps from cache" in err
    assert "[coo_segment] baseline from cache" in err
    assert "cap probe" not in err and "[coo_segment] trial" not in err
    memos = sorted(os.listdir(two_runs[2] / "torch"))
    assert [m.split("_")[0] for m in memos] == ["baseline", "caps", "synth"]
    caps = json.load(open(two_runs[2] / "torch" / [
        m for m in memos if m.startswith("caps")][0]))
    assert caps != [1, 2, 3] and caps[-1] == caps[-2] * 11


@pytest.mark.parametrize("rel", bench.BASELINE_PATH)
def test_code_hash_moves_with_each_file_on_the_path(tmp_path, rel):
    for f in bench.BASELINE_PATH:
        os.makedirs(tmp_path / os.path.dirname(f), exist_ok=True)
        shutil.copy(os.path.join(bench.PACKAGE, f), tmp_path / f)
    before = bench.code_hash(str(tmp_path))
    assert before == bench.code_hash()
    with open(tmp_path / rel, "ab") as f:
        f.write(b"\n")
    assert bench.code_hash(str(tmp_path)) != before


@pytest.mark.parametrize("agg", ["fanout", "coo_segment"])
def test_run_steps_is_the_eager_step(tmp_path, agg):
    """``run_steps`` goes through ``epoch_scan`` (on the card a replay of
    the captured step each): on the CPU its steps are bitwise a loop of
    the eager ``train_step`` from the same weights and seeds, and a second
    call reuses the first one's static buffers (on the card, its graph)."""
    args = bench.parse_args([*TINY, "--cache-dir", str(tmp_path)])
    setup = bench.prepare(args, log=lambda s: None)
    state, fns = bench.build_variant(agg, setup)
    twin, twin_fns = bench.build_variant(agg, setup)
    assert fns.epoch_scan.pool.device == setup.device
    got = bench.run_steps(fns, state, setup)
    num = torch.tensor(setup.seeds.shape[1], dtype=torch.int32)
    per = [twin_fns.train_step(twin, setup.graph, setup.feats, setup.seeds[i],
                               num, setup.labels[i])
           for i in range(setup.steps)]
    want = torch.cat([
        torch.stack([per[-1]["loss"].double(),
                     torch.stack([m["cap_overflow"] for m in per]).sum()
                     .double()]),
        torch.stack([m["edges"] for m in per]).double()])
    assert torch.equal(got, want)
    for a, b in zip(state.model.parameters(), twin.model.parameters()):
        assert torch.equal(a, b)
    run = fns.epoch_scan.runs[False]
    bench.run_steps(fns, state, setup)
    assert fns.epoch_scan.runs[False] is run
    assert state.step == 2 * setup.steps


def test_cap_overflow_fails_the_run(tmp_path):
    args = bench.parse_args([*TINY, "--cache-dir", str(tmp_path)])
    setup = bench.prepare(args, log=lambda s: None)
    c0 = setup.caps[0]             # a hop-1 cap the frontier outgrows
    setup.caps = (c0, c0, c0 * 11)
    with pytest.raises(RuntimeError, match="cap overflow"):
        bench.run_variant("fanout", setup, log=lambda s: None)


def test_gate_and_roof_do_not_run_on_the_cpu(tmp_path):
    args = bench.parse_args([*TINY, "--cache-dir", str(tmp_path)])
    setup = bench.prepare(args, log=lambda s: None)
    assert bench.gate(setup.device) == ("not_run:cpu", [])
    assert bench.roof(setup, 5.0, 1e6, log=lambda s: None) == (
        {"total": None}, None)


@pytest.fixture(scope="module")
def tiny_setup(tmp_path_factory):
    args = bench.parse_args([*TINY, "--cache-dir",
                             str(tmp_path_factory.mktemp("roof"))])
    return bench.prepare(args, log=lambda s: None)


@pytest.mark.parametrize("card,applies", [
    (sol_model.RATES_CARD, True), ("NVIDIA A100-SXM4-80GB", False),
    ("NVIDIA H100 PCIe", False)])
def test_roof_only_on_the_card_its_rates_name(tiny_setup, monkeypatch,
                                              card, applies):
    """The roof's rates are the H100 SXM's: on another card the bench
    gives no roof rather than one that describes the wrong card."""
    setup = bench.Setup(**{**vars(tiny_setup),
                           "device": torch.device("cuda")})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: card)
    said = []
    stages, sol = bench.roof(setup, 5.0, 1e6, log=said.append)
    if applies:
        assert stages == sol_model.step_roof_ms(
            256, setup.caps, bench.FANOUTS, 256, setup.feats.shape[1], 47,
            bf16=True, edges=1e6)
        assert math.isclose(sol, stages["total"] / 5.0)
    else:
        assert (stages, sol) == ({"total": None}, None)
        assert card in said[0] and sol_model.RATES_CARD in said[0]


@pytest.mark.parametrize("batches", [1, 3])
def test_probe_frontier_maxima_is_a_loop_of_sample_batch(tiny_setup,
                                                         batches):
    s = tiny_setup
    loose = frontier_caps(256, bench.FANOUTS)
    num = torch.tensor(256, dtype=torch.int32)
    got = probe_frontier_maxima(
        s.graph, [(s.seeds[i], num) for i in range(batches)], bench.FANOUTS,
        loose, torch.Generator().manual_seed(100))
    gen = torch.Generator().manual_seed(100)
    want = np.zeros(3, np.int64)
    for i in range(batches):
        b = sample_batch(s.graph, s.seeds[i], num, s.labels[i],
                         bench.FANOUTS, loose, generator=gen)
        want = np.maximum(want, [int(b.num_seeds)] + [
            int(blk.num_src) for blk in b.blocks])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got[0] == 256


def _compare_cases():
    """(name, compare function, wrapper's module and name, arguments) on
    small CPU tensors, one or more per rule."""
    rng = np.random.default_rng(4)
    p, f, d, off, s = 40, 5, 24, 7, 60

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    x = t(rng.standard_normal((off + p * f, d)).astype(np.float32))
    mask = t(rng.random((p, f)) > 0.3)
    h = t(rng.standard_normal((s, d)).astype(np.float32))
    pos = torch.where(mask, t(rng.integers(0, s, (p, f)).astype(np.int32)),
                      0)
    g = t(rng.standard_normal((p, d)).astype(np.float32))
    deg = rng.integers(0, 9, 100)
    indptr = t(np.r_[0, np.cumsum(deg)].astype(np.int32))
    indices = t(rng.integers(0, 100, int(deg.sum())).astype(np.int32))
    frontier = t(rng.integers(-1, 100, 30).astype(np.int32))
    u = t(rng.random((30, 6), dtype=np.float32))
    ids = t(rng.integers(-1, s, 50).astype(np.int32))
    wm = mask * t((0.5 + rng.random((p, f))).astype(np.float32))
    k1 = ("identity_agg", "identity_masked_mean")
    k2 = ("identity_agg", "gathered_masked_mean")
    k2b = ("identity_agg", "gathered_masked_mean_backward")
    k5 = ("spmm", "grouped_masked_sum")
    bk = bench_kernels
    return [
        ("k1_bf16", bk.compare_identity_mean, k1, (x, mask, off)),
        ("k1_f32_sqrt", bk.compare_identity_mean, k1,
         (x, mask, off, "sqrt", torch.float32)),
        ("k2_bf16", bk.compare_k2_forward, k2,
         (h.to(torch.bfloat16), pos, mask)),
        ("k2_f32_sum", bk.compare_k2_forward, k2, (h, pos, mask, "sum")),
        ("k2_bwd_f32", bk.compare_k2_backward, k2b,
         (g, pos, mask, s, "mean", torch.float32)),
        ("k2_bwd_bf16", bk.compare_k2_backward, k2b,
         (g.to(torch.bfloat16), pos, mask, s, "sqrt")),
        ("k3", bk.compare_gather_rows, ("gather", "gather_rows"), (h, ids)),
        ("k4", bk.compare_sample, ("sample", "sample_neighbors"),
         (indptr, indices, frontier, u)),
        ("k5_f32", bk.compare_grouped_sum, k5, (x[off:], mask, f)),
        ("k5_bf16_float_mask", bk.compare_grouped_sum, k5,
         (x[off:].to(torch.bfloat16), wm, f)),
    ]


_CASES = {c[0]: c for c in _compare_cases()}


@pytest.mark.parametrize("name", list(_CASES))
def test_compare_accepts_the_plain_version(name):
    """On the CPU each wrapper takes its plain version: every rule holds
    with no difference at all."""
    import importlib
    _, compare, (mod, fn), args = _CASES[name]
    c = compare(*args)
    assert c.ok and c.max_abs_err == 0.0
    wrapper = getattr(importlib.import_module(f"legion_tpu_torch.ops.{mod}"),
                      fn)
    assert torch.equal(c.out, wrapper(*args))    # the wrapper's result


@pytest.mark.parametrize("name", list(_CASES))
def test_compare_rejects_a_wrapper_off_by_one(name, monkeypatch):
    """A wrapper whose result is off by 1 in one element fails its rule,
    and the error says by how much."""
    import importlib
    _, compare, (mod, fn), args = _CASES[name]
    module = importlib.import_module(f"legion_tpu_torch.ops.{mod}")
    right = getattr(module, fn)

    def wrong(*a, **k):
        out = right(*a, **k).clone()
        out.view(-1)[3] += 1
        return out

    monkeypatch.setattr(module, fn, wrong)
    c = compare(*args)
    assert not c.ok and c.max_abs_err >= 0.99


# the JAX preview's shapes (tools/sol_model.py:120-123)
B, CAPS, FAN, H, D, C = 8000, (8000, 122240, 1344640), (25, 10), 256, 128, 47


def _hand(stage, bf16):
    m = sol_model
    a = 2 if bf16 else 4
    gemm = m.GEMM_TFLOPS["bfloat16" if bf16 else "float32"] * 1e12
    return 1e3 * {
        "sample": (12 * (8000 * 25 + 122240 * 10) + 12 * (8000 + 122240))
        / m.COPY_BYTES_PER_S,
        "dedup": 8000 * 26 / m.SORT_KEYS_PER_S
        + (12 * 8000 * 26 + 4 * 8000 * 25 + 4 * 122240) / m.COPY_BYTES_PER_S,
        "gather": 122240 / m.ROW_GATHERS_PER_S
        + (1344640 - 122240) * 512 / m.COPY_BYTES_PER_S,
        "aggregate": (122240 * 10 * 512 + 122240 * 128 * a
                      + 8000 * 25 * 47 * a + 8000 * 47 * a)
        / m.COPY_BYTES_PER_S,
        "matmuls": 2 * (2 * (2 * 122240 * 128 * 256)
                        + 3 * (122240 * 256 * 47 + 8000 * 256 * 47)) / gemm,
        "bwd_scatter": 8000 * 25 / m.SCATTER_ROWS_PER_S,
        "elementwise": (3 * 122240 * 256 * a
                        + 28 * (2 * 128 * 256 + 256 + 2 * 256 * 47))
        / m.COPY_BYTES_PER_S,
    }[stage]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("stage", sol_model.STAGES)
def test_roof_stage_by_hand(stage, bf16):
    roof = sol_model.step_roof_ms(B, CAPS, FAN, H, D, C, bf16=bf16)
    assert math.isclose(roof[stage], _hand(stage, bf16), rel_tol=1e-12)


def test_roof_counts_the_valid_slots_where_the_edges_are_known():
    """With the run's edges a step, hop 2's valid slots (edges less hop
    1's 8000 x 25) replace every slot of the cap in the draws' index and
    uniform reads and in K1's reads; nothing else moves."""
    m = sol_model
    edges = 1_380_000
    full = m.step_roof_ms(B, CAPS, FAN, H, D, C)
    got = m.step_roof_ms(B, CAPS, FAN, H, D, C, edges=edges)
    fewer = 122240 * 10 - (edges - 8000 * 25)
    assert math.isclose(full["sample"] - got["sample"],
                        1e3 * 8 * fewer / m.COPY_BYTES_PER_S, rel_tol=1e-9)
    assert math.isclose(full["aggregate"] - got["aggregate"],
                        1e3 * 512 * fewer / m.COPY_BYTES_PER_S, rel_tol=1e-9)
    for s in set(m.STAGES) - {"sample", "aggregate"}:
        assert got[s] == full[s], s


def test_roof_total_is_the_sum_of_its_stages():
    roof = sol_model.step_roof_ms(B, CAPS, FAN, H, D, C)
    assert set(roof) == set(sol_model.STAGES) | {"total"}
    assert math.isclose(roof["total"], sum(roof[s] for s in
                                           sol_model.STAGES), rel_tol=1e-12)
    assert math.isclose(sol_model.sol_fraction(2 * roof["total"], roof),
                        0.5)


@pytest.mark.parametrize("name,stage", [
    ("void sample_neighbors_kernel<16>(int const*, int const*)", "sample"),
    ("void cub::DeviceRadixSortOnesweepKernel<...>", "dedup"),
    ("void (anonymous namespace)::dedup_tail_kernel(int const*, ...)",
     "dedup"),
    ("void gather_rows_kernel<4>(...)", "gather"),
    ("void masked_agg_kernel<float, __nv_bfloat16>(...)", "aggregate"),
    ("void gathered_agg_kernel<__nv_bfloat16, 2, 4>(...)", "aggregate"),
    ("void scatter_rows_kernel<4>(...)", "bwd_scatter"),
    ("nvjet_tst_128x64_64x8_2x1_v_bz_coopA_NNT", "matmuls"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "matmuls"),
    ("void at::native::tensor_kernel_scan_innermost_dim<...>", "elementwise"),
    ("Memset (Device)", "elementwise"),
])
def test_trace_kernels_by_stage(name, stage):
    assert sol_model.stage_of(name) == stage


def test_run_gate_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        run_gate(quick=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_run_gate_passes_on_every_wrapper(cuda):
    res = run_gate(quick=True, log=lambda s: None)
    assert res["failures"] == []
    names = {k["kernel"].split("[")[0] for k in res["kernels"]}
    assert names == {"identity_masked_mean", "gathered_masked_mean",
                     "gathered_masked_mean_backward", "gather_rows",
                     "sample_neighbors", "grouped_masked_sum"}
    assert all(k["ms"] is None for k in res["kernels"])
