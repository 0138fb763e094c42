"""Port parity: ``legion_tpu_torch.runtime`` (the host runtime, built by
g++ from ``legion_tpu_torch/csrc/gnnio.cpp`` at first use) against
``legion_tpu.runtime`` with its committed library, and against the port's
plain numpy versions. Every comparison is exact: the sampler's draws are a
function of (seed, row, slot) alone, the other entries move or count
integers and copy floats."""

import numpy as np
import pytest
import torch

from legion_tpu import runtime as jax_runtime
from legion_tpu_torch import runtime
from legion_tpu_torch.ops import _build

torch.set_num_threads(2)


def _csr(n=3000, seed=0):
    """An int64-indptr CSR with zero-degree rows and a few hubs."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 12, size=n)
    deg[rng.integers(0, n, 200)] = 0
    deg[:3] = 900
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    return indptr, indices


def _ids(n, m, seed):
    ids = np.random.default_rng(seed).integers(0, n, m).astype(np.int32)
    ids[::7] = -1
    ids[:3] = [0, 1, 2]
    return ids


def test_reference_library_is_native():
    """The comparisons below are against the reference's C++, not its
    numpy fallback (whose sampler draws other neighbors)."""
    assert jax_runtime.native_available()


def test_library_is_built_at_first_use_under_the_build_directory():
    runtime.load_library()
    so = runtime.library_path()
    assert so.exists() and so.parent == _build.BUILD_DIR
    assert so.name.startswith("gnnio_") and so.with_suffix(".log").exists()


@pytest.mark.parametrize("fanout", [1, 5, 25])
@pytest.mark.parametrize("seed", [0, 7 * 1_000_003 + 1, 2 ** 64 + 5,
                                  (3 * 1_000_003 + 9) * 131 + 1])
def test_sample_neighbors_matches_reference_and_plain(fanout, seed):
    """Bit-equal draws for padded ids (-1), zero-degree rows and fanouts
    above most degrees, over an int64 indptr."""
    indptr, indices = _csr()
    ids = _ids(3000, 1000, seed % 97)
    got = runtime.sample_neighbors(indptr, indices, ids, fanout, seed)
    assert got.dtype == np.int32 and got.shape == (1000, fanout)
    np.testing.assert_array_equal(got, jax_runtime.sample_neighbors(
        indptr, indices, ids, fanout, seed % 2 ** 64))
    np.testing.assert_array_equal(got, runtime.sample_neighbors_plain(
        indptr, indices, ids, fanout, seed))
    deg = np.diff(indptr)[np.clip(ids, 0, None)]
    want_valid = (ids >= 0)[:, None] & (np.arange(fanout)[None] < deg[:, None])
    np.testing.assert_array_equal(got >= 0, want_valid)
    assert (got[ids < 0] == -1).all() and (got >= 0).any()
    # every draw is a neighbor of its row
    for i in np.flatnonzero(ids >= 0)[:50]:
        nbrs = indices[indptr[ids[i]]:indptr[ids[i] + 1]]
        assert np.isin(got[i][got[i] >= 0], nbrs).all()


def test_sample_neighbors_addresses_edges_past_2_31(tmp_path):
    """A row whose edges lie past offset 2^31 is addressed in int64. The
    indices are a sparse file (holes up to the row), mapped read-only."""
    base = 2 ** 31 + 10
    path = tmp_path / "indices"
    with open(path, "wb") as f:
        f.truncate((base + 64) * 4)
    w = np.memmap(path, dtype=np.int32, mode="r+")
    w[base:] = np.arange(1000, 1064)
    w.flush()
    del w
    indices = np.memmap(path, dtype=np.int32, mode="r")
    indptr = np.array([0, base, base + 64], np.int64)
    ids = np.array([1, -1, 1], np.int32)
    got = runtime.sample_neighbors(indptr, indices, ids, 8, 21)
    np.testing.assert_array_equal(got, jax_runtime.sample_neighbors(
        indptr, indices, ids, 8, 21))
    np.testing.assert_array_equal(got, runtime.sample_neighbors_plain(
        indptr, indices, ids, 8, 21))
    assert ((got[[0, 2]] >= 1000) & (got[[0, 2]] < 1064)).all()
    assert (got[1] == -1).all() and not np.array_equal(got[0], got[2])


def test_sample_neighbors_writes_into_a_given_buffer():
    indices = np.arange(64, dtype=np.int32)
    indptr = np.array([0, 5, 5, 64], np.int64)
    ids = np.array([2, -1, 0, 1], np.int32)
    out = np.full((4, 6), 99, np.int32)
    assert runtime.sample_neighbors(indptr, indices, ids, 6, 3,
                                    out=out) is out
    np.testing.assert_array_equal(out, runtime.sample_neighbors_plain(
        indptr, indices, ids, 6, 3))
    assert (out[0] >= 5).all() and (out[1] == -1).all() and (
        out[3] == -1).all() and (out[2, :5] < 5).all() and out[2, 5] == -1


def test_sample_neighbors_rejects_wrong_arrays():
    indptr, indices = _csr(50)
    ids = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError, match="indptr"):
        runtime.sample_neighbors(indptr.astype(np.int32), indices, ids, 3, 0)
    with pytest.raises(ValueError, match="indices"):
        runtime.sample_neighbors(indptr, indices.astype(np.int64), ids, 3, 0)
    with pytest.raises(ValueError, match="outside"):
        runtime.sample_neighbors(indptr, indices,
                                 np.array([50], np.int32), 3, 0)
    with pytest.raises(ValueError, match="out has shape"):
        runtime.sample_neighbors(indptr, indices, ids, 3, 0,
                                 out=np.empty((5, 4), np.int32))


def test_sample_neighbors_reads_a_memmap_in_place(tmp_path):
    indptr, indices = _csr(500)
    indptr.tofile(tmp_path / "p")
    indices.tofile(tmp_path / "i")
    mp = np.memmap(tmp_path / "p", dtype=np.int64, mode="r")
    mi = np.memmap(tmp_path / "i", dtype=np.int32, mode="r")
    assert np.shares_memory(runtime._want(mi, np.int32, "indices"), mi)
    ids = _ids(500, 300, 1)
    np.testing.assert_array_equal(
        runtime.sample_neighbors(mp, mi, ids, 4, 11),
        runtime.sample_neighbors(indptr, indices, ids, 4, 11))


@pytest.mark.parametrize("m", [0, 10, 5000])
def test_gather_rows_matches_reference_and_plain(m):
    rng = np.random.default_rng(2)
    table = rng.standard_normal((400, 9)).astype(np.float32)
    ids = _ids(400, max(m, 3), 3)[:m]
    if m:
        ids[-1] = 400                       # past the table: a zero row
    got = runtime.gather_rows(table, ids)
    np.testing.assert_array_equal(got, jax_runtime.gather_rows(table, ids))
    np.testing.assert_array_equal(got, runtime.gather_rows_plain(table, ids))
    out = np.empty((m, 9), np.float32)
    assert runtime.gather_rows(table, ids, out=out) is out
    np.testing.assert_array_equal(out, got)
    with pytest.raises(ValueError, match="table"):
        runtime.gather_rows(table.astype(np.float64), ids)


@pytest.mark.parametrize("m", [0, 100, 200_000])
def test_accumulate_hist_matches_reference_and_plain(m):
    """200,000 ids run on several threads adding into the one histogram:
    no count is lost."""
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 1000, m).astype(np.int32)
    ids[: m // 2] = rng.integers(0, 4, m // 2)       # heavy contention
    start = rng.integers(0, 5, 1000).astype(np.int64)
    hists = [start.copy() for _ in range(3)]
    runtime.accumulate_hist(hists[0], ids)
    jax_runtime.accumulate_hist(hists[1], ids)
    runtime.accumulate_hist_plain(hists[2], ids)
    np.testing.assert_array_equal(hists[0], hists[1])
    np.testing.assert_array_equal(hists[0], hists[2])
    with pytest.raises(ValueError, match="hist"):
        runtime.accumulate_hist(hists[0].astype(np.int32), ids)


@pytest.mark.parametrize("e", [0, 1, 5000])
def test_coo_to_csr_matches_reference_and_plain(e):
    rng = np.random.default_rng(5)
    src = rng.integers(0, 300, e).astype(np.int32)
    dst = rng.integers(0, 300, e).astype(np.int32)
    got = runtime.coo_to_csr(src, dst, 300)
    assert got[0].dtype == np.int64 and got[1].dtype == np.int32
    for want in (jax_runtime.coo_to_csr(src, dst, 300),
                 runtime.coo_to_csr_plain(src, dst, 300)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    if e:
        with pytest.raises(ValueError, match="outside"):
            runtime.coo_to_csr(src, dst, int(dst.max()))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No numpy fallback: with a compiler that does not exist, or one that
    fails, the first call raises and leaves no library behind."""
    ids = np.zeros(3, np.int32)
    indptr, indices = _csr(10)
    for cxx, msg in ((("no-such-compiler-xyz",), "cannot run"),
                     (("g++", "-std=no-such-standard"), "failed")):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / cxx[-1])
        monkeypatch.setattr(runtime, "CXX", cxx)
        runtime.load_library.cache_clear()
        try:
            with pytest.raises(RuntimeError, match=msg):
                runtime.sample_neighbors(indptr, indices, ids, 2, 0)
            assert not list((tmp_path / cxx[-1]).glob("*.so"))
        finally:
            runtime.load_library.cache_clear()
    monkeypatch.undo()
    assert runtime.sample_neighbors(indptr, indices, ids, 2, 0).shape == (3, 2)
