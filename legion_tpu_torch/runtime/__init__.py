"""Native host runtime (C++ through ctypes; counterpart of
``legion_tpu/runtime``).

``csrc/gnnio.cpp`` is compiled by g++ at the first call, never at import,
into ``legion_tpu_torch/_build/`` (the file name hashes the source, as the
CUDA library's does). A failed build raises: the reference falls back to
numpy, whose sampler draws *other* neighbors than the C++ one, so a
fallback would change results without a word.

Four entries: ``gather_rows``, ``sample_neighbors`` (the host leg of the
host-topology placement: the misses of the device's topology cache),
``accumulate_hist`` (the host presample's hotness counts) and
``coo_to_csr`` (the CSR of the OGB converter, ``data/ogb.py``). Each has a plain numpy version beside it (``*_plain``)
that gives exactly the same result; the tests hold the C++ against them,
and nothing on the drivers' path calls them.

The sampler's draws are counter-based: slot ``f`` of row ``i`` takes
neighbor ``splitmix64(seed ^ (i << 20) ^ f) % deg`` of ``ids[i]``, and is
-1 where ``f >= deg`` or ``ids[i] < 0``: the same draws whatever the
thread count, and bit-equal to the reference's.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from legion_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gnnio.cpp"
CXX = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_P = ctypes.c_void_p
_L = ctypes.c_int64
_I = ctypes.c_int
_SIGNATURES = {
    # out, table, ids, n, dim, num_rows, nthreads
    "gather_rows_f32": (_P, _P, _P, _L, _L, _L, _I),
    # out, indptr, indices, ids, n, fanout, seed, nthreads
    "sample_neighbors_u32": (_P, _P, _P, _P, _L, ctypes.c_int32,
                             ctypes.c_uint64, _I),
    # hist, ids, n, num_rows, nthreads
    "accumulate_hist_i64": (_P, _P, _L, _L, _I),
    # src, dst, num_edges, num_nodes, indptr, indices
    "coo_to_csr": (_P, _P, _L, _L, _P, _P),
}


def library_path() -> Path:
    return _build.hashed_library(SOURCE, "gnnio")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (unless this exact source is built already) and bind."""
    so = library_path()
    if not so.exists():
        _build.compile_shared(CXX, SOURCE, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def max_threads() -> int:
    """The most threads an entry may start (it starts fewer for little
    work): the cores this process may run on."""
    return max(len(os.sched_getaffinity(0)), 1)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def _want(a: np.ndarray, dtype, what: str) -> np.ndarray:
    """``a`` as it is when it is a C-contiguous array of ``dtype`` (a
    memmap included: nothing is copied), else a ValueError."""
    a = np.asarray(a)
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"{what} must be a C-contiguous {np.dtype(dtype)} "
                         f"array, got {a.dtype}")
    return a


# -- row gather ---------------------------------------------------------------

def gather_rows(table: np.ndarray, ids: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[i] = table[ids[i]] (a zero row for an id outside the table),
    threaded; table (R, D) float32."""
    table = _want(table, np.float32, "table")
    ids = np.ascontiguousarray(ids, np.int32)
    n, dim = ids.shape[0], table.shape[1]
    if out is None:
        out = np.empty((n, dim), np.float32)
    elif out.shape != (n, dim):
        raise ValueError(f"out has shape {out.shape}, want {(n, dim)}")
    load_library().gather_rows_f32(
        _ptr(_want(out, np.float32, "out")), _ptr(table), _ptr(ids), n, dim,
        table.shape[0], max_threads())
    return out


def gather_rows_plain(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
    ids = np.asarray(ids, np.int64)
    ok = (ids >= 0) & (ids < table.shape[0])
    out = np.asarray(table, np.float32)[np.where(ok, ids, 0)]
    out[~ok] = 0.0
    return out


# -- neighbor sampling --------------------------------------------------------

def sample_neighbors(indptr: np.ndarray, indices: np.ndarray,
                     ids: np.ndarray, fanout: int, seed: int,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """(len(ids), fanout) int32 uniform-with-replacement draws from a host
    CSR (int64 ``indptr``, int32 ``indices``; memmaps are read in place),
    -1 for a slot past the degree and for an id < 0; into ``out`` (e.g. a
    pinned buffer) when given. ``seed`` is taken modulo 2^64."""
    indptr = _want(indptr, np.int64, "indptr")
    indices = _want(indices, np.int32, "indices")
    ids = np.ascontiguousarray(ids, np.int32)
    n = ids.shape[0]
    if n and int(ids.max()) >= indptr.shape[0] - 1:
        raise ValueError(f"id {int(ids.max())} is outside the "
                         f"{indptr.shape[0] - 1} rows of the CSR")
    if out is None:
        out = np.empty((n, fanout), np.int32)
    elif out.shape != (n, fanout):
        raise ValueError(f"out has shape {out.shape}, want {(n, fanout)}")
    load_library().sample_neighbors_u32(
        _ptr(_want(out, np.int32, "out")), _ptr(indptr), _ptr(indices),
        _ptr(ids), n, fanout, seed % 2 ** 64, max_threads())
    return out


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The C++ sampler's generator on a uint64 array (wrapping, as C)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def sample_neighbors_plain(indptr: np.ndarray, indices: np.ndarray,
                           ids: np.ndarray, fanout: int,
                           seed: int) -> np.ndarray:
    """The sampler in numpy: the same splitmix64 arithmetic in uint64."""
    ids = np.asarray(ids, np.int64)
    safe = np.where(ids >= 0, ids, 0)
    start = np.asarray(indptr)[safe].astype(np.int64)
    deg = np.asarray(indptr)[safe + 1].astype(np.int64) - start
    row = np.arange(ids.shape[0], dtype=np.uint64)[:, None]
    slot = np.arange(fanout, dtype=np.uint64)[None, :]
    r = splitmix64(np.uint64(seed % 2 ** 64) ^ (row << np.uint64(20)) ^ slot)
    off = (r % np.maximum(deg, 1).astype(np.uint64)[:, None]).astype(np.int64)
    ok = (ids >= 0)[:, None] & (slot.astype(np.int64) < deg[:, None])
    if not ok.any():                    # also the CSR without an edge
        return np.full((ids.shape[0], fanout), -1, np.int32)
    addr = np.where(ok, start[:, None] + off, 0)
    return np.where(ok, np.asarray(indices)[addr], -1).astype(np.int32)


# -- histogram ----------------------------------------------------------------

def accumulate_hist(hist: np.ndarray, ids: np.ndarray) -> None:
    """hist[v] += the count of v in ids, in place (ids outside the
    histogram are skipped); hist (R,) int64."""
    hist = _want(hist, np.int64, "hist")
    ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int32)
    load_library().accumulate_hist_i64(_ptr(hist), _ptr(ids), ids.shape[0],
                                       hist.shape[0], max_threads())


def accumulate_hist_plain(hist: np.ndarray, ids: np.ndarray) -> None:
    v = np.asarray(ids).reshape(-1)
    v = v[(v >= 0) & (v < hist.shape[0])]
    hist += np.bincount(v, minlength=hist.shape[0])


# -- COO -> CSR ---------------------------------------------------------------

def coo_to_csr(src: np.ndarray, dst: np.ndarray,
               num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr int64, indices int32) from COO edges (src -> dst, grouped
    by dst in the order given): a counting sort."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    e = src.shape[0]
    if dst.shape[0] != e:
        raise ValueError(f"{e} sources for {dst.shape[0]} destinations")
    if e and not (0 <= int(dst.min()) and int(dst.max()) < num_nodes):
        raise ValueError(f"a destination is outside the {num_nodes} nodes")
    indptr = np.zeros(num_nodes + 1, np.int64)
    indices = np.empty(e, np.int32)
    load_library().coo_to_csr(_ptr(src), _ptr(dst), e, num_nodes,
                              _ptr(indptr), _ptr(indices))
    return indptr, indices


def coo_to_csr_plain(src: np.ndarray, dst: np.ndarray,
                     num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=indptr[1:])
    return indptr, np.asarray(src, np.int32)[order]
