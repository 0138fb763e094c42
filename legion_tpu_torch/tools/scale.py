"""What the full-size scale tools (``smoke_pa_scale``, ``smoke_uk_scale``)
and ``chip_smoke.py``'s ``bigcsr`` phase share: the device they run on, the
card's name and power limit, the host's peak resident set, the driver's
set-up seconds, the host seconds spent in the captured device stages,
and the host CSR whose every real adjacency run starts past edge 2^31
beside its twin.

``holed_twins`` puts a graph's runs past 2^31 without generating billions
of edges: a new node 0 owns a run of ``hole`` edges that is a hole in a
sparse indices file (the layout of ``tests/test_bigcsr.py``), and every
real node's id, run, feature row and label moves up by one. No edge, seed
or eval id names node 0, so nothing reads the hole. The twin is the same
graph with node 0 of degree 0: it maps the same indices file past the
hole, so each real node has the same adjacency in both and only the
offsets differ. Where the filesystem writes holes out, the hole costs
its full ``4 * hole`` bytes of disk, so ``holed_twins`` refuses such a
filesystem unless asked to write it.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Tuple
from unittest import mock

import numpy as np
import torch

from legion_tpu_torch.data.format import GraphData
from legion_tpu_torch.utils import trace

HOLE = (1 << 31) + (1 << 20)        # node 0's run: past 2^31 by 2^20 edges
HOLE_PROBE = 64 << 20               # the hole ``hole_bytes`` tries, bytes
_CHUNK = 1 << 26                    # elements copied at a time


def device_of(name: str) -> torch.device:
    """The device a tool runs on: the card unless ``--device cpu`` was
    asked for; a machine without a card raises rather than falling back."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is "
                         "False (pass --device cpu to run on the CPU)")
    return torch.device(name)


def card_line() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    None without a card."""
    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def resident_gb() -> float:
    """This process's resident set (``VmRSS``) in GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    raise RuntimeError("no VmRSS in /proc/self/status")


def with_peak_rss(fn: Callable, period: float = 0.01):
    """``fn()`` while a thread samples this process's resident set every
    ``period`` seconds. Returns (fn's result, the largest sample in GiB):
    a sampled peak, which a spike shorter than ``period`` can escape."""
    peak, done = [resident_gb()], threading.Event()

    def watch():
        while not done.wait(period):
            peak[0] = max(peak[0], resident_gb())

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        out = fn()
    finally:
        done.set()
        watcher.join()
    return out, max(peak[0], resident_gb())


@contextlib.contextmanager
def first_epoch_clock(trainer_cls):
    """Yields a dict whose ``"at"`` becomes the ``perf_counter`` time of the
    first ``trainer_cls.run_epoch`` call inside the block (where a
    driver's set-up ends), and ``"trainer"`` that call's trainer."""
    seen: Dict = {}
    run_epoch = trainer_cls.run_epoch

    def timed(self, *a, **k):
        seen.setdefault("at", time.perf_counter())
        seen.setdefault("trainer", self)
        return run_epoch(self, *a, **k)

    with mock.patch.object(trainer_cls, "run_epoch", timed):
        yield seen


def stage_seconds(spans: Dict) -> float:
    """The host seconds of the device stages' calls in ``spans`` (a
    tally's ``{name: [calls, total_s, self_s]}``): the ``stage.*`` spans
    (``train/graphed.py``), replays, eager dispatches and captures."""
    return sum(v[1] for k, v in spans.items() if k.startswith("stage."))


@contextlib.contextmanager
def timed_stages():
    """The host seconds spent in the device stages' calls (a replay, the
    eager dispatch of a stage's ops, or a capture) in the epochs that
    close inside the block: their ``stage.*`` spans (``utils/trace.py``'s
    ring, so at most ``trace.RING`` epochs), written into the one entry
    of the list this yields when the block ends."""
    spent = [0.0]
    before = trace.epochs()
    seen = {id(e) for e in before}
    try:
        yield spent
    finally:
        spent[0] = sum(stage_seconds(e["spans"]) for e in trace.epochs()
                       if id(e) not in seen)


def trim(data: GraphData, train: int, evals: int) -> GraphData:
    """``data`` with its first ``train`` train ids and first ``evals``
    valid and test ids (slices: a memmap is not read)."""
    data.train_ids = np.asarray(data.train_ids)[:train]
    data.valid_ids = np.asarray(data.valid_ids)[:evals]
    data.test_ids = np.asarray(data.test_ids)[:evals]
    return data


def disk_facts(path: str) -> Dict:
    """Host RAM, the disk under ``path`` and the cores: what decides
    whether a full-size graph can be generated and held."""
    os.makedirs(path, exist_ok=True)
    du = shutil.disk_usage(path)
    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: int(ln.split()[1]) * 1024 for ln in f}
    return {"ram_total_gb": mem["MemTotal"] / 2 ** 30,
            "ram_available_gb": mem["MemAvailable"] / 2 ** 30,
            "disk_total_gb": du.total / 2 ** 30,
            "disk_free_gb": du.free / 2 ** 30,
            "cores": len(os.sched_getaffinity(0))}


def shares(array: np.ndarray, mapped: np.ndarray, what: str) -> None:
    """Raise unless ``array`` is ``mapped``'s memory: a driver that copied
    a host memmap would hold it whole in RAM."""
    if not np.shares_memory(array, mapped):
        raise RuntimeError(f"{what} is a copy of the mapped file, not the "
                           "map itself")


def hole_bytes(directory: str) -> int:
    """The bytes the filesystem under ``directory`` allocates for a file
    of a ``HOLE_PROBE``-byte hole and 4 KiB after it: under ``HOLE_PROBE``
    where it keeps holes, more where it writes them out."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, ".hole_probe")
    try:
        with open(path, "wb") as f:
            f.seek(HOLE_PROBE)
            f.write(b"\0" * 4096)
        return os.stat(path).st_blocks * 512
    finally:
        os.remove(path)


def holed_twins(data: GraphData, directory: str, hole: int = HOLE,
                write_hole: bool = False
                ) -> Tuple[GraphData, GraphData, Dict]:
    """(big, twin, facts) for ``data`` with one more node, node 0, in front.
    In ``big`` node 0 owns the ``hole`` edges ``[0, hole)``, a hole in the
    sparse indices file ``<directory>/edge_dst``, so node v + 1's run
    starts at ``hole + data.indptr[v]``; in ``twin`` node 0 has degree 0
    and node v + 1's run starts at ``data.indptr[v]``, in the same file
    mapped from byte ``4 * hole``. Both share one shifted feature file.
    ``facts``: the file's logical and allocated bytes, the smallest start
    of a real run in ``big`` and the seconds taken. A filesystem that
    writes holes out (``hole_bytes``) would write ``4 * hole`` bytes: that
    raises before anything is written unless ``write_hole``."""
    t0 = time.perf_counter()
    if not write_hole and hole_bytes(directory) >= HOLE_PROBE:
        raise RuntimeError(
            f"the filesystem under {directory} writes holes out: the hole "
            f"of {hole} edges would take {4 * hole} bytes of disk (pass "
            "write_hole=True to write it all the same)")
    os.makedirs(directory, exist_ok=True)
    n, e = data.num_nodes, data.num_edges
    ind_path = os.path.join(directory, "edge_dst")
    with open(ind_path, "wb") as f:
        f.seek(4 * hole)
        for s in range(0, e, _CHUNK):
            (np.asarray(data.indices[s: s + _CHUNK], np.int64) + 1).astype(
                np.int32).tofile(f)
        f.truncate(4 * (hole + e))
    feat_path = os.path.join(directory, "features")
    dim = data.feature_dim
    with open(feat_path, "wb") as f:
        np.zeros(dim, np.float32).tofile(f)
        rows = max(_CHUNK // max(dim, 1), 1)
        for s in range(0, n, rows):
            np.asarray(data.features[s: s + rows], np.float32).tofile(f)
    features = np.memmap(feat_path, np.float32, "r", shape=(n + 1, dim))
    old = np.asarray(data.indptr, np.int64)
    ip_big = np.zeros(n + 2, np.int64)
    ip_big[1:] = old + hole
    ip_twin = np.zeros(n + 2, np.int64)
    ip_twin[1:] = old
    labels = np.zeros(n + 1, np.int32)
    labels[1:] = data.labels
    common = dict(features=features, labels=labels,
                  train_ids=np.asarray(data.train_ids, np.int32) + 1,
                  valid_ids=np.asarray(data.valid_ids, np.int32) + 1,
                  test_ids=np.asarray(data.test_ids, np.int32) + 1)
    big = GraphData(indptr=ip_big, indices=np.memmap(
        ind_path, np.int32, "r", shape=(hole + e,)), **common)
    twin = GraphData(indptr=ip_twin, indices=np.memmap(
        ind_path, np.int32, "r", offset=4 * hole, shape=(e,)), **common)
    st = os.stat(ind_path)
    facts = {"logical_bytes": st.st_size,
             "allocated_bytes": st.st_blocks * 512,
             "real_edges_bytes": 4 * e,
             "sparse": st.st_blocks * 512 <= 4 * e + (64 << 20),
             "smallest_real_run_start": int(ip_big[1]),
             "hole_edges": hole, "seconds": time.perf_counter() - t0}
    return big, twin, facts
