"""The sampling kernel (K4's counterpart) alone, timed with a warm and a
cold L2 at the hop shapes of the port's paths.

    python legion_tpu_torch/tools/k4_bench.py --gen      # once: the inputs
    python legion_tpu_torch/tools/k4_bench.py [TREE]

Run as a script from a repository root on a machine with the card.

With ``--gen`` it makes the inputs with this checkout's port and saves
them to ``.bench_cache/k4_bench/`` in the working directory: the CSR of
``bench_graph()`` and of ``tools/pa_cell.py``'s dataset (generated into
``.bench_cache/`` unless ``chip_smoke.py``'s phase 6 already made it
there), and for each path one batch of seeds sampled by ``sample_batch`` at
that path's caps, cut into the frontier each hop samples from, with
seeded uniforms and the traffic ``ops/sample.py::sample_traffic`` counts:

* ``main``: ``bench_graph()``, the caps the ``Trainer`` probes at slack
  1.03 (chip_smoke.py's phase 3 reads (8000, 121856, 1340416));
* ``mesh_dp``: ``bench_graph()``, ``MeshTrainer``'s loose caps (8000,
  208000, 2288000);
* ``cached``: the papers100M-class graph, ``dedup_last``, the cached
  driver's probed caps (phase 6 reads (9600, 84464, 492184));
* ``partitioned``: the same graph at the loose caps (at world size 1 the
  rank's compact CSR is the whole graph).

With ``TREE`` (a checkout, e.g. a ``git archive`` of another commit
unpacked into a gitignored directory; default: this one) it imports that
tree's ``legion_tpu_torch``, builds its kernels, holds the kernel bitwise
against its plain version on every hop and on ``ragged_cases()``, and
times it with ``chip_smoke.py``'s ``time_ms`` (this checkout's): ``ms``
with a warm L2, ``cold_ms`` with the L2 flushed before each call. It
prints the card's name and power limit and one JSON line holding each
hop's times beside its bound (useful bytes at 3.35 TB/s) and its sector
time, and the ptxas lines of the tree's build for the kernel. Compare two
trees in one call, in the order A, B, B, A.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

MAIN_CAPS = (8000, 121856, 1340416)
LOOSE_CAPS = (8000, 208000, 2288000)
CACHED_CAPS = (9600, 84464, 492184)
FANOUTS = (25, 10)
# path -> (graph, caps, dedup_last)
PATHS = {"main": ("main", MAIN_CAPS, False),
         "mesh_dp": ("main", LOOSE_CAPS, False),
         "cached": ("pa", CACHED_CAPS, True),
         "partitioned": ("pa", LOOSE_CAPS, True)}
KERNEL = "sample_neighbors_kernel"


def ragged_cases(seed=0):
    """The kernel's ragged edges, as (name, indptr, indices, frontier, u)
    CPU tensors over one CSR of 2^24 + 64 nodes: frontiers of 1, 31, 33
    and 8017 rows (one tile, one short, one and a row, many and a short
    last one) with fanouts 1, 7, 10, 25, 32, 33 and 64; degrees 0, 1,
    below and above the fanout and 70,000 (> 2^16); node and neighbor ids
    past 2^24; -1 padding, a whole tile of -1 and a whole tile of degree-0
    nodes; and every seventh uniform just below 1.0."""
    import torch
    rng = np.random.default_rng(seed)
    n = (1 << 24) + 64
    pattern = [0, 1, 2, 6, 9, 10, 11, 24, 25, 31, 32, 33, 63, 64, 65,
               70_000]
    deg = np.zeros(n, np.int64)
    ends = np.r_[np.arange(64), np.arange(n - 64, n)]
    deg[ends] = rng.permutation(np.tile(pattern, 8))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, 2 ** 31 - 1, int(indptr[-1]), dtype=np.int64)
    zero = ends[deg[ends] == 0]
    hub = ends[deg[ends] == 70_000][-1]                  # an id past 2^24
    top = np.nextafter(np.float32(1), np.float32(0))
    indptr_t = torch.from_numpy(indptr.astype(np.int32))
    indices_t = torch.from_numpy(indices.astype(np.int32))
    out = []
    for p in (1, 31, 33, 8017):
        frontier = rng.choice(np.r_[-1, ends], p)
        frontier[0] = hub
        if p > 96:
            frontier[32:64] = -1
            frontier[64:96] = rng.choice(zero, 32)
        for f in (1, 7, 10, 25, 32, 33, 64):
            u = rng.random((p, f), dtype=np.float32)
            u.reshape(-1)[::7] = top
            out.append((f"p{p}_f{f}", indptr_t, indices_t,
                        torch.from_numpy(frontier.astype(np.int32)),
                        torch.from_numpy(u)))
    return out


def ptxas_lines(log_path, kernel=KERNEL):
    """The ptxas lines of ``kernel`` in an nvcc ``-Xptxas -v`` log: from
    its "Compiling entry function" line to its "Used N registers" line."""
    lines, keep = [], False
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                keep = kernel in line
            if keep:
                lines.append(line.strip())
                if "Used" in line and "registers" in line:
                    keep = False
    return lines


def generate(cache):
    """Save both graphs' CSR and every path's hop inputs under ``cache``."""
    import torch

    from chip_smoke import hop_frontiers
    from legion_tpu_torch.data.synthetic import bench_graph
    from legion_tpu_torch.ops.sample import sample_traffic
    from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
    from legion_tpu_torch.tools import pa_cell
    dev = torch.device("cuda")
    os.makedirs(cache, exist_ok=True)
    graphs = {"main": bench_graph(),
              "pa": pa_cell.dataset(os.getcwd())[0]}
    cases = {}
    for i, (path, (gname, caps, dedup_last)) in enumerate(PATHS.items()):
        data = graphs[gname]
        graph = DeviceGraph.from_host(data.indptr, data.indices, "cuda")
        seeds = torch.tensor(np.asarray(data.train_ids[:8000]), device=dev)
        batch = sample_batch(graph, seeds,
                             torch.tensor(8000, dtype=torch.int32,
                                          device=dev),
                             torch.zeros_like(seeds), FANOUTS, caps,
                             dedup_last=dedup_last,
                             generator=torch.Generator(
                                 device=dev).manual_seed(i))
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        for hop, (fr, f) in enumerate(zip(hop_frontiers(batch, caps),
                                          FANOUTS), 1):
            u = torch.rand((fr.shape[0], f), generator=gen, device=dev)
            cases[f"{path}_hop{hop}"] = {
                "graph": gname, "frontier": fr.cpu(), "u": u.cpu(),
                **sample_traffic(graph.indptr, fr, u)}
        del graph, batch
    for gname, data in graphs.items():
        for name in ("indptr", "indices"):
            np.save(os.path.join(cache, f"{gname}_{name}.npy"),
                    np.asarray(getattr(data, name), dtype=np.int32))
    torch.save(cases, os.path.join(cache, "cases.pt"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?")
    ap.add_argument("--gen", action="store_true",
                    help="make and save the inputs, then exit")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tree = os.path.abspath(args.tree or here)
    cache = os.path.join(os.getcwd(), ".bench_cache", "k4_bench")
    sys.path.insert(0, here)
    from chip_smoke import PEAK_BYTES_PER_S, bound, time_ms
    sys.path.insert(0, tree)
    import torch

    import legion_tpu_torch
    got = os.path.dirname(os.path.dirname(os.path.abspath(
        legion_tpu_torch.__file__)))
    if got != tree:
        raise SystemExit(f"imported legion_tpu_torch from {got}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("k4_bench.py needs a CUDA device")
    if args.gen:
        generate(cache)
        return
    from legion_tpu_torch.ops import _build
    from legion_tpu_torch.ops.sample import (sample_neighbors,
                                             sample_neighbors_plain)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    _build.load_library()
    ragged = ragged_cases()
    ragged_csr = [t.to(dev) for t in ragged[0][1:3]]   # shared by every case
    for name, _, _, frontier, u in ragged:
        a = (*ragged_csr, frontier.to(dev), u.to(dev))
        if not torch.equal(sample_neighbors(*a), sample_neighbors_plain(*a)):
            raise SystemExit(f"ragged case {name}: the kernel differs from "
                             "its plain version")
    csr = {}
    cases = torch.load(os.path.join(cache, "cases.pt"))
    out = {"tree": args.tree, "nvidia_smi": smi,
           "ptxas": ptxas_lines(_build.library_path().with_suffix(".log")),
           "ragged_cases": len(ragged), "hops": {}}
    for name, c in cases.items():
        g = c["graph"]
        if g not in csr:
            csr[g] = [torch.from_numpy(np.load(os.path.join(
                cache, f"{g}_{n}.npy"))).to(dev) for n in ("indptr",
                                                          "indices")]
        a = (*csr[g], c["frontier"].to(dev), c["u"].to(dev))
        if not torch.equal(sample_neighbors(*a), sample_neighbors_plain(*a)):
            raise SystemExit(f"{name}: the kernel differs from its plain "
                             "version")
        rec = {"shape": list(c["u"].shape), "valid_slots": c["valid_slots"],
               "useful_bytes": c["useful_bytes"],
               "sector_bytes": c["sector_bytes"],
               **bound(c["useful_bytes"], 3 * c["valid_slots"]),
               "sector_ms": 1e3 * c["sector_bytes"] / PEAK_BYTES_PER_S,
               "ms": time_ms(lambda: sample_neighbors(*a)),
               "cold_ms": time_ms(lambda: sample_neighbors(*a), cold=True)}
        out["hops"][name] = rec
    print(smi, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
