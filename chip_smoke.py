#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (legion_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

It imports only torch and legion_tpu_torch. It builds the port's CUDA
kernels from csrc/ with nvcc and its host runtime (csrc/gnnio.cpp) with
g++, then runs these phases, printing one JSON line for each but the
set-up. Each phase first writes ``phase <name> start <seconds>s`` to
stderr, so a failing check's traceback (``RuntimeError: check failed:
...``) follows the name of its phase; any failure raises and the script
exits non-zero:

1. toolchain: torch and CUDA versions, the card, nvcc, both builds;
2. set-up: the full-size products-scale synthetic graph and a
   ``Trainer`` with bench.py's configuration (SAGE-256, bf16, fanout
   [25,10], batch 8000), which probes its frontier caps;
3. kernels: one batch sampled at those caps, and each CUDA kernel held
   against its plain PyTorch version on the tensors that batch's step
   gives it, with the error against a stated tolerance and the median
   time of both (CUDA events, 20 reps after warm-up): the sampling kernel
   bitwise at the batch's two hop shapes (beside its byte bound, the
   distinct 32-byte sectors its reads touch and their time at the memory
   peak, both from ``ops/sample.py::sample_traffic``, and also timed with
   the L2 flushed before each call, ``cold_ms``, as at every path below
   that checks it) and on the ragged cases of
   ``tools/k4_bench.py::ragged_cases`` (28 frontier and fanout shapes
   around the warp's tile; a failure raises), K3, K1 (also with GCN's
   "sqrt" norm), K2 forward and backward
   with every norm at SAGE's layer-1 shape in bf16 and at GCN float32's
   (the backward's zero fill, scatter kernel and cast pass timed apart)
   and K5 (``grouped_masked_sum``: float32 value and gradient on the
   batch's identity block, a bf16 case, and width 47 with a float mask);
   K3 and K5 are also timed beside the one PyTorch call that computes
   the same function (``index_select``, ``einsum``; K1 and K2: see
   below), and each kernel's
   time stands beside its bound: the larger of the bytes this batch
   makes it move over 3.35 TB/s and its operations over 67 TFLOP/s; then
   K2 on a tiny block with a position past its rows (NaN in exactly the
   plain version's rows, the slot dropped backward);
4. main path: two training epochs and a validation pass through the
   ``Trainer``, whose train and eval steps are captured as CUDA graphs
   and replayed (``train/graphed.py``; a replay adds the launches its
   capture recorded to each wrapper's count); every kernel's launch count
   over that run must be > 0 but K5's, which SAGE does not reach, and the
   gathered feature mean's, the cached path's (the activation-dropout
   forward and backward, in the kernel table like every kernel, are
   counted and held on every full-width path below: once a train step
   after each layer but the last, never in an eval step). Then GCN at
   the same width on the same graph, one epoch and a validation pass each in bf16 and in
   float32: finite losses, no cap overflow, one batch's logits against
   the plain versions on the CPU, and exact launch counts (bf16: K1 once
   per train and eval step, K2 forward once per step and backward once
   per train step, K5 never; float32: K5 once per train and eval step,
   K1 never; both: the activation-dropout forward and backward once per
   train step), held again in a ``torch.profiler`` trace of 5 replays of
   the captured step (each kernel by name). Then GAT (``"gat"``: PyG's
   ogbn-products example, 3 layers of 4 heads of 128, fanout [10,10,10],
   every hop deduplicated, bf16): its edge-softmax kernels against their
   plain version at layer 0's and layer 2's shapes on one batch (output
   and dz within 1 bf16 ulp, the score gradients element by element
   within 1 bf16 ulp plus 1e-4 of the magnitude of the terms each sums,
   a check that must refuse da_src with its ordinary rows zeroed; times,
   plain time and byte bound), one epoch and a validation
   pass (finite losses, no cap overflow, scored slots counted), and the
   launches a step, counted and traced: the attention's forward and
   backward 3 times each, the sampling kernel and the dedup's tail 3
   times, K3 once, the activation-dropout forward and backward twice
   (none in the validation pass). Then the activation and dropout
   between layers (``"act_dropout"``, ``check_act_dropout``): its two
   kernels at the main path's layer-0 shape (its hop-1 cap x 256 bf16,
   ReLU) and GAT's (its layer-0 dst cap x 512 bf16, ELU), rate 0.5,
   against the plain chain from the same generator state (ReLU's output,
   gradient and mask bitwise, ELU's within 1 bf16 ulp), warm and cold ms
   beside the byte bound and the chain's ms;
5. learning: the reference's verify recipe (50k-node planted-label
   graph, 2 epochs) must reach validation accuracy > 0.15 (7x chance),
   one batch's logits from the kernels must match the plain versions on
   the CPU, and the cached driver on the same graph, with a budget that
   caches a quarter of its rows, must reach > 0.15 as well. On the same
   graph: GCN (float32, 2 epochs; judged by a falling loss, since GCN
   has no self-feature path and stays near chance here); LP-SAGE (batch
   1023, 2 epochs through the ``Trainer`` and 1 through the cached
   driver: a finite, falling loss, an eval LP loss within a factor 5 of
   the train loss, the "Val LP-loss" label); and checkpoint and resume
   (a ``Trainer`` saves after one epoch, a fresh one on the directory
   resumes at epoch 1 with equal parameters and generator state, and
   its next epoch's losses match the first trainer's own next epoch);
   and the hybrid driver (``"hybrid_learn"``: host CSR, hot sub-CSR on
   the card, a budget of a quarter of the feature rows plus a quarter of
   the adjacency bytes for the cost model to split, SAGE-256 float32, 2
   epochs) must reach > 0.15 with both caches fed and both sampling legs
   used;
6. cached path at papers100M class (``legion_tpu_torch.tools.pa_cell``):
   ``run_cached_training`` with tools/smoke_pa_scale.py's configuration
   (SAGE-256 bf16, fanout [25,10], batch 8000, host-resident features, 6
   presample steps) on a streamed power-law graph of 2^24 + 2^20 nodes
   (cut from 111,059,956) and avg degree 14, generated once into
   .bench_cache/ and loaded by mmap, with the cache budget scaled by the
   same cut (164 MiB); two epochs of 10 training steps, each followed by
   eval on 2 x 8000 valid seeds. Epoch 0 carries the warm-up; epoch 1's
   ms/step is the steady state. Its losses must be finite, its hit rate
   inside (0, 1), its host bytes > 0 in both epochs, its sampled frontier
   must hold ids >= 2^24, the sampling kernel, K2 forward and backward
   and K3 must have launched, the sampling kernel must be bitwise its
   plain version on the path's hop-1 and hop-2 inputs, and K2 forward and
   backward must agree with their plain versions, for every norm, on that
   batch's layer-1 block at the path's width (172 columns, bf16), and the
   gathered feature mean (layer 0, which widens) with its plain version
   on that batch's layer-0 block over seeded bf16 rows 128 wide, timed
   warm and cold beside the PyTorch chain it replaced;
7. the dedup (``"dedup"``): ``grow_frontier``'s tail after its sort, the
   kernel (``ops/dedup.py``) against its plain version on the same sorted
   tensors, bitwise and with no host sync, at hop 1 of the main-path
   batch and both hops of a cached-path batch: the kernel's time beside
   its byte bound, the plain version's and ``torch.cummax``'s on a row of
   the hop's length (the scan the kernel replaced);
8. the host-topology path at uk-union class (``"hybrid_path"``;
   ``legion_tpu_torch.tools.hybrid_cell``): ``run_hybrid_training`` with
   tools/smoke_uk_scale.py's configuration on phase 6's graph, whose CSR
   stays in host memory (an mmap): host presample, the cost model
   splitting 273 MiB between the feature cache and the hot sub-CSR, two
   epochs of 10 steps with eval. Finite losses, both caches fed, hit and
   hot fractions inside (0, 1), exactly 2 reads a step plus one an epoch,
   no cap overflow, ids >= 2^24 in a sampled frontier, and exact launch
   counts: the sampling kernel twice a step plus once an epoch (on the
   sub-CSR), K2 forward once a step, backward once a train step, K3
   twice a step, the gathered feature mean once a step (layer 0 widens),
   K1 and K5 never.

9. data-parallel training (``"mesh_dp"``, run after phase 4 on its graph):
   ``MeshTrainer`` at world size 1 through NCCL with the main path's
   configuration at the reference's loose caps (no probe), one epoch and a
   validation pass, its first 5 losses against a ``Trainer`` with
   ``probe_caps=False`` within 1e-3 relative, one all-reduce of the
   parameter bytes a step through the counting wrapper, exact launch
   counts, and ms/step beside the Trainer's; then every kernel of the
   path against its plain version on one batch at those loose caps (the
   sampling kernel on both hops, K3 on the whole frontier, K1 on the
   identity block, K2 forward and backward on layer 1's block);
10. the command line (``"cli"``, last): ``python -m legion_tpu_torch.train``
   as a subprocess on the card: the verify recipe (50k nodes, 2 epochs,
   batch 1024) above 0.15 with the test line, ``--topology host`` with no
   budget (warns, both caches empty), ``--devices 2`` on one card (exits
   non-zero naming the card count), and ``--partitioned --devices 1`` on
   the verify recipe (one NCCL rank) above 0.15 with the test line;
11. the cache-group paths at world size 1 through NCCL (``"mesh_striped"``,
   cut from the reference's 4-8 ranks to the machine's one card), each
   against its single-device twin in this call: ``MeshTrainer`` on
   ``feature_placement="hbm_sharded"`` with ``mesh_dp``'s configuration
   (run right after it on its graph), ``run_cached_training`` on a mesh
   on phase 6's cell and ``run_hybrid_training`` on a mesh on phase 8's.
   Step 0's
   loss bitwise, the rest within ``STRIPED_LOSS_RTOL`` (bf16: 1e-4);
   equal hit rate, hot fraction, staging overflow, host bytes and packed
   reads; no exchange overflow; exact launches (K3 once more a step than
   the twin:
   the exchange's serve and reassembly); the exchange's bytes the closed
   form's; and on one batch of each path's own tensors the sampling
   kernel (on the hybrid path: on the sub-CSR stripe with the rows the
   exchange hands the owner), K3 on the exchange's two gathers and K2
   against their plain versions;
12. the same three paths at cache axis 2 against cache axis 1
   (``"mesh_striped_k2"``, ``legion_tpu_torch.tools.cache_group_cell``):
   two gloo ranks sharing the card, every collective staged through host
   memory (behaviour, not speed), on the learning smoke's graph: bitwise
   feature matrices and hot draws, losses within ``STRIPED_LOSS_RTOL``
   (float32: 1e-5), bytes equal to the closed forms, the same launches at
   both axes, and the striped cached run's validation accuracy > 0.15
   after 2 epochs;
13. the edge-partitioned path at world size 1 through NCCL
   (``"mesh_partitioned"``, cut from the reference's 2-8 ranks to the
   machine's one card, so the exchange makes no collective): the driver on
   phase 6's graph, SAGE-256 bf16, batch 8000, the loose caps, two epochs
   of 10 steps with eval: finite losses, no halo overflow, exact launch
   counts, one batch bitwise the same through the exact and the psum
   exchange (NCCL all-gather and reduce-scatter) with ids >= 2^24, its
   logits within 3e-2 x max|logit| of the CPU plain path; the sampling
   kernel on the compact CSR, K3 on the self-served gather and K2 on
   layer 1's block against their plain versions, and K2 at layer 0's block
   shape, which the path does not run (layer 0 widens and takes the
   gathered feature mean); set-up seconds
   (partition, shard, owner table), peak host RSS and device memory,
   ms/step and edges/s beside phase 6's ms/step;
14. the same path at two gloo ranks sharing the card against one rank
   (``"mesh_partitioned_k2"``, ``legion_tpu_torch.tools.partition_cell``;
   behaviour, not speed) on the learning smoke's graph, greedy partition:
   exact and psum draws and rows bitwise equal on one batch, the
   collective-permute bytes the closed forms', no halo overflow,
   validation accuracy > 0.15 at both world sizes, and the launches per
   step the CPU test pins;
15. a user's path from an OGB dataset (``"ogb_products"``, before
   ``cli``): ``legion_tpu_torch.tools.products_cell``'s stand-in for
   ogbn-products at its published shapes (2,449,029 nodes, 61,859,140
   edges, 100 float32 features, planted labels in 47 classes; generated
   once into .bench_cache/), converted by ``data/ogb.py`` into a fresh
   directory (seconds and peak host RSS; ``meta.json`` equal to the
   registry's ``PR`` entry), trained through the parity harness
   (``tools/parity_ogb.py``, in this process: SAGE-256 bf16, batch 8000,
   3 epochs, verdict PASS above 0.15, finite losses, no cap overflow,
   launches per step equal to the main path's), every kernel held against
   its plain version on one batch of a ``Trainer`` on the packed
   directory, and ``python -m legion_tpu_torch.train --dataset PR
   --data-dir <packed>`` for one epoch (exit 0, finite loss, the test
   line), with ms/step beside the main path's.

16. the benchmark's entry point (``"bench"``, right after phase 4, on its
   graph; ``legion_tpu_torch.bench``): in this process both variants of
   ``run_variant`` at full width for 40 steps (a warm-up pass and two
   timed trials), ``fanout`` launching per step exactly what the main
   path does and ``coo_segment`` K3 once and the sampling kernel twice,
   no K1 or K2; then the graph saved into a fresh cache directory and
   ``python -m legion_tpu_torch.bench`` run there twice at its defaults,
   each printing one line with bench.py's keys, positive ``value`` and
   ``step_ms`` and ``kernel_gate`` "pass" (the gate of
   ``tools/bench_kernels.py``, whose ``time_ms`` and ``bound`` this script
   shares), the second reading the caps and baseline memos the first
   wrote. Both lines are printed after the phase's own.

17. captured against eager steps (``"graphed"``, right after phase 4, on
   its ``Trainer``): beside it a second ``Trainer`` of the same
   configuration, stepped eagerly (``fns.train_step``). One eager train
   and eval step under ``torch.cuda.set_sync_debug_mode("error")``; from
   one state, an epoch (24 steps) both ways with ``edges``, ``frontier``
   and ``cap_overflow`` equal step for step, losses within 1e-3
   relative, each parameter tensor within 5e-2 of the distance it moved
   (two eager runs' difference printed beside it),
   and equal validation counts from the captured and the eager eval on
   the same weights; equal launch counts, and 5 replays traced by
   ``torch.profiler`` showing each kernel as often as 5 eager steps do;
   then eager against graphed ms/step in alternating trials of 48 steps
   (median of 3), the host's enqueue time per step, the capture's
   seconds and the graph pool's bytes.

18. the mesh paths' captured steps (``captured_vs_eager``), run inside
   ``"mesh_dp"``, the ``hbm_sharded`` part of ``"mesh_striped"`` and
   ``"mesh_partitioned"`` (exact exchange, then a trainer of the same
   model and state through the psum exchange, whose 3 all-gathers and 3
   reduce-scatters a step run through NCCL), each at world size 1 on a
   NCCL group, whose steps replay CUDA graphs with their collectives
   inside: the eager twin is the same trainer's ``fns.train_step`` from
   the same state (loaded in place): one eager train and eval step under
   ``set_sync_debug_mode("error")``; edges, frontier, cap and halo
   overflow equal step for step, losses and parameters within phase 17's
   limits, equal eval counts and launches; the collectives counted after
   the replays equal to the eager steps' and to the closed forms (one
   all-reduce of the parameter bytes a step; ``hbm_sharded``: two
   all-to-alls of ``exact_exchange_bytes``); 5 replays traced, each
   kernel as bookkept, their NCCL kernels as 5 eager steps' (NCCL runs
   no kernel on one rank: its collectives there are copies, or nothing
   for an all-reduce in place; the device-to-device copies are printed,
   since a graph may run a copy as a kernel); eager and
   captured ms/step (median of 3 alternating trials of the epoch's
   steps), host enqueue, capture seconds and pool bytes; and a
   ``torch.profiler`` trace of 5 steady replays: the device's busy time,
   idle share and busy time by stage (``replay_profile``). The
   partitioned record adds the share of the last hop's frontier cap the
   sampled frontier leaves as padding.

19. the staged pipelines' captured device stages (``staged_vs_eager``),
   under ``"captured"`` in ``"cached_path"``, ``"hybrid_path"`` and the
   striped cached and striped hybrid parts of ``"mesh_striped"`` (one
   NCCL rank, the exchanges' collectives inside the graphs): the path's
   trainer on a capturing pool against its twin on the same tables and
   model without one. From one state (loaded in place), a captured epoch
   (the warm-ups and captures), two eager ones and a captured one again:
   equal figures (hit rate, host bytes, staging and exchange overflow,
   edges; on the hybrid paths the hot fraction, both host topology
   meters, fetches = 2 a step + 1 and the trainer's hot and cold counts),
   losses within 1e-3 relative or the two eager runs' difference if
   larger, equal launches and collectives, the latter equal to the
   closed forms on the striped paths; a steady captured epoch traced,
   each kernel by name as bookkept and as the eager epoch launched it,
   with the device's busy ms and idle share; eager against captured
   ms/step in 3 alternating epochs (median), the host's seconds in the
   stages' calls (enqueue) and in its legs (staging, host sampler,
   packed reads), the capture's seconds and the pool's bytes.

20. the host-topology path past edge 2^31 (``"bigcsr"``, right after
   phase 8, on its graph): ``legion_tpu_torch.tools.scale.holed_twins``
   copies the graph with a leading node 0 whose run of 2^31 + 2^20 edges
   is a hole in the indices file (no edge, seed or eval id names it;
   every real node, its run, feature row and label moves up by one), so
   every real run starts past edge 2^31, beside a twin where node 0 has
   degree 0. ``run_hybrid_training`` (its stages captured) and
   ``run_hybrid_training`` on a mesh of one NCCL rank run two epochs each
   on the big CSR: phase 8's checks (finite losses, both caches fed, hit
   and hot fractions inside (0, 1), 2 reads a step plus one, exact
   launches), a steady epoch traced with each kernel as bookkept, the
   striped losses within ``STRIPED_LOSS_RTOL`` of the hybrid's, and the
   trainers reading the mapped files in place (``np.shares_memory``).
   Against the twin, bitwise: the host presample's counts past node 0,
   ``TopoCache.build``'s and ``StripedTopoCache.build``'s sub-CSRs for
   the same hot ids, and the C++ sampler's draws for one batch's cold
   ids at every hop. The sampling kernel, K2 and K3 are held against
   their plain versions on one more batch, as in phase 8. The line gives
   the indices file's logical and allocated bytes, the smallest real run
   start, the twin's build seconds (``gen_s``) and the phase's seconds.

K1 and K2 (forward and backward) are also timed beside
``torch.nn.functional.embedding_bag`` on the same rows (masked slots
pointed at a row no valid slot reads, given as ``padding_idx``; the
index built outside the timed window): mode "mean" (GCN float32's K2
shape: "sum"), and its backward to the table for K2's; "sqrt" has no
such call.

Then it prints the card's name and power limit as nvidia-smi reports
them, a JSON line with every kernel's numbers, and, last,
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
at once and prints no result.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from fractions import Fraction

# the kernels' comparisons, timing and bounds, shared with the port's
# kernel gate
from legion_tpu_torch.tools.bench_kernels import (
    PEAK_BYTES_PER_S, bound, compare_gather_rows, compare_grouped_sum,
    compare_identity_mean, compare_k2_backward, compare_k2_forward,
    compare_sample, time_ms, within_bf16, within_f32)
# the host's resident set and the card's name, shared with the scale tools
from legion_tpu_torch.tools.scale import card_line, resident_gb, with_peak_rss

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "legion_tpu_torch/csrc/legion_kernels.cu"

# bench_graph's full size (the ogbn-products stand-in) and its classes
NODES, CLASSES = 2_449_029, 47

# the width of the raw rows the gathered feature mean is checked and
# timed on: the benchmark's papers100M cell's 128 features
FEATURE_MEAN_WIDTH = 128

# what the kernels line holds of each kernel, beside its launch counts
KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def kernel_table():
    """name -> (wrapper holding the launch count, TPU kernel it replaces)."""
    from legion_tpu_torch.ops.act_dropout import (act_dropout,
                                                  act_dropout_backward)
    from legion_tpu_torch.ops.dedup import dedup_tail
    from legion_tpu_torch.ops.gather import gather_rows
    from legion_tpu_torch.ops.identity_agg import (
        gathered_feature_mean, gathered_masked_mean,
        gathered_masked_mean_backward, identity_masked_mean)
    from legion_tpu_torch.ops.sample import sample_neighbors
    from legion_tpu_torch.ops.spmm import grouped_masked_sum
    return {
        "identity_masked_mean": (
            identity_masked_mean,
            "legion_tpu/ops/identity_agg_pallas.py:137"),
        "gathered_masked_mean": (
            gathered_masked_mean,
            "legion_tpu/ops/identity_agg_pallas.py:261"),
        "gathered_masked_mean_backward": (
            gathered_masked_mean_backward,
            "legion_tpu/ops/identity_agg_pallas.py:225"),
        "gather_rows": (gather_rows, "legion_tpu/ops/gather_pallas.py:68"),
        "sample_neighbors": (sample_neighbors,
                             "legion_tpu/ops/select_pallas.py:46"),
        "grouped_masked_sum": (grouped_masked_sum,
                               "legion_tpu/ops/spmm_pallas.py:90"),
        # no TPU kernel: the JAX dedup is jnp operations
        "dedup_tail": (dedup_tail, None),
        # no TPU kernel: the reference leaves this mean to XLA
        "gathered_feature_mean": (gathered_feature_mean, None),
        # no TPU kernel: the reference leaves the activation and the
        # dropout between layers to XLA
        "act_dropout": (act_dropout, None),
        "act_dropout_backward": (act_dropout_backward, None),
    }


def reset_launches(kernels):
    for fn, _ in kernels.values():
        fn.launches = 0


def read_launches(kernels):
    import torch
    torch.cuda.synchronize()
    return {name: fn.launches for name, (fn, _) in kernels.items()}


def toolchain():
    """Phase 1: the card, the toolchain and the kernel build. Returns the
    nvidia-smi line (name, power limit)."""
    import torch

    from legion_tpu_torch import runtime
    from legion_tpu_torch.ops import _build
    smi = card_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    kernel_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runtime.load_library()
    emit({"phase": "toolchain", "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "nvcc": nvcc, "kernel_build_s": kernel_build_s,
          "host_runtime_build_s": time.perf_counter() - t0,
          "host_runtime_threads": runtime.max_threads(),
          "library_was_prebuilt": prebuilt})
    return smi


def check_sampling_kernel(graph, frontiers, fanouts, seed):
    """The sampling kernel bitwise against its plain version on each hop's
    (frontier, uniforms), and both timed; the kernel with a warm L2
    (``ms``) and a cold one (``cold_ms``). Returns per-hop records, each
    with ``bound_ms`` (the useful bytes) and ``sector_ms`` (the distinct
    32-byte sectors those reads touch) at the memory peak, both counted by
    ``ops/sample.py::sample_traffic``."""
    import torch

    from legion_tpu_torch.ops.sample import (sample_neighbors,
                                             sample_neighbors_plain,
                                             sample_traffic)
    gen = torch.Generator(device=graph.indptr.device).manual_seed(seed)
    out = []
    for fr, f in zip(frontiers, fanouts):
        u = torch.rand((fr.shape[0], f), generator=gen,
                       device=fr.device, dtype=torch.float32)
        args = (graph.indptr, graph.indices, fr, u)
        c = compare_sample(*args)
        require(c.ok, f"sample_neighbors at {tuple(u.shape)} "
                "is bitwise its plain version")
        k = c.out
        traffic = sample_traffic(graph.indptr, fr, u)
        valid = traffic["valid_slots"]
        require(valid == int((k >= 0).sum()),
                "sample_traffic counts the kernel's valid slots")
        # ~3 operations per valid slot: a multiply, a conversion, a min
        out.append({"shape": list(u.shape), "valid_slots": valid,
                    **bound(traffic["useful_bytes"], 3 * valid),
                    "library_ms": None,
                    "sector_bytes": traffic["sector_bytes"],
                    "sector_ms": (1e3 * traffic["sector_bytes"]
                                  / PEAK_BYTES_PER_S),
                    "max_abs_err": c.max_abs_err,
                    "ms": time_ms(lambda: sample_neighbors(*args)),
                    "cold_ms": time_ms(lambda: sample_neighbors(*args),
                                       cold=True),
                    "plain_ms": time_ms(
                        lambda: sample_neighbors_plain(*args))})
    return out


def check_sampling_sweep():
    """The sampling kernel bitwise against its plain version on
    ``tools/k4_bench.py::ragged_cases`` (ragged tiles, fanouts past the
    warp, degree 0 and > 2^16, ids past 2^24, all -1 tiles, uniforms just
    below 1). Raises on the first that differs; returns the case count."""
    from legion_tpu_torch.tools.k4_bench import ragged_cases
    cases = ragged_cases()
    csr = [t.cuda() for t in cases[0][1:3]]      # one CSR for every case
    for name, _, _, frontier, u in cases:
        require(compare_sample(*csr, frontier.cuda(), u.cuda()).ok,
                f"sample_neighbors on ragged case {name} is bitwise its "
                "plain version")
    return len(cases)


def check_gather_rows(table, ids):
    """K3 bitwise against its plain version on (table, ids), both timed,
    beside ``torch.index_select`` (which zeroes no -1 row, so it is timed
    on the clamped ids). Returns (the kernel's rows, the record)."""
    import torch

    from legion_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    c = compare_gather_rows(table, ids)
    require(c.ok, f"gather_rows at {[*table.shape]} by "
            f"{ids.shape[0]} ids is bitwise its plain version")
    # each distinct valid row read once (ids may repeat), every output
    # row written once
    row_bytes = table.shape[1] * table.element_size()
    distinct = int(torch.unique(ids[ids >= 0]).numel())
    idx = ids.clamp(min=0).long()
    return c.out, {"shape": [*table.shape, ids.shape[0]],
               "dtype": str(table.dtype).split(".")[-1],
               "valid_ids": int((ids >= 0).sum()),
               **bound(4 * ids.numel() + (distinct + ids.numel()) * row_bytes,
                       0),
               "max_abs_err": c.max_abs_err,
               "ms": time_ms(lambda: gather_rows(table, ids)),
               "plain_ms": time_ms(lambda: gather_rows_plain(table, ids)),
               "library_ms": time_ms(
                   lambda: torch.index_select(table, 0, idx))}


def hop_frontiers(batch, caps):
    """The frontier each hop sampled from: the seeds padded to caps[0],
    then the first caps[k] entries of the final frontier with the slots
    past hop k's valid count set to -1 (prefix numbering)."""
    import torch
    fr = [torch.full((caps[0],), -1, dtype=torch.int32,
                     device=batch.seeds.device)]
    fr[0][: batch.seed_cap] = batch.seeds
    for k, blk in enumerate(batch.blocks[:-1]):
        head = batch.frontier[: caps[k + 1]]
        idx = torch.arange(caps[k + 1], device=head.device)
        fr.append(torch.where(idx < blk.num_src, head, -1))
    return fr


NORMS = ("mean", "sqrt", "sum")


def check_k2(h_t, pos, mask, g, norm):
    """K2 forward and backward against their plain versions on one block:
    h_t (S, D), pos and mask (P, f), upstream gradient g (P, D) in h_t's
    type; every norm is checked, ``norm`` is timed. Forward in bf16
    within 1 bf16 ulp relative (8e-3) plus 1e-3 (two f32 sums in different
    orders can flip one rounding), in float32 within 1e-5 of the summed
    magnitudes. Backward in float32 within 1e-5 of the summed magnitudes
    of the terms scattered into each element (atomics add in any order),
    and in bf16, as the step runs it, within 8e-3 of them (both sides
    round an f32 sum once): ``compare_k2_forward`` and
    ``compare_k2_backward``. Returns the forward's and the backward's
    record; the backward's holds ``parts_ms``: the zero fill, the scatter
    kernel and the cast pass timed apart."""
    import torch

    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean, gathered_masked_mean_backward,
        gathered_masked_mean_backward_plain, gathered_masked_mean_plain,
        narrow_rows, scatter_masked_rows, staging_width)
    (p, f), (s, d) = mask.shape, h_t.shape
    es, low = h_t.element_size(), h_t.dtype == torch.bfloat16
    what = f"K2 at {[p, f, s, d]} {h_t.dtype}"
    fwd_err, bwd_err = {}, {}
    for nm in NORMS:
        c = compare_k2_forward(h_t, pos, mask, nm)
        require(c.ok, f"{what}: forward, norm {nm}, within tolerance")
        fwd_err[nm] = c.max_abs_err
        c = compare_k2_backward(g.float(), pos, mask, s, nm, torch.float32)
        require(c.ok, f"{what}: backward, norm {nm}, within 1e-5 in f32")
        bwd_err[nm] = c.max_abs_err
        if low:
            require(compare_k2_backward(g, pos, mask, s, nm).ok,
                    f"{what}: backward, norm {nm}, within 8e-3 in bf16")
        del c
    slots = int(mask.sum())
    rows = int(torch.unique(pos[mask]).numel())
    shape = {"shape": [p, f, s, d], "dtype": str(h_t.dtype).split(".")[-1],
             "norm": norm, "valid_slots": slots}
    # embedding_bag over the same rows: the forward, and its backward to
    # the table alone (the graph kept, so only the backward is timed)
    idx, pad = bag_index(s, pos, mask)
    bag_bwd_ms = None
    if idx is not None and norm in ("mean", "sum"):
        import torch.nn.functional as F
        w = h_t.detach().requires_grad_(True)
        o = F.embedding_bag(idx, w, mode=norm, padding_idx=pad)
        bag_bwd_ms = time_ms(lambda: torch.autograd.grad(
            o, w, g, retain_graph=True))
        del w, o
    # the distinct rows the valid slots name read once, positions and mask
    # read, the dst rows written; one add per gathered element
    fwd = {**shape, "library_ms": library_bag(h_t, idx, pad, norm),
           **bound(rows * d * es + 5 * mask.numel() + p * d * es, slots * d),
           "max_abs_err": fwd_err[norm], "max_abs_err_by_norm": fwd_err,
           "ms": time_ms(lambda: gathered_masked_mean(h_t, pos, mask, norm)),
           "plain_ms": time_ms(
               lambda: gathered_masked_mean_plain(h_t, pos, mask, norm))}
    ld = staging_width(d, h_t.dtype)    # float32: d itself, no cast pass
    staging = torch.zeros((s, ld), dtype=torch.float32, device=h_t.device)
    # the upstream gradient, positions and mask read, every src row of the
    # gradient written; one add per scattered element
    bwd = {**shape, "library_ms": bag_bwd_ms,
           **bound(g.numel() * es + 5 * mask.numel() + s * d * es, slots * d),
           "max_abs_err": bwd_err[norm], "max_abs_err_by_norm": bwd_err,
           "ms": time_ms(
               lambda: gathered_masked_mean_backward(g, pos, mask, s, norm)),
           "plain_ms": time_ms(lambda: gathered_masked_mean_backward_plain(
               g, pos, mask, s, norm)),
           "staging_row_floats": ld,
           "parts_ms": {
               "fill": time_ms(lambda: torch.zeros(
                   (s, ld), dtype=torch.float32, device=h_t.device)),
               "scatter": time_ms(lambda: scatter_masked_rows(
                   g, pos, mask, staging, norm)),
               "cast": time_ms(lambda: narrow_rows(staging, d, h_t.dtype))}}
    return fwd, bwd


def compared(c, what):
    """Requires a ``bench_kernels.compare_*`` result within its kernel's
    tolerance (bf16: 1 bf16 ulp relative, 8e-3, plus 1e-3 absolute, since
    kernel and plain version sum in f32 in different orders, which can
    flip one bf16 rounding). Returns the largest absolute difference."""
    require(c.ok, f"{what} within tolerance")
    return c.max_abs_err


def bag_index(num_rows, rows, mask):
    """``rows`` (P, f), the table row of each slot, as
    ``torch.nn.functional.embedding_bag``'s input: every masked slot
    pointed at a row that no valid slot reads, which the call is given as
    ``padding_idx`` (left out of the sum and of the mean's count). Built
    outside any timed window. (None, None) when every row is read."""
    import torch
    read = rows[mask].long()
    if read.numel() and int(read.max()) >= num_rows:
        return None, None
    used = torch.zeros(num_rows, dtype=torch.bool, device=rows.device)
    used[read] = True
    free = (~used).nonzero()
    if free.numel() == 0:
        return None, None
    pad = int(free[0])
    return torch.where(mask, rows, pad).long(), pad


def library_bag(table, idx, pad, mode):
    """The time of one ``embedding_bag`` call over ``table`` (None where
    there is no such call: every row read, or a norm it cannot give)."""
    import torch.nn.functional as F
    if idx is None or mode not in ("mean", "sum"):
        return None
    return time_ms(lambda: F.embedding_bag(idx, table, mode=mode,
                                           padding_idx=pad))


def check_identity_mean(x, m1, off):
    """K1 (norm "mean", bf16 out, as SAGE's layer 0 runs it) against its
    plain version on the gathered features x and the identity block's
    mask, both timed, beside ``embedding_bag`` (mode "mean") on the same
    rows."""
    import torch

    from legion_tpu_torch.ops.identity_agg import (identity_masked_mean,
                                                   identity_masked_mean_plain)
    d1, slots1 = x.shape[1], int(m1.sum())
    p1, f1 = m1.shape
    idx, pad = bag_index(x.shape[0], off + torch.arange(
        p1 * f1, dtype=torch.int32, device=x.device).reshape(p1, f1), m1)
    # masked slots are skipped: the valid slots' rows and the mask are
    # read, the bf16 rows written; one add per element read
    return {"shape": [*m1.shape, *x.shape, off],
            **bound(slots1 * d1 * x.element_size() + m1.numel()
                    + m1.shape[0] * d1 * 2, slots1 * d1),
            "library_ms": library_bag(x, idx, pad, "mean"),
            "max_abs_err": compared(
                compare_identity_mean(x, m1, off),
                f"identity_masked_mean at {[*m1.shape, *x.shape]}"),
            "ms": time_ms(lambda: identity_masked_mean(x, m1, off)),
            "plain_ms": time_ms(
                lambda: identity_masked_mean_plain(x, m1, off))}


def check_feature_mean(x, pos, mask):
    """The gathered feature mean (bf16 out, as SAGE's layer 0 runs it on a
    deduplicated outer block that it widens) against its plain version on
    raw rows x (S, D) and the block's positions and mask (P, f), within
    one flipped bf16 rounding; no valid slot may lie past the rows. Timed
    warm and with the L2 flushed before each call (``cold_ms``, as in a
    step), beside its plain version, the PyTorch chain it replaced
    (``chain_ms``: ``fanout_gather_mean``'s gather, NaN select, mask
    product, sum and divide) and ``embedding_bag`` (mode "mean") on the
    same rows. The bound reads each distinct row the valid slots name
    once, 5 bytes a slot and writes the bf16 rows; ``slot_bytes`` counts a
    row read for every valid slot instead."""
    import torch

    from legion_tpu_torch.ops.identity_agg import (
        gathered_feature_mean, gathered_feature_mean_plain)
    from legion_tpu_torch.ops.segment import fanout_gather_mean
    from legion_tpu_torch.sampling.block import Block
    (p, f), (s, d) = mask.shape, x.shape
    es = x.element_size()
    read = pos[mask]
    require(read.numel() == 0 or int(read.max()) < s,
            "every valid slot names one of the rows")
    slots, rows = int(read.numel()), int(torch.unique(read).numel())
    what = f"gathered_feature_mean at {[p, f, s, d]} {x.dtype}"
    k = gathered_feature_mean(x, pos, mask)
    want = gathered_feature_mean_plain(x, pos, mask)
    require(within_bf16(k, want), f"{what} within tolerance")
    err = float((k.float() - want.float()).abs().max())
    del k, want
    blk = Block(nbr_pos=pos, nbr_mask=mask,
                num_src=torch.tensor(s, dtype=torch.int32, device=x.device),
                num_dst=torch.tensor(p, dtype=torch.int32, device=x.device))
    idx, pad = bag_index(s, pos, mask)
    return {"shape": [p, f, s, d], "dtype": str(x.dtype).split(".")[-1],
            "valid_slots": slots, "distinct_rows": rows,
            **bound(rows * d * es + 5 * mask.numel() + p * d * 2, slots * d),
            "slot_bytes": slots * d * es + 5 * mask.numel() + p * d * 2,
            "max_abs_err": err,
            "ms": time_ms(lambda: gathered_feature_mean(x, pos, mask)),
            "cold_ms": time_ms(lambda: gathered_feature_mean(x, pos, mask),
                               cold=True),
            "plain_ms": time_ms(
                lambda: gathered_feature_mean_plain(x, pos, mask)),
            "chain_ms": time_ms(lambda: fanout_gather_mean(x, blk)),
            "chain_cold_ms": time_ms(lambda: fanout_gather_mean(x, blk),
                                     cold=True),
            "library_ms": library_bag(x, idx, pad, "mean")}


def check_feature_mean_rows(x, pos, mask, out_dtype):
    """The gathered feature mean against its plain version on the rows a
    path hands it (x at the path's own width and dtype) and out_dtype, the
    model's compute dtype: a float32 result within 1e-5 of the mean of the
    magnitudes (another order of the same f32 sum), a bf16 one within one
    flipped rounding."""
    import torch

    from legion_tpu_torch.ops.identity_agg import (
        gathered_feature_mean, gathered_feature_mean_plain)
    (p, f), (s, d) = mask.shape, x.shape
    k = gathered_feature_mean(x, pos, mask, out_dtype)
    want = gathered_feature_mean_plain(x, pos, mask, out_dtype)
    ok = (within_f32(k, want, gathered_feature_mean_plain(
        x.abs(), pos, mask, torch.float32))
          if out_dtype == torch.float32 else within_bf16(k, want))
    require(ok, f"gathered_feature_mean at {[p, f, s, d]} {x.dtype} -> "
                f"{out_dtype} within tolerance")
    return {"shape": [p, f, s, d], "dtype": str(x.dtype).split(".")[-1],
            "out_dtype": str(out_dtype).split(".")[-1],
            "max_abs_err": float((k.float() - want.float()).abs().max())}


def layer1_inputs(tr, batch, x):
    """What a step of ``tr`` on ``batch`` (features x gathered) hands K2
    at layer 1: the transformed activations h_t, the block's positions and
    mask, and the gradient of the step's loss at layer 1's aggregate
    (bf16, as the step's backward gives it). Dropout is off, so that the
    gradient is a function of the inputs."""
    import torch

    from legion_tpu_torch.ops.identity_agg import gathered_masked_mean_plain
    from legion_tpu_torch.train.loop import masked_softmax_ce
    blk0, blk1 = reversed(batch.blocks)        # model order
    layer0, layer1 = tr.model.layers
    pos, mask = blk1.nbr_pos, blk1.nbr_mask
    with torch.no_grad():
        h = torch.relu(layer0(blk0, x))
        h_t = layer1._dense(layer1.fc_neigh, h)
    agg = gathered_masked_mean_plain(h_t.requires_grad_(True), pos, mask)
    logits = layer1._dense(layer1.fc_self, h[: blk1.dst_cap]).detach() + agg
    loss = masked_softmax_ce(logits[: batch.seed_cap], batch.labels,
                             batch.seed_mask())
    (gd,) = torch.autograd.grad(loss, agg)
    return h_t.detach(), pos, mask, gd.contiguous()


def trainer_kernel_checks(tr, labels, seed):
    """Every kernel of a SAGE ``Trainer``'s step against its plain version
    on one batch of its first training seeds, sampled at its caps with a
    generator seeded ``seed``: the sampling kernel on both hops (uniforms
    seeded ``seed + 1``), K3 on the whole frontier (-1 padding included),
    K1 on the identity block and K2 forward and backward on layer 1's
    block, each with the tolerance of the main path's check."""
    import torch

    from legion_tpu_torch.sampling.sampler import sample_batch
    cfg, dev = tr.cfg, tr.device
    ids = tr.shards_train[0][:cfg.sampler.batch_size].copy()
    batch = sample_batch(
        tr.graph, torch.from_numpy(ids).to(dev),
        torch.tensor(len(ids), dtype=torch.int32, device=dev),
        torch.from_numpy(labels[ids]).to(dev), cfg.sampler.fanouts,
        tr.caps, dedup_last=cfg.sampler.dedup_last,
        generator=torch.Generator(device=dev).manual_seed(seed))
    hops = check_sampling_kernel(tr.graph, hop_frontiers(batch, tr.caps),
                                 cfg.sampler.fanouts, seed=seed + 1)
    x, k3 = check_gather_rows(tr.features, batch.frontier)
    blk0 = batch.blocks[-1]
    require(blk0.identity_offset is not None, "layer 0's block is identity")
    k1 = check_identity_mean(x, blk0.nbr_mask, blk0.identity_offset)
    k2_fwd, k2_bwd = check_k2(*layer1_inputs(tr, batch, x), "mean")
    return {"sample_neighbors_hops": hops, "gather_rows": k3,
            "identity_masked_mean": k1,
            "k2": {"forward": k2_fwd, "backward": k2_bwd}}


def record_kernel_checks(results, path, checks):
    """File ``trainer_kernel_checks``' records under ``path`` in the
    kernels line's results (K2's among its shapes, as ``<path>_bf16``)."""
    results["sample_neighbors"][f"{path}_hops"] = checks[
        "sample_neighbors_hops"]
    results["gather_rows"][path] = checks["gather_rows"]
    results["identity_masked_mean"][path] = checks["identity_masked_mean"]
    results["gathered_masked_mean"]["shapes"][f"{path}_bf16"] = checks[
        "k2"]["forward"]
    results["gathered_masked_mean_backward"]["shapes"][f"{path}_bf16"] = (
        checks["k2"]["backward"])


def k2_fill_case():
    """K2 on a tiny block where three valid slots point past the rows:
    the kernel gives NaN in exactly the plain version's rows and its
    backward drops those slots (f32, within 1e-5 of the summed
    magnitudes)."""
    import torch

    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean, gathered_masked_mean_backward,
        gathered_masked_mean_backward_plain, gathered_masked_mean_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    p, f, s, d = 300, 10, 500, 64
    h = torch.randn((s, d), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.rand((p, f), generator=gen, device=dev) > 0.4
    pos = torch.randint(0, s, (p, f), generator=gen, device=dev,
                        dtype=torch.int32)
    bad = torch.tensor([3, 77, 299], device=dev)
    mask[bad, 2] = True
    pos[bad, 2] = torch.tensor([s, 10 ** 6, 2 ** 31 - 1], dtype=torch.int32,
                               device=dev)
    pos = torch.where(mask, pos, 0)
    k, pl = gathered_masked_mean(h, pos, mask), gathered_masked_mean_plain(
        h, pos, mask)
    nan_rows = torch.isnan(pl).any(1).nonzero().flatten().tolist()
    require(nan_rows == bad.tolist(), "the plain K2 fills NaN rows")
    require(torch.equal(torch.isnan(k), torch.isnan(pl)),
            "K2 forward gives NaN in exactly the plain version's rows")
    ok = ~torch.isnan(pl).any(1)
    require(within_bf16(k[ok], pl[ok]),
            "K2 forward's finite rows within bf16 tolerance")
    g = torch.randn((p, d), generator=gen, device=dev)
    kb = gathered_masked_mean_backward(g, pos, mask, s, "mean", torch.float32)
    pb = gathered_masked_mean_backward_plain(g, pos, mask, s, "mean",
                                             torch.float32)
    mag = gathered_masked_mean_backward_plain(g.abs(), pos, mask, s, "mean",
                                              torch.float32)
    require(bool(torch.isfinite(kb).all()) and within_f32(kb, pb, mag),
            "K2 backward drops the slots past the rows as its plain version")
    return {"nan_rows": nan_rows, "finite_rows": int(ok.sum()),
            "bwd_max_abs_err": float((kb - pb).abs().max())}


def stderr_log(s):
    print(s, file=sys.stderr, flush=True)


def logits_vs_cpu(tr, cfg, seed_ids, tol):
    """One eval batch of ``seed_ids`` at the trainer's eval caps: the
    model's logits on the card (through the kernels) against the same
    model and batch on the CPU (through the plain versions), within
    tol x max|logit|. Returns (max abs error, max |logit|)."""
    import torch

    from legion_tpu_torch.models import build_model
    from legion_tpu_torch.sampling.block import Block
    from legion_tpu_torch.sampling.sampler import (gather_features,
                                                   sample_batch)
    dev = tr.device
    seeds = torch.from_numpy(seed_ids.copy()).to(dev)
    batch = sample_batch(tr.graph, seeds,
                         torch.tensor(len(seed_ids), dtype=torch.int32,
                                      device=dev),
                         seeds, cfg.sampler.fanouts, tr.eval_caps,
                         dedup_last=cfg.sampler.dedup_last,
                         generator=torch.Generator(device=dev).manual_seed(7))
    blocks = tuple(reversed(batch.blocks))
    with torch.no_grad():
        out = tr.model(blocks, gather_features(tr.features, batch.frontier))
        cpu_model = build_model(cfg.model.arch, tr.features.shape[1],
                                cfg.model.hidden_dim, CLASSES,
                                cfg.model.num_layers, cfg.model.dropout,
                                cfg.model.dtype)
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   tr.model.state_dict().items()})
        cpu_blocks = tuple(Block(b.nbr_pos.cpu(), b.nbr_mask.cpu(),
                                 b.num_src.cpu(), b.num_dst.cpu(),
                                 b.identity_offset) for b in blocks)
        ref = cpu_model(cpu_blocks, gather_features(tr.features.cpu(),
                                                    batch.frontier.cpu()))
    out, ref = out.cpu().float(), ref.float()
    require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
            "finite logits of the reference's shape")
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    require(err <= tol * scale,
            f"{cfg.model.arch} {cfg.model.dtype} logits on the card within "
            f"{tol} x max|logit| of the CPU plain path ({err} vs {scale})")
    return err, scale


def check_grouped_masked_sum(x, mask, off):
    """K5 against its plain version on the identity block of a main-path
    batch: x2 = x[off : off + P*f], (P, f) mask. float32 value and the
    gradient of a weighted sum within 1e-5 of the summed magnitudes (two
    orders of one f32 sum); bf16 within one flipped rounding; width 47
    with float weights in both dtypes (rows that 16-byte loads cannot
    take). Timed beside ``torch.einsum``, the one PyTorch call that
    computes the same function."""
    import torch

    from legion_tpu_torch.ops.spmm import (grouped_masked_sum,
                                           grouped_masked_sum_plain)
    p, f = mask.shape
    x2 = x[off: off + p * f]
    d = x2.shape[1]
    gen = torch.Generator(device=x.device).manual_seed(11)
    w = torch.randn((p, d), generator=gen, device=x.device)

    rec = {"shape": [p, f, d]}
    c = compare_grouped_sum(x2, mask, f)
    rec["max_abs_err"] = compared(
        c, "grouped_masked_sum forward (1e-5 of the magnitudes)")
    pl = grouped_masked_sum_plain(x2, mask, f)
    grads = []
    for fn in (grouped_masked_sum, grouped_masked_sum_plain):
        xg = x2.clone().requires_grad_(True)
        (fn(xg, mask, f) * w).sum().backward()
        grads.append(xg.grad)
        del xg
    require(torch.equal(grads[0], grads[1]),
            "grouped_masked_sum's gradient of a weighted sum is the plain "
            "version's (each element one product)")
    del grads
    xb = x2.to(torch.bfloat16)
    rec["bf16_max_abs_err"] = compared(compare_grouped_sum(xb, mask, f),
                                       "grouped_masked_sum bf16")
    # width 47 and float weights: no 16-byte loads, a multiply per slot
    xo = x2[:, :47].contiguous()
    wm = mask * (0.5 + torch.rand(mask.shape, generator=gen,
                                  device=x.device))
    rec["odd_f32_max_abs_err"] = compared(
        compare_grouped_sum(xo, wm, f),
        "grouped_masked_sum at width 47 (1e-5 of the magnitudes)")
    xob = xo.to(torch.bfloat16)[1:-(f - 1)]     # a 2-byte-aligned start
    rec["odd_bf16_max_abs_err"] = compared(
        compare_grouped_sum(xob, wm[:-1], f),
        "grouped_masked_sum bf16 at width 47")
    del xb, xo, xob
    mf = mask.to(x2.dtype)
    x3 = x2.view(p, f, d)
    lib = torch.einsum("pfd,pf->pd", x3, mf)
    rec["library_max_abs_err"] = float((lib - pl).abs().max())
    del lib, c, pl
    rec.update(
        bound(x2.numel() * x2.element_size() + mask.numel()
              + p * d * x2.element_size(), 2 * x2.numel()),
        ms=time_ms(lambda: grouped_masked_sum(x2, mask, f)),
        plain_ms=time_ms(lambda: grouped_masked_sum_plain(x2, mask, f)),
        library_ms=time_ms(lambda: torch.einsum("pfd,pf->pd", x3, mf)))
    return rec


# the kernel each wrapper launches, by the name a trace of the card shows
# (K2's backward: its scatter kernel; bf16 adds one cast pass after it)
TRACE_NAMES = {"identity_masked_mean": "masked_agg_kernel",
               "gathered_masked_mean": "gathered_agg_kernel",
               "gathered_masked_mean_backward": "scatter_rows_kernel",
               "gather_rows": "gather_rows_kernel",
               "sample_neighbors": "sample_neighbors_kernel",
               "grouped_masked_sum": "grouped_masked_sum_kernel",
               "dedup_tail": "dedup_tail_kernel",
               "gathered_feature_mean": "feature_mean_kernel",
               "edge_softmax_aggregate": "edge_softmax_fwd_kernel",
               "act_dropout": "act_dropout_fwd_kernel",
               "act_dropout_backward": "act_dropout_bwd_kernel",
               # one src-row pass a backward call
               "edge_softmax_aggregate_backward": "edge_softmax_src_kernel"}


def traced_launches(kernels, fn):
    """Run ``fn()`` under ``torch.profiler`` (CUDA activity): each wrapper's
    kernel counted by name among the device events of the trace, the
    wrappers' own counts over the same call, and the names of the
    trace's device events. Late in a long process the profiler dropped
    the first device records of its window (the first 22 of 5 replays,
    every time, in the ``ogb_products`` phase; a 10 ms spin ahead of them
    did not help), so ``fn`` runs twice in the window: the first run
    takes what is lost, a spin kernel marks its end, and only the records
    after the mark, and the launches the wrappers count there, are
    compared."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(1_000_000)              # the mark
        reset_launches(kernels)
        fn()
        torch.cuda.synchronize()
    counted = read_launches(kernels)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    mark = max(i for i, e in enumerate(events) if "spin_kernel" in e.name)
    names = [e.name for e in events[mark + 1:]]
    traced = {k: sum(TRACE_NAMES[k] in n for n in names) for k in kernels}
    stderr_log(f"traced: {mark} device records before the mark, "
               f"{len(names)} after it")
    return traced, counted, names


def seed_rows(ids, rows, batch, seed):
    """(rows, batch) int32 seeds, each row ``batch`` ids of a permutation
    of ``ids`` (a numpy array) drawn from a CPU generator seeded ``seed``."""
    import torch
    ids = torch.as_tensor(ids)
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([ids[torch.randperm(len(ids), generator=gen)[:batch]]
                        for _ in range(rows)]).int()


def trainer_scan(tr, n):
    """``n`` steps of ``tr``'s ``epoch_scan``, on ``n`` rows of seeds."""
    seeds = seed_rows(tr.shards_train[0], n, tr.cfg.sampler.batch_size,
                      seed=17).numpy()
    return lambda: tr._train_steps(seeds, None)


def replays_traced(kernels, scan, n, per_train_step, what):
    """``n`` replays of a captured train step under the profiler:
    ``scan()`` runs ``n`` steps of an ``epoch_scan``, once untraced (it
    captures there if its graph does not serve it yet) and once traced.
    Every wrapper's kernel must show ``n`` times its launches per eager
    step (``per_train_step``) in the trace, and the wrappers' bookkeeping
    must say the same."""
    scan()
    traced, counted, names = traced_launches(kernels, scan)
    want = {k: n * c for k, c in per_train_step.items()}
    require(traced == want and counted == want,
            f"{what}: {n} replays traced {traced} and counted {counted} "
            f"launches, want {want}")
    return {"replays": n, "traced": traced, "counted": counted,
            "device_events": len(names), **collective_events(names)}


def collective_events(names):
    """What the collectives leave in a trace: NCCL's kernels, and the
    device-to-device copies (NCCL's one-rank collectives are copies, or
    nothing for an all-reduce in place; a graph may run a copy as a
    kernel)."""
    return {"nccl_kernels": sum("nccl" in n.lower() for n in names),
            "memcpy_dtod": sum("Memcpy DtoD" in n for n in names)}


GRAPHED_TRIAL_STEPS = 48       # steps of each timed trial of the phase
GRAPHED_TRIALS = 3
# K2 backward's atomics add in an order that changes from run to run, and
# bf16 rounds the sums: from one state, with equal sampled edges, a
# captured and an eager epoch parted by 1.7 % of the distance layer 0's
# weights moved, and two eager epochs by 1.8 % (26 steps of batch 3000 on
# the H100); the phase prints both
GRAPHED_LOSS_RTOL = 1e-3
GRAPHED_PARAM_RTOL = 5e-2      # of the distance each tensor moved (L2)


def graphed(kernels, smi, tr, data):
    """Phase "graphed": the main path's ``Trainer`` (phase 4's, captured)
    against a second ``Trainer`` of the same configuration stepped eagerly
    (``fns.train_step``, one op at a time), at full width.

    (a) One eager train step and one eager eval step under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync.
    (b) Both trainers from the same state (parameters, Adam's state,
    generator, step), an epoch of the same seeds: per step ``edges``,
    ``frontier`` and ``cap_overflow`` exactly equal (the same random
    stream), losses within ``GRAPHED_LOSS_RTOL`` relative, and every
    parameter tensor's difference within ``GRAPHED_PARAM_RTOL`` of the
    distance it moved over the epoch (both L2). Then one validation pass
    of the captured eval step against the eager eval loop on the same
    weights: equal (correct, valid) counts.
    (c) The wrappers' launch counts over the captured epoch equal the
    eager epoch's; 5 replays traced by ``torch.profiler`` show each
    kernel 5 times its launches per eager step, as the bookkeeping says.
    (d) Eager and graphed ms/step in alternating trials of
    ``GRAPHED_TRIAL_STEPS`` steps (median of ``GRAPHED_TRIALS``), the
    host's enqueue time per step, the capture's seconds and the graph
    pool's bytes."""
    import copy
    import statistics

    import torch

    from legion_tpu_torch.train.loop import Trainer
    from legion_tpu_torch.train.train_state import load_optimizer_in_place
    cfg, dev = tr.cfg, tr.device
    b = cfg.sampler.batch_size
    t0 = time.perf_counter()
    eager = Trainer(cfg, data, device="cuda")
    init_s = time.perf_counter() - t0
    require(eager.caps == tr.caps, f"both trainers probe the same caps, "
            f"{eager.caps} and {tr.caps}")

    def snapshot(t):
        return (copy.deepcopy(t.model.state_dict()),
                copy.deepcopy(t.state.optimizer.state_dict()),
                t.state.generator.get_state(), t.state.step)

    def load(t, snap):
        t.model.load_state_dict(snap[0])
        load_optimizer_in_place(t.state.optimizer, copy.deepcopy(snap[1]))
        t.state.generator.set_state(snap[2])
        t.state.step = snap[3]

    labels_all = torch.as_tensor(data.labels).int()

    def labels_of(s):
        return torch.where(s >= 0, labels_all[s.clamp(min=0).long()], -1)

    seeds = seed_rows(tr.shards_train[0], tr.plan.train_steps, b, seed=5)
    sd, ld = seeds.to(dev), labels_of(seeds).to(dev)
    seeds = seeds.numpy()
    nb = torch.tensor(b, dtype=torch.int32, device=dev)
    vs, vc = (x[0] for x in tr._eval_seeds("valid"))
    vsd, vcd = torch.as_tensor(vs).to(dev), torch.as_tensor(vc).to(dev)
    vld = labels_of(torch.as_tensor(vs)).to(dev)

    # (a) no host sync in an eager train or eval step
    start = snapshot(tr)
    load(eager, start)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager.fns.train_step(eager.state, eager.graph, eager.features, sd[0],
                             nb, ld[0])
        eager.fns_eval.eval_step(eager.model, eager.graph, eager.features,
                                 vsd[0], vcd[0], vld[0],
                                 generator=eager.eval_generator)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    # (b) an epoch both ways from the same state, and eagerly twice: two
    # eager runs differ by what K2 backward's atomics leave, the floor of
    # the captured run's difference
    steps = len(seeds)
    p0 = start[0]

    def eager_epoch():
        load(eager, start)
        reset_launches(kernels)
        ms = [eager.fns.train_step(eager.state, eager.graph, eager.features,
                                   sd[i], nb, ld[i]) for i in range(steps)]
        launches = read_launches(kernels)
        ms = torch.stack([torch.stack([m[k].double() for k in (
            "loss", "edges", "frontier", "cap_overflow")])
            for m in ms]).cpu()
        return ms, launches, {k: v.detach().clone() for k, v in
                              eager.model.state_dict().items()}

    eager_m, eager_launches, want = eager_epoch()
    eager2_m, _, want2 = eager_epoch()
    reset_launches(kernels)
    graph_m = tr._train_steps(seeds, None).cpu()
    graph_launches = read_launches(kernels)
    got = tr.model.state_dict()
    require(steps >= 20, f"at least 20 steps compared, got {steps}")
    for col, name in ((1, "edges"), (2, "frontier"), (3, "cap_overflow")):
        require(torch.equal(graph_m[:, col], eager_m[:, col])
                and torch.equal(eager2_m[:, col], eager_m[:, col]),
                f"captured and eager {name} equal step for step: "
                f"{graph_m[:, col].tolist()} / {eager_m[:, col].tolist()}")

    def loss_diff(m):
        return ((m[:, 0] - eager_m[:, 0]).abs()
                / eager_m[:, 0].abs()).max().item()

    def param_diff(ps):
        return {k: (ps[k] - want[k]).norm().item()
                / max((want[k] - p0[k]).norm().item(), 1e-30) for k in p0}

    loss_rel, loss_rel_eager = loss_diff(graph_m), loss_diff(eager2_m)
    require(loss_rel <= GRAPHED_LOSS_RTOL,
            f"losses within {GRAPHED_LOSS_RTOL} relative, worst {loss_rel}")
    param_rel, param_rel_eager = param_diff(got), param_diff(want2)
    worst_param = max(param_rel.values())
    require(worst_param <= GRAPHED_PARAM_RTOL,
            f"parameters within {GRAPHED_PARAM_RTOL} of the distance they "
            f"moved: {param_rel} (two eager runs: {param_rel_eager})")
    require(graph_launches == eager_launches,
            f"the captured epoch's launches {graph_launches} are the eager "
            f"epoch's {eager_launches}")
    per_step = {k: Fraction(n, steps) for k, n in eager_launches.items()}
    require(all(v.denominator == 1 for v in per_step.values()),
            f"whole launches per eager step: {per_step}")
    per_step = {k: int(v) for k, v in per_step.items()}

    gen = torch.Generator(device=dev)
    gen.manual_seed(12345)
    acc = torch.zeros(2, dtype=torch.float32, device=dev)
    for t in range(vs.shape[0]):
        a, c = tr.fns_eval.eval_step(tr.model, tr.graph, tr.features, vsd[t],
                                     vcd[t], vld[t], generator=gen)
        acc += torch.stack([a.float(), c.float()])
    eager_counts = acc.tolist()
    graph_counts = tr._eval_counts(vs, vc, 12345, None).tolist()
    require(graph_counts == eager_counts,
            f"captured eval counts {graph_counts} equal the eager loop's "
            f"{eager_counts}")

    # (c) 5 replays under the profiler
    traced = replays_traced(kernels, trainer_scan(tr, 5), 5, per_step,
                            "main path")
    eager_traced, _, eager_names = traced_launches(kernels, lambda: [
        eager.fns.train_step(eager.state, eager.graph, eager.features, sd[i],
                             nb, ld[i]) for i in range(5)])
    eager_events = len(eager_names)
    require(eager_traced == traced["traced"],
            f"5 eager steps traced {eager_traced}, 5 replays "
            f"{traced['traced']}")

    # (d) eager against graphed ms/step, same call, alternating trials
    tseeds = seed_rows(tr.shards_train[0], GRAPHED_TRIAL_STEPS, b, seed=6)
    tsd, tld = tseeds.to(dev), labels_of(tseeds).to(dev)
    scan = tr.fns.epoch_scan
    reserved0 = torch.cuda.memory_reserved()
    scan(tr.state, tr.graph, tr.features, tsd, tld)   # rows 48 > 24: capture
    torch.cuda.synchronize()
    run = scan.runs[False]
    pool = run.step.pool.handle
    segments = torch.cuda.memory_snapshot()
    pool_bytes = sum(s["total_size"] for s in segments
                     if tuple(s.get("segment_pool_id", ())) == tuple(pool))
    graph_pools_bytes = sum(s["total_size"] for s in segments
                            if tuple(s.get("segment_pool_id", (0, 0)))
                            != (0, 0))

    def eager_trial():
        t = time.perf_counter()
        for i in range(GRAPHED_TRIAL_STEPS):
            eager.fns.train_step(eager.state, eager.graph, eager.features,
                                 tsd[i], nb, tld[i])
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        return host, time.perf_counter() - t

    def graph_trial():
        t = time.perf_counter()
        for i in range(GRAPHED_TRIAL_STEPS):
            run.step()
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        return host, time.perf_counter() - t

    run.seeds.copy_(tsd)
    run.labels.copy_(tld)
    eager_trial()                                      # warm
    trials = {"eager": [], "graphed": []}
    for _ in range(GRAPHED_TRIALS):
        for name, fn in (("eager", eager_trial), ("graphed", graph_trial)):
            run.counter.zero_()
            host, wall = fn()
            trials[name].append((1e3 * host / GRAPHED_TRIAL_STEPS,
                                 1e3 * wall / GRAPHED_TRIAL_STEPS))
    timing = {name: {"ms_per_step": [w for _, w in t],
                     "median_ms_per_step": statistics.median(
                         w for _, w in t),
                     "host_enqueue_ms_per_step": [h for h, _ in t]}
              for name, t in trials.items()}
    rec = {"phase": "graphed", "nvidia_smi": smi, "caps": list(tr.caps),
           "eager_trainer_init_s": init_s, "steps": steps,
           "edges_equal": True, "frontier_equal": True,
           "overflow_equal": True, "loss_worst_rel_diff": loss_rel,
           "loss_rtol": GRAPHED_LOSS_RTOL,
           "loss_worst_rel_diff_two_eager": loss_rel_eager,
           "param_worst_rel_to_moved": worst_param,
           "param_rel_to_moved": param_rel,
           "param_rel_to_moved_two_eager": param_rel_eager,
           "param_rtol": GRAPHED_PARAM_RTOL,
           "eval_counts": graph_counts, "eager_eval_counts": eager_counts,
           "launches_per_step": per_step, "epoch_launches": graph_launches,
           "replays_traced": traced, "eager_steps_traced": eager_traced,
           "eager_device_events": eager_events,
           "trial_steps": GRAPHED_TRIAL_STEPS, "timing": timing,
           "capture_s": run.step.capture_s,
           "pool_bytes": pool_bytes, "graph_pools_bytes": graph_pools_bytes,
           "reserved_delta_bytes": torch.cuda.memory_reserved() - reserved0,
           "losses": graph_m[:, 0].tolist(),
           "eager_losses": eager_m[:, 0].tolist()}
    emit(rec)
    del eager
    return rec


MESH_TRIALS = 3               # alternating eager / captured trials


def replay_profile(run, n):
    """``n`` replays of the captured step of a scan's ``run`` (n <= its
    rows; the row counter is reset first) under ``torch.profiler``, run
    twice in one window and read after a spin-kernel mark (as
    ``traced_launches``): the device's busy ms a step (the union of its
    records' spans), the replays' ms a step by CUDA events, the idle
    share between them, and the busy time by stage of
    ``tools/sol_model.py`` with the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from legion_tpu_torch.tools.profile_cached import device_busy_ms
    from legion_tpu_torch.tools.sol_model import stage_of
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    require(n <= run.rows, f"{n} replays fit the run's {run.rows} rows")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run.counter.zero_()
        for _ in range(n):
            run.step()
        run.counter.zero_()
        torch.cuda._sleep(1_000_000)              # the mark
        ev[0].record()
        for _ in range(n):
            run.step()
        ev[1].record()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation),
                    key=lambda e: e.time_range.start)
    mark = max(i for i, e in enumerate(events) if "spin_kernel" in e.name)
    events = events[mark + 1:]
    busy = device_busy_ms(events) / n
    replay = ev[0].elapsed_time(ev[1]) / n
    by_kernel, stages = {}, {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3 / n
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + ms
        st = stage_of(e.name)
        stages[st] = stages.get(st, 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"replays": n, "busy_ms_per_step": busy,
            "replay_ms_per_step": replay,
            "idle_share": 1.0 - busy / replay, "stages_ms": stages,
            "device_records_per_step": len(events) / n,
            "top_kernels_ms": [[k[:120], v] for k, v in top]}


def captured_vs_eager(kernels, what, fns, fns_eval, state, graph, feats,
                      seeds, labels, evals, comm_per_step, overflow=None):
    """The captured train and eval steps of a mesh path (NCCL, world size
    1) against the same steps run eagerly from the same state. ``fns`` /
    ``fns_eval``: the path's train and eval ``StepFns`` (their scans
    capture); ``seeds`` / ``labels``: (steps, b) int32 on the card;
    ``evals``: (seeds, counts, labels) of a few eval steps;
    ``comm_per_step``: the closed forms' (calls, bytes) by op kind a
    train step; ``overflow``: a () device tensor the step adds to (the
    partitioned path's halo overflow).

    (a) One eager train and one eager eval step under
    ``torch.cuda.set_sync_debug_mode("error")``.
    (b) The eager twin: the epoch captured (replays of the scan's graph,
    or its warm-up and capture first) and eagerly (``fns.train_step``)
    twice, each from the same state (loaded in place): ``edges``,
    ``frontier``, ``cap_overflow`` and ``overflow`` equal step for step,
    losses within ``GRAPHED_LOSS_RTOL``, parameters within
    ``GRAPHED_PARAM_RTOL`` of the distance they moved (the floor: two
    eager runs), the launch counts equal, and the collectives counted
    after the replays equal the eager steps' and the closed forms; the
    captured eval counts equal the eager loop's.
    (c) 5 replays traced as ``replays_traced`` checks them (each
    kernel's traced launches equal to the bookkeeping), their NCCL
    kernels and device copies equal to 5 eager steps', and the
    collectives the bookkeeping adds for them equal to 5 steps' closed
    forms.
    (d) Eager against captured ms/step in ``MESH_TRIALS`` alternating
    trials of the epoch's steps, the host's enqueue time, the capture's
    seconds and the pool's bytes; (e) ``replay_profile`` of 5 replays."""
    import copy
    import statistics

    import torch

    from legion_tpu_torch.train import graphed as graphed_mod
    from legion_tpu_torch.train.train_state import load_optimizer_in_place
    from legion_tpu_torch.utils import comm
    dev = feats.device
    steps, b = seeds.shape
    nb = torch.tensor(b, dtype=torch.int32, device=dev)
    model = state.model
    vs, vc, vl = evals
    calls_per_step, bytes_per_step = comm_per_step

    def snapshot():
        return ({k: v.detach().clone()
                 for k, v in model.state_dict().items()},
                copy.deepcopy(state.optimizer.state_dict()),
                state.generator.get_state(), state.step)

    def load(snap):
        model.load_state_dict(snap[0])
        load_optimizer_in_place(state.optimizer, copy.deepcopy(snap[1]))
        state.generator.set_state(snap[2])
        state.step = snap[3]
        if overflow is not None:
            overflow.zero_()

    def eager_rows(rows):
        return [fns.train_step(state, graph, feats, seeds[i], nb, labels[i])
                for i in range(rows)]

    # (a) no host sync in an eager train or eval step
    start = snapshot()
    gen = torch.Generator(device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager_rows(1)
        fns_eval.eval_step(model, graph, feats, vs[0], vc[0], vl[0],
                           generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    # (b) captured, eager, eager, each from the same state
    def epoch(captured):
        load(start)
        reset_launches(kernels)
        comm.reset_counts()
        if captured:
            m = fns.epoch_scan(state, graph, feats, seeds, labels)
        else:
            m = torch.stack([torch.stack([r[k].double() for k in (
                "loss", "edges", "frontier", "cap_overflow")])
                for r in eager_rows(steps)])
        ov = None if overflow is None else int(overflow)
        return (m.cpu(), read_launches(kernels),
                (comm.read_calls(), comm.read_counts()), ov,
                {k: v.detach().clone() for k, v in model.state_dict().items()})

    graph_m, graph_launches, graph_comm, graph_ov, got = epoch(True)
    eager_m, eager_launches, eager_comm, eager_ov, want = epoch(False)
    eager2_m, _, _, _, want2 = epoch(False)
    for col, name in ((1, "edges"), (2, "frontier"), (3, "cap_overflow")):
        require(torch.equal(graph_m[:, col], eager_m[:, col])
                and torch.equal(eager2_m[:, col], eager_m[:, col]),
                f"{what}: captured and eager {name} equal step for step: "
                f"{graph_m[:, col].tolist()} / {eager_m[:, col].tolist()}")
    require(graph_ov == eager_ov,
            f"{what}: captured and eager overflow {graph_ov} / {eager_ov}")
    p0 = start[0]

    def loss_diff(m):
        return ((m[:, 0] - eager_m[:, 0]).abs()
                / eager_m[:, 0].abs()).max().item()

    def param_diff(ps):
        return {k: (ps[k] - want[k]).float().norm().item()
                / max((want[k] - p0[k]).float().norm().item(), 1e-30)
                for k in p0}

    loss_rel, loss_rel_eager = loss_diff(graph_m), loss_diff(eager2_m)
    require(loss_rel <= GRAPHED_LOSS_RTOL,
            f"{what}: losses within {GRAPHED_LOSS_RTOL} relative, worst "
            f"{loss_rel}")
    param_rel, param_rel_eager = param_diff(got), param_diff(want2)
    worst_param = max(param_rel.values())
    require(worst_param <= GRAPHED_PARAM_RTOL,
            f"{what}: parameters within {GRAPHED_PARAM_RTOL} of the "
            f"distance they moved: {param_rel} (two eager: "
            f"{param_rel_eager})")
    require(graph_launches == eager_launches,
            f"{what}: captured launches {graph_launches}, eager "
            f"{eager_launches}")
    want_comm = ({k: steps * n for k, n in calls_per_step.items()},
                 {k: steps * n for k, n in bytes_per_step.items()})
    require(graph_comm == eager_comm == want_comm,
            f"{what}: collectives after {steps} steps captured {graph_comm}, "
            f"eager {eager_comm}, closed forms {want_comm}")
    per_step = {k: Fraction(n, steps) for k, n in eager_launches.items()}
    require(all(v.denominator == 1 for v in per_step.values()),
            f"{what}: whole launches per eager step: {per_step}")
    per_step = {k: int(v) for k, v in per_step.items()}
    gen.manual_seed(12345)
    acc = torch.zeros(2, dtype=torch.float32, device=dev)
    for t in range(vs.shape[0]):
        a, c = fns_eval.eval_step(model, graph, feats, vs[t], vc[t], vl[t],
                                  generator=gen)
        acc += torch.stack([a.float(), c.float()])
    eager_counts = acc.tolist()
    gen.manual_seed(12345)
    graph_counts = fns_eval.eval_scan(model, graph, feats, vs, vc, vl,
                                      gen).tolist()
    require(graph_counts == eager_counts,
            f"{what}: captured eval counts {graph_counts}, eager "
            f"{eager_counts}")

    # (c) 5 replays traced, beside 5 eager steps
    def five():
        comm.reset_counts()
        fns.epoch_scan(state, graph, feats, seeds[:5], labels[:5])

    traced = replays_traced(kernels, five, 5, per_step, what)
    five_comm = (comm.read_calls(), comm.read_counts())
    want_five = ({k: 5 * n for k, n in calls_per_step.items()},
                 {k: 5 * n for k, n in bytes_per_step.items()})
    eager_traced, _, eager_names = traced_launches(kernels,
                                                   lambda: eager_rows(5))
    eager_coll = collective_events(eager_names)
    require(five_comm == want_five,
            f"{what}: 5 replays bookkept collectives {five_comm}, want "
            f"{want_five}")
    # a graph may run a device-to-device copy as a kernel: the copies
    # are printed, not compared
    require(eager_traced == traced["traced"]
            and traced["nccl_kernels"] == eager_coll["nccl_kernels"],
            f"{what}: 5 eager steps traced {eager_traced} and {eager_coll}, "
            f"5 replays {traced}")

    # (d) eager against captured ms/step, alternating trials
    run = fns.epoch_scan.runs[False]
    rows = min(run.rows, steps)
    run.seeds[:rows].copy_(seeds[:rows])
    run.labels[:rows].copy_(labels[:rows])

    def trial(captured):
        run.counter.zero_()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(rows):
            if captured:
                run.step()
            else:
                fns.train_step(state, graph, feats, seeds[i], nb, labels[i])
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        return 1e3 * host / rows, 1e3 * (time.perf_counter() - t) / rows

    trial(False)                                       # warm
    trials = {"eager": [], "graphed": []}
    for _ in range(MESH_TRIALS):
        for name in ("eager", "graphed"):
            trials[name].append(trial(name == "graphed"))
    timing = {name: {"ms_per_step": [w for _, w in t],
                     "median_ms_per_step": statistics.median(
                         w for _, w in t),
                     "host_enqueue_ms_per_step": [h for h, _ in t]}
              for name, t in trials.items()}
    pool_bytes = graphed_mod.pool_bytes(run.step.pool)
    profile = replay_profile(run, 5)
    load(start)
    return {"steps": steps, "edges_equal": True, "frontier_equal": True,
            "overflow_equal": True, "overflow": graph_ov,
            "loss_worst_rel_diff": loss_rel,
            "loss_worst_rel_diff_two_eager": loss_rel_eager,
            "loss_rtol": GRAPHED_LOSS_RTOL,
            "param_worst_rel_to_moved": worst_param,
            "param_worst_rel_to_moved_two_eager": max(
                param_rel_eager.values()),
            "param_rtol": GRAPHED_PARAM_RTOL,
            "eval_counts": graph_counts, "eager_eval_counts": eager_counts,
            "launches_per_step": per_step,
            "collectives_per_step": {"calls": calls_per_step,
                                     "bytes": bytes_per_step},
            "epoch_collectives": graph_comm,
            "replays_traced": traced,
            "eager_steps_traced": {**eager_coll, "kernels": eager_traced},
            "five_replays_collectives": five_comm,
            "trial_steps": rows, "timing": timing,
            "capture_s": run.step.capture_s, "pool_bytes": pool_bytes,
            "replay_profile": profile,
            "losses": graph_m[:, 0].tolist(),
            "eager_losses": eager_m[:, 0].tolist(),
            "frontier": graph_m[:, 2].tolist()}


def mesh_trainer_captured(kernels, what, tr, data, comm_per_step):
    """``captured_vs_eager`` on a ``MeshTrainer``: an epoch's worth of
    seed rows of its shard and 3 steps of its validation seeds."""
    import torch
    dev = tr.device
    labels_all = torch.as_tensor(data.labels).int()
    seeds = seed_rows(tr.shards_train[0], tr.plan.train_steps,
                      tr.cfg.sampler.batch_size, seed=5)
    vs, vc = (torch.as_tensor(x[0][:3]) for x in tr._eval_seeds("valid"))
    vl = torch.where(vs >= 0, labels_all[vs.clamp(min=0).long()], -1)
    return captured_vs_eager(
        kernels, what, tr.fns, tr.fns_eval, tr.state, tr.graph, tr.features,
        seeds.to(dev), labels_all[seeds.long()].to(dev),
        (vs.to(dev), vc.to(dev), vl.to(dev)), comm_per_step)

STAGED_TRIALS = 3              # alternating eager / captured epochs
# a hybrid epoch's figures that a captured epoch holds exactly
HYBRID_FIGURES = ("feat_hit_rate", "staging_overflow", "host_feat_gb",
                  "host_topo_gb", "host_topo_copied_gb", "topo_hot_fraction",
                  "fetches", "cap_overflow", "edges")
# how a staged pipeline's stages draw their randomness: one generator
# registered with several graphs (probed on torch 2.11 before the design
# rested on it; ``tests/test_torch_staged_graphed.py``'s cuda leg)
STAGED_RNG = ("one generator registered with several graphs: the state's "
              "with the sample, hop, finish and train graphs; eval and "
              "group generators lend their state to the run's own")


def stage_steps(tr):
    """Every captured (or capturable) stage of a staged trainer's runs."""
    from legion_tpu_torch.train.graphed import GraphedStep, StageGraph
    out = []
    for run in tr.runs.values():
        for v in vars(run).values():
            for x in v if isinstance(v, list) else [v]:
                if isinstance(x, StageGraph):
                    out.append(x.step)
                elif isinstance(x, GraphedStep):
                    out.append(x)
    return out


def staged_trace(kernels, fn):
    """``fn()`` (a steady epoch) under ``torch.profiler``, run twice in one
    window and read after a spin-kernel mark (as ``traced_launches``):
    each wrapper's kernel counted by name, the wrappers' own counts, the
    device's busy ms (the union of its records' spans) and the wall ms
    between CUDA events around the second run, with the largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from legion_tpu_torch.tools.profile_cached import device_busy_ms
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(1_000_000)              # the mark
        reset_launches(kernels)
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
    counted = read_launches(kernels)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation),
                    key=lambda e: e.time_range.start)
    mark = max(i for i, e in enumerate(events) if "spin_kernel" in e.name)
    events = events[mark + 1:]
    traced = {k: sum(TRACE_NAMES[k] in e.name for e in events)
              for k in kernels}
    by_kernel = {}
    for e in events:
        by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return (traced, counted, device_busy_ms(events),
            ev[0].elapsed_time(ev[1]), [[k[:100], v] for k, v in top])


def staged_vs_eager(kernels, what, captured, eager, state, epoch, figures,
                    comm_epoch=None):
    """A staged path's captured pipeline (``captured``: its trainer on a
    capturing pool) against the same pipeline run eagerly (``eager``: the
    same tables and model, no pool), in this call. ``epoch(tr)`` runs one
    training epoch of ``tr`` from ``state`` and returns its record;
    ``figures``: the record's keys that must be equal; ``comm_epoch``: the
    closed forms' (calls, bytes) of an epoch's collectives, or None.

    (a) From the same state (loaded in place) the captured epoch (its
    first: warm-ups and captures), two eager ones and the captured again
    (replays only): the figures and the trainer's host meters (hot, cold,
    fetches) equal, the losses within ``GRAPHED_LOSS_RTOL`` relative or
    the two eager runs' difference, if larger (K2 backward's atomics),
    the launches equal, and the collectives equal to each other and to
    the closed forms. (b) A steady captured epoch traced: each kernel by
    name equal to the bookkeeping and to the eager epoch's launches, the
    device's busy ms and idle share. (c) ``STAGED_TRIALS`` alternating
    eager / captured epochs from where the state stands: ms/step, the
    host's seconds a step in the stages' calls (enqueue) and in the host
    legs; the capture's seconds and the pool's bytes."""
    import copy
    import statistics

    import torch

    from legion_tpu_torch.tools.scale import timed_stages
    from legion_tpu_torch.train import graphed as graphed_mod
    from legion_tpu_torch.train.train_state import load_optimizer_in_place
    from legion_tpu_torch.utils import comm
    model = state.model
    start = ({k: v.detach().clone() for k, v in model.state_dict().items()},
             copy.deepcopy(state.optimizer.state_dict()),
             state.generator.get_state(), state.step)

    def load():
        model.load_state_dict(start[0])
        load_optimizer_in_place(state.optimizer, copy.deepcopy(start[1]))
        state.generator.set_state(start[2])
        state.step = start[3]

    meters = ("hot", "cold", "host_topo_bytes")
    counted = ("host_topo_copied_bytes", "fetches")

    def one(tr):
        load()
        reset_launches(kernels)
        comm.reset_counts()
        before = dict(getattr(tr, "stats", {}))
        rec = epoch(tr)
        after = getattr(tr, "stats", {})
        return (rec, read_launches(kernels),
                (comm.read_calls(), comm.read_counts()),
                {**{k: after[k] - before[k] for k in meters if k in after},
                 **{k: rec["counts"][k] for k in counted
                    if k in rec["counts"]}})

    first = one(captured)
    eager1 = one(eager)
    eager2 = one(eager)
    steady = one(captured)
    steps = eager1[0]["steps"]

    def rel(a, b):
        a, b = torch.tensor(a[0]["losses"]), torch.tensor(b[0]["losses"])
        return ((a - b).abs() / b.abs()).max().item()
    floor = rel(eager2, eager1)
    worst = max(rel(first, eager1), rel(steady, eager1))
    tol = max(GRAPHED_LOSS_RTOL, floor)
    require(worst <= tol, f"{what}: captured losses within {tol} relative "
            f"of the eager ones, worst {worst} (two eager: {floor})")
    for got, name in ((first, "capturing"), (eager2, "second eager"),
                      (steady, "steady")):
        for k in figures:
            require(got[0][k] == eager1[0][k],
                    f"{what}: {name} epoch's {k} {got[0][k]} equals the "
                    f"eager one's {eager1[0][k]}")
        require(got[3] == eager1[3], f"{what}: {name} epoch's host meters "
                f"{got[3]} equal the eager one's {eager1[3]}")
        require(got[1] == eager1[1], f"{what}: {name} epoch's launches "
                f"{got[1]} equal the eager one's {eager1[1]}")
        require(got[2] == eager1[2], f"{what}: {name} epoch's collectives "
                f"{got[2]} equal the eager one's {eager1[2]}")
    if comm_epoch is not None:
        require(eager1[2] == comm_epoch, f"{what}: an epoch's collectives "
                f"{eager1[2]} are the closed forms' {comm_epoch}")

    traced, counted, busy, wall, top = staged_trace(
        kernels, lambda: epoch(captured))
    require(traced == counted == eager1[1],
            f"{what}: a steady epoch's kernels traced {traced}, counted "
            f"{counted}, eager {eager1[1]}")

    trials = {"eager": [], "graphed": []}
    for _ in range(STAGED_TRIALS):
        for name, tr in (("eager", eager), ("graphed", captured)):
            torch.cuda.synchronize()
            with timed_stages() as spent:
                rec = epoch(tr)
            trials[name].append({
                "ms_per_step": 1e3 * rec["seconds"] / steps,
                "enqueue_ms_per_step": 1e3 * spent[0] / steps,
                **{f"{k}_ms_per_step": 1e3 * rec[k] / steps
                   for k in ("stage_s", "host_sample_s", "fetch_s")
                   if k in rec}})
    timing = {name: {"median_ms_per_step": statistics.median(
                  t["ms_per_step"] for t in ts), "trials": ts}
              for name, ts in trials.items()}
    stages = stage_steps(captured)
    require(all(st.graph is not None for st in stages),
            f"{what}: every stage of the captured trainer replays a graph")
    load()
    return {"steps": steps, "figures_equal": list(figures),
            "host_meters": eager1[3],
            "loss_worst_rel_diff": worst,
            "loss_rel_diff_two_eager": floor, "loss_rtol": tol,
            "launches": eager1[1], "collectives": eager1[2],
            "collectives_closed_forms": comm_epoch,
            "traced": traced, "device_busy_ms_per_step": busy / steps,
            "device_wall_ms_per_step": wall / steps,
            "idle_share": 1.0 - busy / wall, "top_kernels_ms": top,
            "timing": timing, "graphs": len(stages),
            "capture_s": sum(st.capture_s for st in stages),
            "pool_bytes": graphed_mod.pool_bytes(captured.pool),
            "randomness": STAGED_RNG,
            "losses": first[0]["losses"], "eager_losses": eager1[0]["losses"]}


def striped_cached_comm(tr, steps):
    """The closed forms' (calls, bytes) of a striped cached epoch at world
    size 1: a step's two all-to-alls of the feature exchange and its
    gradient all-reduce, and the epoch's all-reduce of its losses and
    figures (float64)."""
    from legion_tpu_torch.utils import comm
    rows = tr.cache.rows
    a2a = comm.exact_exchange_bytes(tr.caps[-1], 1, rows.shape[1],
                                    rows.element_size(),
                                    cap=tr.cache.owner_cap_rows)
    return ({"all_to_all": 2 * steps, "all_reduce": steps + 1},
            {"all_to_all": steps * a2a["all_to_all"],
             "all_reduce": steps * comm.param_bytes(tr.model)
             + 8 * (steps + tr.n_stats + 1)})


def striped_hybrid_comm(tr, steps):
    """The closed forms' (calls, bytes) of a striped hybrid epoch at world
    size 1: two all-to-alls a hot hop (ids with their grid rows, then the
    draws; hops 1.. of every step, hop 0 of every step and the
    prologue's), two of the feature exchange and the gradient's
    all-reduce a step, and the epoch's all-reduce of its losses, counts
    and host figures (float64)."""
    from legion_tpu_torch.utils import comm
    rows = tr.fcache.rows
    feat = comm.exact_exchange_bytes(tr.caps[-1], 1, rows.shape[1],
                                     rows.element_size(),
                                     cap=tr.fcache.owner_cap_rows)
    hop = [comm.exact_exchange_bytes(tr.caps[k], 1, f, 4,
                                     cap=tr.topo_owner_caps[k],
                                     payload=True)["all_to_all"]
           for k, f in enumerate(tr.fanouts)]
    hops = len(tr.fanouts)
    return ({"all_to_all": 2 * (steps * hops + 1) + 2 * steps,
             "all_reduce": steps + 1},
            {"all_to_all": (steps + 1) * hop[0] + steps * sum(hop[1:])
             + steps * feat["all_to_all"],
             "all_reduce": steps * comm.param_bytes(tr.model)
             + 8 * (steps + 2 + tr.n_stats + 5)})


def labels_of(data, seeds):
    """The (rows, batch) int32 labels of ``seeds`` (a numpy array)."""
    import torch
    return torch.as_tensor(data.labels)[torch.as_tensor(seeds).long()].int(
        ).numpy()


def staged_batch(tr, eager, seeds, count):
    """One batch of ``seeds`` through a hybrid trainer's own stages (an
    eval pass of one step on ``eager``, its twin without a pool): the
    batch and its feature plan, from the run's static buffers."""
    import torch
    s = torch.as_tensor(seeds).int()[None].numpy()
    eager.eval_epoch(tr.model, s, torch.tensor([count]).int().numpy(),
                     torch.zeros_like(torch.from_numpy(s)).numpy())
    run = next(r for k, r in eager.runs.items() if k[0] == "eval")
    return eager._batch(run)


def gcn_path(kernels, data, dtype):
    """GCN at full width on the main path's graph through the Trainer: one
    epoch and a validation pass, the launch counts of both, and one eval
    batch's logits against the CPU plain path (float32: 1e-4 x
    max|logit|; bf16: 3e-2, a few bf16 ulps through two layers whose
    products round at different points on the two devices)."""
    import torch

    from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                         SamplerConfig, TrainConfig)
    from legion_tpu_torch.train.loop import Trainer
    cfg = Config(
        dataset=DatasetConfig(num_classes=CLASSES),
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=8000,
                              observed_cap_slack=1.03, dedup_last=False),
        model=ModelConfig(arch="gcn", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype=dtype),
        train=TrainConfig(learning_rate=0.003))
    t0 = time.perf_counter()
    tr = Trainer(cfg, data, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_launches(kernels)
    rec = tr.train_one_epoch(0)
    train_launches = read_launches(kernels)
    reset_launches(kernels)
    valid_acc = tr.evaluate("valid")
    eval_launches = read_launches(kernels)
    require(all(math.isfinite(v) for v in rec["losses"]),
            f"finite GCN {dtype} losses")
    require(rec["cap_overflow"] == 0, f"no cap overflow in GCN {dtype}")
    require(0.0 <= valid_acc <= 1.0, f"GCN {dtype} validation accuracy")
    t, e = rec["steps"], tr.plan.valid_steps
    bf16 = dtype == "bfloat16"
    # layer 0's identity block: K1 ("sqrt") in bf16, K5 in float32;
    # layer 1: K2 ("sum") forward every step, backward every train step
    want = {"identity_masked_mean": (t if bf16 else 0, e if bf16 else 0),
            "grouped_masked_sum": (0 if bf16 else t, 0 if bf16 else e),
            "gathered_masked_mean": (t, e),
            "gathered_masked_mean_backward": (t, 0),
            "dedup_tail": (t, e), "gathered_feature_mean": (0, 0),
            "act_dropout": (t, 0), "act_dropout_backward": (t, 0)}
    for name, (nt, ne) in want.items():
        require((train_launches[name], eval_launches[name]) == (nt, ne),
                f"GCN {dtype} launched {name} {nt} times in {t} train steps "
                f"and {ne} in {e} eval steps, got {train_launches[name]} and "
                f"{eval_launches[name]}")
    err, scale = logits_vs_cpu(tr, cfg, data.valid_ids[:512],
                               3e-2 if bf16 else 1e-4)
    # 5 replays of the captured step traced: K1 or K5 as the dtype picks
    traced = replays_traced(kernels, trainer_scan(tr, 5), 5, {
        "sample_neighbors": 2, "gather_rows": 1,
        **{k: nt // t for k, (nt, _) in want.items()}}, f"GCN {dtype}")
    launches = {k: train_launches[k] + eval_launches[k] for k in kernels}
    emit({"phase": f"gcn_{dtype}", "trainer_init_s": init_s,
          "caps": list(tr.caps), "steps": t, "eval_steps": e,
          "losses": rec["losses"], "cap_overflow": rec["cap_overflow"],
          "ms_per_step": 1e3 * rec["epoch_s"] / t,
          "edges_per_s": rec["edges_per_s"], "valid_acc": valid_acc,
          "train_launches": train_launches, "eval_launches": eval_launches,
          "logits_vs_cpu_max_abs_err": err, "logits_max_abs": scale,
          "replays_traced": traced,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches


def gat_kernels():
    """name -> (wrapper, TPU kernel it replaces) of GAT's attention: none,
    ``legion_tpu`` has no GAT."""
    from legion_tpu_torch.ops.gat_attention import (
        edge_softmax_aggregate, edge_softmax_aggregate_backward)
    return {"edge_softmax_aggregate": (edge_softmax_aggregate, None),
            "edge_softmax_aggregate_backward": (
                edge_softmax_aggregate_backward, None)}


def score_grad_scale(z, a_src, a_dst, pos, mask, num_dst, g,
                     chunk=1 << 15):
    """(mag_src (S, H), mag_dst (D, H), named (S,)) in float32: the summed
    magnitudes of the terms each score gradient adds up, and the slots
    that name each src row. Slot s of dst row d adds leaky'(raw) * alpha_s
    * (g[d] . z[j_s] - sum_t alpha_t g[d] . z[j_t]) to da_src[j_s] and to
    da_dst[d]; its magnitude takes |g[d]| . |z[j]| for each dot. Two float32
    sums of those terms in different orders differ by float32 ulps of
    that magnitude, not of the (cancelling) sum. Chunks of dst rows keep the (rows, F + 1, H, C)
    gathers small."""
    import torch
    import torch.nn.functional as F

    from legion_tpu_torch.ops import gat_attention as ga
    s, h, _ = z.shape
    dn = pos.shape[0]
    dev = z.device
    ok = ga.scored(pos, mask, s, num_dst)                     # (D, F+1)
    za, asrc, adst = z.float().abs(), a_src.float(), a_dst.float()
    mag_src = torch.zeros((s, h), dtype=torch.float32, device=dev)
    mag_dst = torch.zeros((dn, h), dtype=torch.float32, device=dev)
    named = torch.zeros((s,), dtype=torch.float32, device=dev)
    for d0 in range(0, dn, chunk):
        d1 = min(dn, d0 + chunk)
        rows = torch.arange(d0, d1, device=dev)[:, None]
        p = torch.cat([pos[d0:d1].clamp(0, s - 1), rows], 1).long()
        live = ok[d0:d1]
        raw = asrc[p] + adst[d0:d1, None, :]                  # (c, F+1, H)
        e = F.leaky_relu(raw, ga.NEGATIVE_SLOPE).masked_fill(
            ~live[..., None], float("-inf"))
        alpha = torch.softmax(e, 1).nan_to_num(0.0)
        gz = (g[d0:d1].float().abs()[:, None] * za[p]).sum(-1)
        slope = torch.where(raw > 0, 1.0, ga.NEGATIVE_SLOPE)
        term = slope * alpha * (gz + (alpha * gz).sum(1, keepdim=True))
        term = term * live[..., None]
        mag_dst[d0:d1] = term.sum(1)
        mag_src.index_add_(0, p.reshape(-1), term.reshape(-1, h))
        named.index_add_(0, p.reshape(-1), live.reshape(-1).float())
    return mag_src, mag_dst, named


def within_score_grad(k, p, mag, rel=1e-4):
    """(ok, worst): element by element within 1 bf16 ulp relative (8e-3,
    as ``within_bf16``) plus ``rel`` of the element's summed term
    magnitudes (``mag``), the room two float32 sums of the same terms in
    other orders need; worst is the largest |err| over its room. No
    absolute floor: an element no slot reaches reads 0 on both sides."""
    import torch
    err = (k.float() - p.float()).abs()
    room = 8e-3 * p.float().abs() + rel * mag
    worst = (err / room.clamp(min=torch.finfo(torch.float32).tiny)).max()
    return bool((err <= room).all()), float(worst)


def check_gat_attention(z, a, dn, blk, heads, fanout, g):
    """The edge-softmax kernels against their plain version on one layer's
    inputs: z (S, H, C), the scores a (S, 2H), the block and an upstream
    gradient g (D, H, C). The output and dz within 1 bf16 ulp relative
    (8e-3) plus 1e-3 (both round one f32 sum); the score gradients element
    by element within 1 bf16 ulp of their value plus 1e-4 of the magnitude
    of the terms each sums (``score_grad_scale``: a hub's da_src sums
    thousands of terms that cancel, an ordinary row's a few, so one bound
    for all would be loose on the ordinary rows). That check must refuse
    the kernel's da_src with the rows that 1 or 2 slots name zeroed. Times
    of the forward and of the backward (CUDA events), the plain forward's,
    and their byte bound at this block's live sizes."""
    import torch

    from legion_tpu_torch.ops import gat_attention as ga
    h = heads
    s, _, c = z.shape
    pos, mask, nd = blk.nbr_pos, blk.nbr_mask, blk.num_dst
    got, want = [], []
    for fn, out in ((ga.edge_softmax_aggregate, got),
                    (ga.edge_softmax_aggregate_plain, want)):
        zz, aa = (t.detach().clone().requires_grad_(True) for t in (z, a))
        with torch.enable_grad():
            o = fn(zz, aa[:, :h], aa[:dn, h:], pos, mask, nd)
            o.backward(g)
        torch.cuda.synchronize()
        out += [o.detach(), zz.grad, aa.grad[:, :h], aa.grad[:dn, h:]]
        del zz, aa, o
    errs = [float((k.float() - p.float()).abs().max())
            for k, p in zip(got, want)]
    what = f"GAT attention at {[s, dn, fanout, h, c]}"
    require(within_bf16(got[0], want[0]), f"{what}: forward within 1 ulp")
    require(within_bf16(got[1], want[1]), f"{what}: dz within 1 ulp")
    mag_src, mag_dst, named = score_grad_scale(
        z.detach(), a.detach()[:, :h], a.detach()[:dn, h:], pos, mask, nd, g)
    worst = {}
    for i, name, mag in ((2, "da_src", mag_src), (3, "da_dst", mag_dst)):
        ok, worst[name] = within_score_grad(got[i], want[i], mag)
        require(ok, f"{what}: {name} element by element within 1 ulp + "
                f"1e-4 of its terms' magnitude, worst at {worst[name]} of "
                f"its room")
    few = (named >= 1) & (named <= 2)
    fault = got[2].clone()
    fault[few] = 0
    require(bool(few.any()) and not within_score_grad(fault, want[2],
                                                      mag_src)[0],
            f"{what}: the da_src check refuses the rows 1 or 2 slots name "
            f"zeroed")
    top = float(want[2].float().abs().max())
    src_abs = want[2].float().abs()[named > 0]
    zd, ad = z.detach(), a.detach()
    out, stats = ga._forward_cuda(zd, ad[:, :h], ad[:dn, h:], pos, mask, nd)
    live = int(nd)
    traffic = ga.edge_softmax_traffic(int(blk.num_src), live, fanout, h, c,
                                      z.element_size())
    rec = {"shape": [s, dn, fanout, h, c], "live_dst": live,
           "scored_slots": int(ga.scored_slots(pos, mask, s, nd)),
           "max_abs_err": errs[0],
           "max_abs_err_grads": dict(zip(("dz", "da_src", "da_dst"),
                                         errs[1:])),
           # the score gradients' worst |err| over its room (<= 1 passes),
           # da_src's scale, and whether the former rule (2 % of the
           # largest |da_src|) would have passed the zeroed rows
           "score_grads_worst_share_of_room": worst,
           "da_src_abs": {"max": top,
                          "median": float(src_abs.median()),
                          "median_few": float(want[2].float().abs()[
                              few].median())},
           "rows_named_by_1_or_2": int(few.sum()),
           "max_named": int(named.max()),
           "former_rule_passes_fault": bool(
               float((fault.float() - want[2].float()).abs().max())
               <= 2e-2 * top + 1e-3),
           "ms": time_ms(lambda: ga._forward_cuda(
               zd, ad[:, :h], ad[:dn, h:], pos, mask, nd), reps=5),
           "plain_ms": time_ms(lambda: ga.edge_softmax_aggregate_plain(
               zd, ad[:, :h], ad[:dn, h:], pos, mask, nd), reps=2,
               trials=3),
           "backward_ms": time_ms(lambda: ga.edge_softmax_aggregate_backward(
               g, zd, ad[:, :h], ad[:dn, h:], pos, mask, nd, stats), reps=5),
           **bound(traffic["forward"], 0),
           "backward_bound_ms": bound(traffic["backward"], 0)["bound_ms"],
           "library_ms": None}
    return rec


def gat_path(kernels, data):
    """GAT (PyG's ogbn-products example: 3 layers, 4 heads of 128, fanout
    [10, 10, 10], every hop deduplicated, bf16) on the main path's graph
    through the Trainer at batch 8000: the edge-softmax kernels against
    their plain version at layer 0's and layer 2's shapes on one sampled
    batch; one epoch (finite losses, no cap overflow, the ``attn_slots``
    counter) and a validation pass; and the launches of 5 replays of the
    captured step, each kernel counted by name in a ``torch.profiler``
    trace: the sampling kernel and the dedup's tail 3 times a step, K3
    once, the attention's forward 3 times and its backward 3 times (one
    ``edge_softmax_src_kernel`` each), the activation-dropout forward and
    backward twice (after layers 0 and 1), K1, K2 and K5 never; the
    validation pass launches no activation-dropout. Returns the phase's
    line, whose ``launches`` are the epoch's and the validation pass's."""
    import torch

    from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                         SamplerConfig, TrainConfig)
    from legion_tpu_torch.sampling.sampler import (gather_features,
                                                   sample_batch)
    from legion_tpu_torch.train.loop import Trainer
    dev = torch.device("cuda")
    fanouts, heads = (10, 10, 10), 4
    cfg = Config(
        dataset=DatasetConfig(num_classes=CLASSES),
        sampler=SamplerConfig(fanouts=fanouts, batch_size=8000,
                              dedup_last=True),
        model=ModelConfig(arch="gat", hidden_dim=128, num_layers=3,
                          dropout=0.5, dtype="bfloat16", num_heads=heads),
        train=TrainConfig(learning_rate=0.001))
    t0 = time.perf_counter()
    tr = Trainer(cfg, data, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b = cfg.sampler.batch_size
    seed_ids = data.train_ids[:b].copy()
    batch = sample_batch(
        tr.graph, torch.from_numpy(seed_ids).to(dev),
        torch.tensor(b, dtype=torch.int32, device=dev),
        torch.from_numpy(data.labels[seed_ids]).to(dev), fanouts, tr.caps,
        dedup_last=True, generator=torch.Generator(device=dev).manual_seed(0))
    blocks = tuple(reversed(batch.blocks))          # model order
    gen = torch.Generator(device=dev).manual_seed(3)
    checks = {}
    with torch.no_grad():
        h = gather_features(tr.features, batch.frontier)
        for i, (layer, blk) in enumerate(zip(tr.model.layers, blocks)):
            if i in (0, 2):
                _, z, a = layer.project(h)
                g = torch.randn((blk.dst_cap,) + z.shape[1:], generator=gen,
                                device=dev).to(z.dtype)
                checks[f"layer{i}"] = check_gat_attention(
                    z, a, blk.dst_cap, blk, heads, fanouts[2 - i], g)
                del z, a, g
            h = layer(blk, h)
            if i < 2:
                h = torch.nn.functional.elu(h)
    del h
    torch.cuda.synchronize()
    all_kernels = {**kernels, **gat_kernels()}
    reset_launches(all_kernels)
    rec = tr.train_one_epoch(0)
    train_launches = read_launches(all_kernels)
    valid_acc = tr.evaluate("valid")
    launches = read_launches(kernels)          # the epoch's and the eval's
    require(all(launches[k] == train_launches[k]
                for k in ("act_dropout", "act_dropout_backward")),
            f"GAT's eval steps launch no activation-dropout: {launches}")
    require(all(math.isfinite(v) for v in rec["losses"]), "finite GAT losses")
    require(rec["cap_overflow"] == 0, "no cap overflow in GAT")
    require(rec["counts"].get("attn_slots", 0) > 0,
            "GAT's epoch counts its scored slots")
    per_step = {k: 0 for k in all_kernels}
    per_step.update(sample_neighbors=3, dedup_tail=3, gather_rows=1,
                    edge_softmax_aggregate=3,
                    edge_softmax_aggregate_backward=3, act_dropout=2,
                    act_dropout_backward=2)
    t = rec["steps"]
    require(train_launches == {k: t * n for k, n in per_step.items()},
            f"GAT launched {train_launches} in {t} train steps, want "
            f"{per_step} a step")
    traced = replays_traced(all_kernels, trainer_scan(tr, 5), 5, per_step,
                            "GAT")
    line = {"phase": "gat", "trainer_init_s": init_s, "caps": list(tr.caps),
            "steps": t, "losses": rec["losses"],
            "cap_overflow": rec["cap_overflow"],
            "attn_slots_per_step": rec["counts"]["attn_slots"] / t,
            "ms_per_step": 1e3 * rec["epoch_s"] / t,
            "edges_per_s": rec["edges_per_s"], "valid_acc": valid_acc,
            "launches_per_step": per_step, "launches": launches,
            "replays_traced": traced, "kernel_checks": checks,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(line)
    del tr
    torch.cuda.empty_cache()
    return line


def act_dropout_case(rows, width, act, seed):
    """One shape of ``check_act_dropout``: the kernels against the plain
    chain (``dropout`` after the activation) from one generator state."""
    import torch

    from legion_tpu_torch.ops.act_dropout import (
        ACTIVATIONS, act_dropout, act_dropout_backward, act_dropout_forward,
        act_dropout_traffic, dropout, unpack_bits)
    dev, rate, keep = torch.device("cuda"), 0.5, 0.5
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((rows, width), generator=gen, device=dev).bfloat16()
    g = torch.randn((rows, width), generator=gen, device=dev).bfloat16()
    n, what = h.numel(), f"act_dropout {act} at {[rows, width]} bf16"

    def run(fn):
        x = h.clone().requires_grad_(True)
        out = fn(x, torch.Generator(device=dev).manual_seed(seed + 1))
        (dx,) = torch.autograd.grad(out, x, g)
        return out.detach(), dx

    def chain(x, gen):
        return dropout(ACTIVATIONS[act](x), rate, gen)
    out, dh = run(lambda x, gen: act_dropout(x, act, rate, gen))
    want, want_dh = run(chain)
    u = torch.rand((rows, width), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(seed + 1))
    _, bits = act_dropout_forward(h, u, keep, act)
    kept = (u < keep) & (h > 0) if act == "relu" else u < keep
    require(torch.equal(unpack_bits(bits, n), kept.reshape(-1)),
            f"{what}: the mask is the chain's")
    if act == "elu":
        require(within_bf16(out, want) and within_bf16(dh, want_dh),
                f"{what}: output and gradient within 1 bf16 ulp")
    else:
        require(torch.equal(out, want) and torch.equal(dh, want_dh),
                f"{what}: output and gradient bitwise the chain's")
    traffic = act_dropout_traffic(n, 2, act)
    x = h.clone().requires_grad_(True)
    plain = chain(x, torch.Generator(device=dev).manual_seed(seed + 2))
    rec = {"shape": [rows, width], "act": act, "dtype": "bfloat16",
           "kept_share": float(kept.float().mean()),
           "fwd": {"max_abs_err": float((out.float() - want.float()).abs()
                                        .max()),
                   **bound(traffic["forward"], 0),
                   "ms": time_ms(lambda: act_dropout_forward(h, u, keep,
                                                             act)),
                   "cold_ms": time_ms(lambda: act_dropout_forward(
                       h, u, keep, act), cold=True),
                   # the draw and the kernel, against the chain it replaced
                   "op_ms": time_ms(lambda: act_dropout(h, act, rate, gen)),
                   "plain_ms": time_ms(lambda: chain(h, gen)),
                   "library_ms": None},
           "bwd": {"max_abs_err": float((dh.float() - want_dh.float()).abs()
                                        .max()),
                   **bound(traffic["backward"], 0),
                   "ms": time_ms(lambda: act_dropout_backward(g, bits, h,
                                                              keep, act)),
                   "cold_ms": time_ms(lambda: act_dropout_backward(
                       g, bits, h, keep, act), cold=True),
                   "plain_ms": time_ms(lambda: torch.autograd.grad(
                       plain, x, g, retain_graph=True)),
                   "library_ms": None}}
    return rec


def check_act_dropout(results, relu_rows, elu_rows):
    """The activation-dropout kernels (``ops/act_dropout.py``) at the main
    path's layer-0 shape (``relu_rows`` x 256, ReLU) and GAT's
    (``elu_rows`` x 512, ELU), bf16, rate 0.5; the main path's shape
    fills the kernels line's results of both, each shape their
    ``shapes``. The byte bound: forward h, the f32 uniforms and the
    output once and a bit an element; backward the gradient, the bits and
    dh (ELU: h). Their launches are counted on every full-width path."""
    cases = {"sage_layer0_relu": act_dropout_case(relu_rows, 256, "relu", 11),
             "gat_layer0_elu": act_dropout_case(elu_rows, 512, "elu", 13)}
    for name, part in (("act_dropout", "fwd"),
                       ("act_dropout_backward", "bwd")):
        results[name].update(
            {k: cases["sage_layer0_relu"][part][k] for k in KERNEL_KEYS},
            shapes={c: r[part] for c, r in cases.items()})
    return {"phase": "act_dropout", "cases": cases}


def gcn_learns(data):
    """GCN (float32, hidden 256) on the planted-label graph for 2 epochs:
    the loss must fall. Accuracy is not judged: GraphConv has no
    self-feature path and about half of the planted signal is the node's
    own features, so GCN stays near chance on this graph by design."""
    from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                         SamplerConfig, TrainConfig)
    from legion_tpu_torch.train.loop import Trainer
    cfg = Config(dataset=DatasetConfig(num_classes=CLASSES),
                 sampler=SamplerConfig(fanouts=(25, 10), batch_size=1024),
                 model=ModelConfig(arch="gcn", hidden_dim=256, num_layers=2),
                 train=TrainConfig(epochs=2))
    tr = Trainer(cfg, data, device="cuda")
    res = tr.fit(log=stderr_log)
    loss = [h["mean_loss"] for h in res["history"]]
    require(all(math.isfinite(v) for v in loss) and loss[1] < loss[0],
            f"GCN's mean loss falls ({loss})")
    return {"mean_loss": loss, "valid_acc": tr.evaluate("valid"),
            "test_acc": res["test_acc"]}


def lp_sage_path(data):
    """LP-SAGE (SAGE-256 float32, batch 1023 = 3 x 341 pairs) on the
    planted-label graph: 2 epochs through the Trainer, 1 through the
    cached driver."""
    from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                         ModelConfig, SamplerConfig,
                                         TrainConfig)
    from legion_tpu_torch.train.cached_driver import run_cached_training
    from legion_tpu_torch.train.loop import Trainer

    def check(loss, valid, logs, what):
        require(all(math.isfinite(v) for v in loss), f"{what}: finite loss")
        require(math.isfinite(valid) and loss[-1] / 5 < valid < loss[-1] * 5,
                f"{what}: eval LP loss {valid} within a factor 5 of the "
                f"train loss {loss[-1]}")
        require(any("Val LP-loss" in s for s in logs)
                and not any("Val Acc" in s for s in logs),
                f"{what}: the epoch line says Val LP-loss")

    def cfg(epochs, **kw):
        return Config(dataset=DatasetConfig(num_classes=CLASSES,
                                            **kw.pop("dataset", {})),
                      sampler=SamplerConfig(fanouts=(25, 10), batch_size=1023,
                                            **kw.pop("sampler", {})),
                      model=ModelConfig(arch="lp_sage", hidden_dim=256,
                                        num_layers=2),
                      train=TrainConfig(epochs=epochs), **kw)

    logs = []

    def log(s):
        logs.append(s)
        stderr_log(s)

    tr = Trainer(cfg(2), data, device="cuda")
    res = tr.fit(log=log)
    loss = [h["mean_loss"] for h in res["history"]]
    valid = tr.evaluate("valid")
    check(loss, valid, logs, "LP-SAGE Trainer")
    require(loss[1] < loss[0], f"LP-SAGE's mean loss falls ({loss})")
    del tr
    logs.clear()
    # the cached driver pads an eval batch to the train batch, and a pair
    # needs all three thirds of that: eval batches as large as the batch
    cres = run_cached_training(
        cfg(1, dataset={"feature_placement": "host"},
            sampler={"dedup_last": True, "eval_batch_size": 1023},
            cache=CacheConfig(enabled=True, budget_bytes=data.num_nodes // 4
                              * data.feature_dim * 4)),
        data, "cuda", log=log)
    ch = cres["history"][0]
    check(ch["losses"], ch["valid"], logs, "LP-SAGE cached driver")
    require(ch["losses"][-1] < ch["losses"][0],
            "LP-SAGE's loss falls within the cached epoch")
    return {"mean_loss": loss, "valid_lp_loss": valid,
            "test_lp_loss": res["test_acc"],
            "cached": {"first_loss": ch["losses"][0],
                       "last_loss": ch["losses"][-1],
                       "valid_lp_loss": ch["valid"],
                       "test_lp_loss": cres["test_acc"],
                       "hit_rate": ch["cache_hit_rate"]}}


def checkpoint_resume(data):
    """A Trainer (SAGE-256 float32, dropout 0.5) saves after one epoch; a
    fresh one on the same directory resumes at epoch 1 with equal
    parameters and generator state. Both then run epoch 1, the first as
    the uninterrupted run: their losses agree within 1e-3 relative (K2
    backward's float atomics add in an order that changes between runs,
    so two runs of one state are equal only to rounding)."""
    import torch

    from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                         SamplerConfig, TrainConfig)
    from legion_tpu_torch.train.loop import Trainer
    from legion_tpu_torch.train.train_state import latest_checkpoint
    with tempfile.TemporaryDirectory() as ck:
        cfg = Config(dataset=DatasetConfig(num_classes=CLASSES),
                     sampler=SamplerConfig(fanouts=(25, 10), batch_size=1024),
                     model=ModelConfig(arch="sage", hidden_dim=256,
                                       num_layers=2),
                     train=TrainConfig(epochs=1, checkpoint_dir=ck))
        first = Trainer(cfg, data, device="cuda")
        first.fit(log=stderr_log)
        steps = first.plan.train_steps
        saved = latest_checkpoint(ck)
        require(saved is not None and saved.endswith(f"step_{steps}"),
                f"a checkpoint at step {steps}")
        resumed = Trainer(cfg, data, device="cuda")
        require((resumed.state.epoch, resumed.state.step) == (1, steps),
                "the fresh trainer resumes at epoch 1")
        require(all(torch.equal(a, b) for a, b in zip(
            resumed.model.parameters(), first.model.parameters())),
            "equal parameters after the restore")
        require(torch.equal(resumed.state.generator.get_state(),
                            first.state.generator.get_state()),
                "equal generator state after the restore")
        want = first.train_one_epoch(1)["losses"]
        got = resumed.train_one_epoch(1)["losses"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    require(len(got) == steps and worst <= 1e-3,
            f"the resumed epoch's losses match the uninterrupted run's "
            f"(worst relative difference {worst})")
    return {"checkpoint": os.path.basename(saved), "steps": steps,
            "losses_equal": got == want, "worst_rel_diff": worst,
            "resumed_last_loss": got[-1], "uninterrupted_last_loss": want[-1]}


def mesh_dp(kernels, results, data, smi):
    """Phase "mesh_dp": data-parallel training at world size 1 through
    NCCL on the main path's configuration and graph. A ``Trainer`` with
    ``probe_caps=False`` (MeshTrainer's loose caps) trains two epochs;
    then this process joins a one-rank NCCL group and a ``MeshTrainer``
    trains one epoch and a validation pass (then a second epoch, whose
    ms/step is the steady state printed beside the Trainer's second
    epoch). Its first 5 losses must match
    the Trainer's within 1e-3 relative (the same weights, stream and caps;
    K2 backward's float atomics make two runs equal only to rounding),
    the counting wrapper must show one all-reduce of the parameter bytes
    a step plus one of the epoch's metrics (and a step counted alone one
    all-reduce of exactly the parameter bytes), and the launch counts
    must be exact: per train step the sampling kernel 2, K1, K2 forward,
    K2 backward, K3 and the activation-dropout forward and backward once
    each, K5 never; per eval step the same but K2 backward and the
    activation-dropout. After the run every kernel of the path is held
    against its plain version on one batch of the MeshTrainer sampled at
    its loose caps (``kernel_checks``): the sampling kernel on both hops,
    K3 on the whole frontier (-1 padding included), K1 on the identity
    block and K2 forward and backward on layer 1's block, each with the
    tolerance of the main path's check."""
    import torch
    import torch.distributed as dist

    from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                         ParallelConfig, SamplerConfig,
                                         TrainConfig)
    from legion_tpu_torch.parallel import mesh
    from legion_tpu_torch.parallel.trainer import MeshTrainer
    from legion_tpu_torch.train import graphed as graphed_mod
    from legion_tpu_torch.train.loop import Trainer
    from legion_tpu_torch.utils import comm
    cfg = Config(
        dataset=DatasetConfig(num_classes=CLASSES),
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=8000,
                              observed_cap_slack=1.03, probe_caps=False),
        model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype="bfloat16"),
        train=TrainConfig(learning_rate=0.003),
        parallel=ParallelConfig(num_devices=1))
    ref = Trainer(cfg, data, device="cuda")
    want = ref.train_one_epoch(0)
    want_steady = ref.train_one_epoch(1)
    ref_caps = ref.caps
    del ref
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_process(0, 1, os.path.join(tmp, "init"), "cuda")
        try:
            backend = dist.get_backend()
            require(backend == "nccl", f"the one-rank group runs NCCL, not "
                    f"{backend}")
            t0 = time.perf_counter()
            tr = MeshTrainer(cfg, data, device="cuda")
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            reset_launches(kernels)
            comm.reset_counts()
            rec = tr.train_one_epoch(0)
            train_launches = read_launches(kernels)
            epoch_counts, epoch_calls = comm.read_counts(), comm.read_calls()
            reset_launches(kernels)
            valid_acc = tr.evaluate("valid")
            eval_launches = read_launches(kernels)
            pb = comm.param_bytes(tr.model)
            # one more step counted alone, and the all-reduce of a buffer
            # of the parameters' size timed by itself
            comm.reset_counts()
            ids = tr.shards_train[0][:8000]
            tr.fns.train_step(tr.state, tr.graph, tr.features,
                              torch.from_numpy(ids.copy()).cuda(),
                              torch.tensor(8000, dtype=torch.int32,
                                           device="cuda"),
                              torch.from_numpy(data.labels[ids]).cuda())
            torch.cuda.synchronize()
            step_counts, step_calls = comm.read_counts(), comm.read_calls()
            buf = torch.zeros(pb // 4, dtype=torch.float32, device="cuda")
            allreduce_ms = time_ms(lambda: dist.all_reduce(buf))
            steady = tr.train_one_epoch(1)
            captured = mesh_trainer_captured(
                kernels, "mesh_dp", tr, data,
                ({"all_reduce": 1}, {"all_reduce": pb}))
        finally:
            dist.destroy_process_group()
    t, e = rec["steps"], tr.plan.valid_steps
    require(tr.caps == ref_caps == (8000, 208000, 2288000),
            f"MeshTrainer and the unprobed Trainer at the loose caps, got "
            f"{tr.caps} and {ref_caps}")
    require(all(math.isfinite(v) for v in rec["losses"]),
            "finite MeshTrainer losses")
    require(rec["cap_overflow"] == 0, "no cap overflow at the loose caps")
    worst = max(abs(a - b) / abs(b) for a, b in
                zip(rec["losses"][:5], want["losses"][:5]))
    require(t == want["steps"] and worst <= 1e-3,
            f"MeshTrainer's first 5 losses match the Trainer's (worst "
            f"relative difference {worst})")
    require(step_calls == {"all_reduce": 1} and step_counts["all_reduce"] == pb,
            f"one all-reduce of {pb} parameter bytes in a step, got "
            f"{step_calls} / {step_counts}")
    require(epoch_calls == {"all_reduce": t + 1}
            and epoch_counts["all_reduce"]
            == t * pb + t * len(graphed_mod.METRICS) * 8,
            f"an epoch of {t} steps: one parameter-sized all-reduce a step "
            f"and one of the metrics, got {epoch_calls} / {epoch_counts}")
    want_train = {"sample_neighbors": 2 * t, "identity_masked_mean": t,
                  "gathered_masked_mean": t,
                  "gathered_masked_mean_backward": t, "gather_rows": t,
                  "grouped_masked_sum": 0, "dedup_tail": t,
                  "gathered_feature_mean": 0, "act_dropout": t,
                  "act_dropout_backward": t}
    want_eval = dict(want_train, sample_neighbors=2 * e,
                     identity_masked_mean=e, gathered_masked_mean=e,
                     gathered_masked_mean_backward=0, gather_rows=e,
                     dedup_tail=e, act_dropout=0, act_dropout_backward=0)
    require(train_launches == want_train and eval_launches == want_eval,
            f"exact launches: train {train_launches} (want {want_train}), "
            f"eval {eval_launches} (want {want_eval})")
    # every kernel at the loose caps' shapes, against its plain version
    checks = trainer_kernel_checks(tr, data.labels, seed=6)
    record_kernel_checks(results, "mesh_dp", checks)
    emit({"phase": "mesh_dp", "nvidia_smi": smi, "backend": backend,
          "world": 1, "mesh": tr.mesh.shape, "caps": list(tr.caps),
          "init_s": init_s, "steps": t, "eval_steps": e,
          "losses": rec["losses"], "trainer_losses": want["losses"],
          "first5_worst_rel_diff": worst,
          "epoch0_ms_per_step": 1e3 * rec["epoch_s"] / t,
          "trainer_epoch0_ms_per_step": 1e3 * want["epoch_s"] / t,
          "ms_per_step": 1e3 * steady["epoch_s"] / t,
          "trainer_ms_per_step": 1e3 * want_steady["epoch_s"] / t,
          "edges_per_s": steady["edges_per_s"], "valid_acc": valid_acc,
          "param_bytes": pb, "allreduce_ms": allreduce_ms,
          "step_counts": step_counts, "epoch_counts": epoch_counts,
          "train_launches": train_launches, "eval_launches": eval_launches,
          "kernel_checks": checks, "captured": captured,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return ({k: train_launches[k] + eval_launches[k] for k in kernels},
            rec["losses"], 1e3 * steady["epoch_s"] / t)


def cli_runs(smi):
    """Phase "cli": ``python -m legion_tpu_torch.train`` as a user runs it
    on the card, four times: the reference's verify recipe (50k-node
    planted-label graph, 2 epochs, batch 1024, ``--profile-dir``) must
    reach validation accuracy > 0.15, print the test line and write epoch
    0's trace, which must hold kernels and graph launches (the epoch's
    first step, its capture and the replays of the others); ``--topology host`` with no
    budget (the repaired case) must warn, finish, and report both caches
    empty; ``--devices 2`` on this one-card machine must exit non-zero
    naming the card count; and ``--partitioned --devices 1`` on the
    verify recipe (one rank through NCCL) must reach > 0.15 and print the
    test line."""
    import re

    import torch
    env = dict(os.environ, PYTHONPATH=REPO)

    def run(*flags, timeout=300):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "legion_tpu_torch.train",
                            *flags], capture_output=True, text=True,
                           timeout=timeout, cwd=REPO, env=env)
        return r, time.perf_counter() - t0

    out = {}
    os.makedirs(os.path.join(REPO, ".bench_cache"), exist_ok=True)
    prof_dir = tempfile.mkdtemp(prefix="cli_profile_",
                                dir=os.path.join(REPO, ".bench_cache"))
    try:
        r, secs = run("--synthetic", "50000", "--epochs", "2",
                      "--batch-size", "1024", "--profile-dir", prof_dir)
        trace = os.path.join(prof_dir, "epoch_0.pt.trace.json")
        require(r.returncode == 0 and os.path.exists(trace),
                f"the verify recipe exits 0 and writes its trace: "
                f"{r.stderr[-2000:]}")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    profile = {"kernels": sum(e.get("cat") == "kernel" for e in events),
               "graph_launches": sum("cudaGraphLaunch" in e.get("name", "")
                                     for e in events)}
    require(profile["kernels"] > 0 and profile["graph_launches"] > 0,
            f"epoch 0's trace holds kernels and graph launches: {profile}")
    accs = [float(a) for a in re.findall(r"Val Acc: ([0-9.]+)", r.stdout)]
    require(len(accs) == 2 and accs[-1] > 0.15,
            f"the verify recipe reaches Val Acc > 0.15, got {accs}")
    require("Accuracy on test data" in r.stdout,
            "the verify recipe prints the test line")
    out["verify"] = {"valid_acc": accs, "seconds": secs, "profile": profile,
                     "test_line": r.stdout.strip().splitlines()[-1]}
    r, secs = run("--synthetic", "20000", "--topology", "host", "--epochs",
                  "1", "--batch-size", "1024")
    require(r.returncode == 0,
            f"--topology host with no budget exits 0: {r.stderr[-2000:]}")
    require("zero hot cache, every hop/feature is host-served" in r.stderr,
            "--topology host with no budget warns")
    require("feat_cap=0 topo_cap=0" in r.stdout
            and "feat_hit:0.000, topo_hot:0.000" in r.stdout,
            "both caches empty")
    out["host_topology_no_budget"] = {
        "seconds": secs, "lines": [s for s in r.stdout.splitlines()
                                   if s.startswith(("cost model", "Epoch",
                                                    "Accuracy"))]}
    r, secs = run("--devices", "2", "--synthetic", "2000", "--epochs", "1")
    n = torch.cuda.device_count()
    msg = f"2 ranks need 2 CUDA devices; this process sees {n}"
    require(n < 2 and r.returncode != 0 and msg in r.stderr,
            f"--devices 2 on {n} card(s) exits non-zero naming the count: "
            f"rc {r.returncode}, {r.stderr[-500:]}")
    out["devices_2"] = {"returncode": r.returncode, "message": msg,
                        "seconds": secs}
    r, secs = run("--partitioned", "--devices", "1", "--synthetic", "50000",
                  "--epochs", "2", "--batch-size", "1024")
    require(r.returncode == 0,
            f"--partitioned on the verify recipe exits 0: {r.stderr[-2000:]}")
    accs = [float(a) for a in re.findall(r"Val Acc: ([0-9.]+)", r.stdout)]
    require(len(accs) == 2 and accs[-1] > 0.15
            and "[1-way partitioned]" in r.stdout,
            f"--partitioned reaches Val Acc > 0.15, got {accs}")
    require("Accuracy on test data" in r.stdout,
            "--partitioned prints the test line")
    out["partitioned"] = {"valid_acc": accs, "seconds": secs,
                          "test_line": r.stdout.strip().splitlines()[-1]}
    emit({"phase": "cli", "nvidia_smi": smi, **out})


def cached_path(kernels, results, dedups):
    """Phase 6: the cached host-feature path at papers100M class."""
    import torch

    from legion_tpu_torch.cache.feature_cache import (FeatureCache,
                                                      cache_dtype_for)
    from legion_tpu_torch.cache.pipeline import CachedTrainer
    from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
    from legion_tpu_torch.tools import pa_cell
    from legion_tpu_torch.train.cached_driver import run_cached_training
    from legion_tpu_torch.train.graphed import GraphPool
    lines = []

    def log(s):
        lines.append(s)
        print(s, file=sys.stderr, flush=True)

    data, gen_s, load_s = pa_cell.dataset(REPO, log)
    require(data.num_nodes == pa_cell.NODES and data.num_nodes >= 1 << 24,
            "the graph has ids past 2^24")
    cfg = pa_cell.config(epochs=2)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    t0 = time.perf_counter()
    res = run_cached_training(cfg, data, "cuda", log=log)
    run_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = res["history"]
    require(len(hist) == 2, "two epochs")
    for h in hist:
        e = h["epoch"]
        require(h["steps"] == pa_cell.STEPS,
                f"{pa_cell.STEPS} training steps in epoch {e}")
        require(all(math.isfinite(v) for v in h["losses"]),
                f"finite losses in epoch {e}")
        require(0.0 < h["cache_hit_rate"] < 1.0,
                f"hit rate inside (0, 1) in epoch {e}")
        require(h["host_gb"] > 0, f"misses staged from the host in epoch {e}")
    h = hist[-1]
    for name in ("sample_neighbors", "gathered_masked_mean",
                 "gathered_masked_mean_backward", "gather_rows",
                 "dedup_tail", "gathered_feature_mean", "act_dropout",
                 "act_dropout_backward"):
        require(launches[name] > 0, f"the cached path launched {name}")
    cost = {k: getattr(res["cost"], k) for k in (
        "feat_capacity", "topo_capacity", "alpha", "saved_feat_bytes")}

    # the driver's trainer rebuilt on its tables and trained state: its
    # stages captured against the same stages run eagerly
    caps = tuple(h["caps"])
    graph = DeviceGraph.from_host(data.indptr, data.indices, "cuda")
    dev = torch.device("cuda")
    cache = FeatureCache.build(
        data.features, res["cost"].feat_order, res["cost"].feat_capacity,
        miss_cap=h["miss_cap"],
        dtype=cache_dtype_for(cfg.model.dtype, data.feature_dim)[0],
        device=dev)
    state = res["state"]
    seeds = seed_rows(data.train_ids, pa_cell.STEPS, pa_cell.BATCH,
                      seed=21).numpy()
    labels = labels_of(data, seeds)
    captured = staged_vs_eager(
        kernels, "cached_path",
        CachedTrainer(cfg, state.model, caps, graph, cache,
                      pool=GraphPool(dev)),
        CachedTrainer(cfg, state.model, caps, graph, cache), state,
        lambda tr: tr.run_epoch(state, seeds, labels),
        ("cache_hit_rate", "host_gb", "staging_overflow", "edges"))
    del res, state, cache
    torch.cuda.empty_cache()

    # one batch at the path's caps: ids past 2^24, and the sampling
    # kernel on its hop-1 and hop-2 inputs
    seeds = torch.tensor(data.train_ids[:pa_cell.BATCH], device=dev)
    batch = sample_batch(graph, seeds,
                         torch.tensor(pa_cell.BATCH, dtype=torch.int32,
                                      device=dev),
                         torch.zeros_like(seeds), cfg.sampler.fanouts, caps,
                         dedup_last=True,
                         generator=torch.Generator(device=dev).manual_seed(3))
    big = int((batch.frontier >= 1 << 24).sum())
    require(big > 0, "the sampled frontier holds ids >= 2^24")
    hops = check_sampling_kernel(graph, hop_frontiers(batch, caps),
                                 cfg.sampler.fanouts, seed=4)
    results["sample_neighbors"]["cached_path_hops"] = hops
    # K2 on that batch's layer-1 block at the path's width (172 classes,
    # bf16): transformed activations and an upstream gradient from a seed
    blk1 = batch.blocks[0]
    gen = torch.Generator(device=dev).manual_seed(6)
    h_t = torch.randn((caps[1], pa_cell.CLASSES), generator=gen,
                      device=dev).to(torch.bfloat16)
    gd = torch.randn((blk1.nbr_mask.shape[0], pa_cell.CLASSES), generator=gen,
                     device=dev).to(torch.bfloat16)
    fwd, bwd = check_k2(h_t, blk1.nbr_pos, blk1.nbr_mask, gd, "mean")
    results["gathered_masked_mean"]["shapes"]["cached_pa_bf16"] = fwd
    results["gathered_masked_mean_backward"]["shapes"]["cached_pa_bf16"] = bwd
    del h_t, gd
    # the gathered feature mean on that batch's layer-0 block, over raw
    # bf16 rows 128 wide (the benchmark's papers100M width; this graph's
    # are 32) drawn from a seed
    blk0 = batch.blocks[-1]
    x0 = torch.randn((caps[2], FEATURE_MEAN_WIDTH), generator=gen,
                     device=dev).to(torch.bfloat16)
    fmean = check_feature_mean(x0, blk0.nbr_pos, blk0.nbr_mask)
    # and on the rows the path itself hands it for that batch: the
    # graph's own features, at their width, in the cache's dtype
    nf = int(batch.num_frontier)
    x0 = torch.zeros((caps[2], data.feature_dim),
                     dtype=cache_dtype_for(cfg.model.dtype,
                                           data.feature_dim)[0], device=dev)
    x0[:nf] = torch.as_tensor(data.features[
        batch.frontier[:nf].cpu().numpy()]).to(dev, x0.dtype)
    fmean["path_rows"] = check_feature_mean_rows(
        x0, blk0.nbr_pos, blk0.nbr_mask, getattr(torch, cfg.model.dtype))
    results["gathered_feature_mean"].update(
        {k: fmean[k] for k in KERNEL_KEYS}, cached_pa_bf16=fmean)
    del x0
    cached_dedups = dedup_cases("cached", graph, hop_frontiers(batch, caps),
                                [batch.num_seeds, batch.blocks[0].num_src],
                                cfg.sampler.fanouts, caps, seed=8)
    results["dedup_tail"]["cached_path_hops"] = cached_dedups
    dedups += cached_dedups
    emit({"phase": "cached_path",
          "graph": {"nodes": data.num_nodes, "edges": data.num_edges,
                    "features": data.feature_dim,
                    "num_nodes_cut": f"{pa_cell.NODES} of "
                                     f"{pa_cell.FULL_NODES}",
                    "gen_s": gen_s, "load_s": load_s},
          "budget_bytes": pa_cell.BUDGET, "driver_log": lines,
          "run_s": run_s, "presample_s": h["presample_s"],
          "caps": list(caps), "miss_cap": h["miss_cap"],
          # epoch 0 carries the warm-up; epoch 1 is the steady state
          "epochs": [{"epoch": r["epoch"], "losses": r["losses"],
                      "hit_rate": r["cache_hit_rate"], "host_gb": r["host_gb"],
                      "staging_overflow": r["staging_overflow"],
                      "ms_per_step": 1e3 * r["seconds"] / r["steps"],
                      "stage_s": r["stage_s"],
                      "edges_per_s": r["edges_per_s"], "valid_acc": r["valid"]}
                     for r in hist],
          "steady_ms_per_step": 1e3 * h["seconds"] / h["steps"],
          "steady_edges_per_s": h["edges_per_s"], "launches": launches,
          "frontier_ids_past_2_24": big,
          "num_frontier": int(batch.num_frontier),
          "sample_neighbors_hops": hops, "k2": {"forward": fwd,
                                                "backward": bwd},
          "gathered_feature_mean": fmean,
          "peak_mem_gb": peak,
          "cost_model": cost, "captured": captured})
    return launches, {
        "losses": [r["losses"] for r in hist], "launches": launches,
        "epochs": [{k: r[k] for k in ("cache_hit_rate", "staging_overflow",
                                      "host_gb", "seconds", "steps")}
                   for r in hist]}


def dedup_case(name, frontier_prev, num_prev, nbrs, cap_new):
    """One hop's dedup on the card, its tail both ways on the same sorted
    tensors: the kernel (``ops/dedup.py::dedup_tail``) against its plain
    version, bitwise (frontier, count, positions), and the whole hop
    (``grow_frontier``: the sort, then the kernel) equal to them; neither
    may make the host wait for the device. Every valid slot must decode
    to the neighbor id sampled there. Timed: the kernel warm (``ms``) and
    with the L2 flushed (``cold_ms``), the plain version, ``torch.cummax``
    over an int64 row of the hop's length (the plain version's
    leader broadcast, the scan the kernel replaces; ``library_ms``) and
    the whole hop; the bound is the kernel's bytes
    (``dedup_traffic``) at the memory peak."""
    import torch

    from legion_tpu_torch.ops.dedup import (SENTINEL, dedup_tail,
                                            dedup_tail_plain, dedup_traffic)
    from legion_tpu_torch.sampling.sampler import grow_frontier
    cat = torch.cat([torch.where(frontier_prev >= 0, frontier_prev, SENTINEL),
                     torch.where(nbrs >= 0, nbrs, SENTINEL).reshape(-1)])
    s, sorig = torch.sort(cat, stable=True)
    args = (s, sorig, frontier_prev, num_prev.to(torch.int32), cap_new)
    torch.cuda.set_sync_debug_mode("error")
    try:
        n0 = dedup_tail.launches
        k = dedup_tail(*args)
        p = dedup_tail_plain(*args)
        hop = grow_frontier(frontier_prev, num_prev, nbrs, cap_new)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(dedup_tail.launches == n0 + 2,
            f"dedup {name}: the tail and the hop each launch the kernel once")
    for what, a, b in zip(("frontier", "count", "positions"), k, p):
        require(torch.equal(a, b), f"dedup {name}: the kernel's {what} are "
                "bitwise the plain version's")
    require(torch.equal(hop[0], k[0]) and torch.equal(hop[1], k[1])
            and torch.equal(hop[2].nbr_pos.reshape(-1), k[2]),
            f"dedup {name}: grow_frontier gives the tail's results")
    mask = nbrs >= 0
    require(int(k[1]) <= cap_new, f"dedup {name}: {int(k[1])} ids within "
            f"the cap {cap_new}")
    require(torch.equal(k[0][hop[2].nbr_pos.long()][mask], nbrs[mask]),
            f"dedup {name}: the block decodes to the sampled ids")
    total, prev_cap = s.shape[0], frontier_prev.shape[0]
    idx = torch.arange(total, device=s.device)
    num_new = int(k[1])
    del k, p, hop
    return {"case": name, "shape": [*nbrs.shape], "prev_cap": prev_cap,
            "cap_new": cap_new, "total": total,
            "valid_slots": int(mask.sum()), "num_prev": int(num_prev),
            "num_new": num_new, "max_abs_err": 0.0,
            **bound(dedup_traffic(total, prev_cap, cap_new), 0),
            "ms": time_ms(lambda: dedup_tail(*args)),
            "cold_ms": time_ms(lambda: dedup_tail(*args), cold=True),
            "plain_ms": time_ms(lambda: dedup_tail_plain(*args)),
            "library_ms": time_ms(lambda: torch.cummax(idx, 0)),
            "library_call": "torch.cummax of an int64 row of the hop's "
                            "length",
            "hop_ms": time_ms(lambda: grow_frontier(frontier_prev, num_prev,
                                                    nbrs, cap_new))}


def dedup_cases(prefix, graph, frontiers, nums, fanouts, caps, seed):
    """``dedup_case`` for each hop of a batch: the hop's frontier and valid
    count as the sampler left them, and neighbors sampled from it."""
    import torch

    from legion_tpu_torch.sampling.sampler import sample_neighbors
    gen = torch.Generator(device=graph.indptr.device).manual_seed(seed)
    out = []
    for k, (fr, num) in enumerate(zip(frontiers, nums)):
        u = torch.rand((fr.shape[0], fanouts[k]), generator=gen,
                       device=fr.device, dtype=torch.float32)
        out.append(dedup_case(f"{prefix}_hop{k + 1}", fr, num,
                              sample_neighbors(graph, fr, u), caps[k + 1]))
    return out


def hybrid_learns(data):
    """The hybrid driver (host CSR, hot sub-CSR on the card, host features)
    on the planted-label graph: SAGE-256 float32, batch 1024, 2 epochs, a
    budget of a quarter of the feature rows plus a quarter of the
    adjacency, which the cost model splits."""
    from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                         ModelConfig, SamplerConfig,
                                         TrainConfig)
    from legion_tpu_torch.train.hybrid_driver import run_hybrid_training
    budget = (data.num_nodes // 4 * (data.feature_dim * 4 + 8)
              + data.num_edges)                     # 4 B an edge, a quarter
    cfg = Config(dataset=DatasetConfig(num_classes=CLASSES,
                                       feature_placement="host",
                                       topology_placement="host"),
                 sampler=SamplerConfig(fanouts=(25, 10), batch_size=1024,
                                       dedup_last=True),
                 model=ModelConfig(arch="sage", hidden_dim=256,
                                   num_layers=2),
                 train=TrainConfig(epochs=2),
                 cache=CacheConfig(enabled=True, budget_bytes=budget))
    res = run_hybrid_training(cfg, data, "cuda", log=stderr_log)
    hist, cost = res["history"], res["cost"]
    h = hist[-1]
    require(h["valid"] > 0.15, f"hybrid validation accuracy {h['valid']} "
            "> 0.15")
    require(0.0 < cost.alpha < 1.0 and cost.feat_capacity > 0
            and cost.topo_capacity > 0, "the cost model feeds both caches")
    for r in hist:
        require(0.0 < r["topo_hot_fraction"] < 1.0
                and 0.0 < r["feat_hit_rate"] < 1.0,
                "hot fraction and hit rate inside (0, 1)")
        require(r["fetches"] == 2 * r["steps"] + 1,
                "two reads a step plus one an epoch")
    return {"budget_bytes": budget, "alpha": cost.alpha,
            "feat_capacity": cost.feat_capacity,
            "topo_capacity": cost.topo_capacity,
            "valid_acc": [r["valid"] for r in hist],
            "test_acc": res["test_acc"],
            "mean_loss": [sum(r["losses"]) / len(r["losses"]) for r in hist],
            "feat_hit_rate": [r["feat_hit_rate"] for r in hist],
            "topo_hot_fraction": [r["topo_hot_fraction"] for r in hist],
            "staging_overflow": [r["staging_overflow"] for r in hist],
            "caps": h["caps"], "miss_cap": h["miss_cap"]}


def require_hybrid_run(res, hops):
    """A hybrid driver's run of two epochs of ``pa_cell.STEPS`` steps:
    the cost model feeds both caches, and every epoch has finite losses,
    hot fraction and hit rate inside (0, 1), ``hops`` reads a step plus
    one, no cap overflow and bytes on both host legs."""
    from legion_tpu_torch.tools import pa_cell
    hist, cost = res["history"], res["cost"]
    require(len(hist) == 2, "two epochs")
    require(0.0 < cost.alpha < 1.0 and cost.feat_capacity > 0
            and cost.topo_capacity > 0,
            f"the cost model feeds both caches (alpha {cost.alpha}, "
            f"{cost.feat_capacity} feature rows, {cost.topo_capacity} "
            "adjacency rows)")
    for h in hist:
        e = h["epoch"]
        require(h["steps"] == pa_cell.STEPS,
                f"{pa_cell.STEPS} training steps in epoch {e}")
        require(all(math.isfinite(v) for v in h["losses"]),
                f"finite losses in epoch {e}")
        require(0.0 < h["topo_hot_fraction"] < 1.0,
                f"hot fraction inside (0, 1) in epoch {e}")
        require(0.0 < h["feat_hit_rate"] < 1.0,
                f"hit rate inside (0, 1) in epoch {e}")
        require(h["fetches"] == hops * h["steps"] + 1,
                f"{hops} reads a step plus one in epoch {e}, got "
                f"{h['fetches']}")
        require(h["cap_overflow"] == 0, f"no cap overflow in epoch {e}")
        require(h["host_topo_gb"] > 0 and h["host_feat_gb"] > 0,
                f"both host legs moved bytes in epoch {e}")


def hybrid_launches(hist, data, hops):
    """The launches of a hybrid driver's run. Training: ``hops`` sampling
    launches a step (hops 1.. of this batch, hop 0 of the next) plus the
    epoch's prologue, K2 forward and backward once a step, K3 for the
    cached and for the staged rows, the dedup's tail at every hop, the
    gathered feature mean once a step (layer 0 widens 32 -> 256), the
    activation-dropout forward and backward once a train step. The eval
    passes (valid after each epoch, test) take batches of
    ``pa_cell.BATCH`` seeds and launch no backward and no dropout."""
    from legion_tpu_torch.tools import pa_cell
    train_steps = sum(h["steps"] for h in hist)
    eval_steps = [(len(ids) - 1) // pa_cell.BATCH + 1 for ids in (
        [data.valid_ids] * len(hist) + [data.test_ids])]
    steps = train_steps + sum(eval_steps)
    return {"sample_neighbors": hops * steps + len(hist) + len(eval_steps),
            "gathered_masked_mean": steps,
            "gathered_masked_mean_backward": train_steps,
            "gather_rows": 2 * steps,
            "identity_masked_mean": 0, "grouped_masked_sum": 0,
            "dedup_tail": hops * steps, "gathered_feature_mean": steps,
            "act_dropout": train_steps, "act_dropout_backward": train_steps}


def require_hybrid_launches(launches, hist, data, hops, what):
    want = hybrid_launches(hist, data, hops)
    require(launches == want, f"{what} launched {launches}, want {want}")


def hybrid_batch_checks(res, data, cfg, results, hops_key, k2_key, k3_key):
    """One more batch of a hybrid driver's run through its per-hop
    sampler (ids past 2^24), and every kernel of the path held against
    its plain version on that batch's tensors: the sampling kernel on the
    sub-CSR with each hop's ``where(hit, row, -1)`` frontier, K2 on the
    layer-1 block, K3 on the cache merge's two gathers. The records go
    into ``results`` under the given keys and into the returned record.
    Returns (the batch, the record)."""
    import collections

    import torch

    from legion_tpu_torch.tools import pa_cell
    tr, h = res["trainer"], res["history"][-1]
    # one more batch through the per-hop sampler: ids past 2^24
    dev = torch.device("cuda")
    seeds = torch.tensor(data.train_ids[:pa_cell.BATCH], device=dev)
    batch = res["sampler"].sample_batch(
        seeds, pa_cell.BATCH, torch.zeros_like(seeds),
        generator=torch.Generator(device=dev).manual_seed(3))
    big = int((batch.frontier >= 1 << 24).sum())
    require(big > 0, "the sampled frontier holds ids >= 2^24")
    caps, topo, fcache = tuple(h["caps"]), tr.topo, tr.fcache
    # the sampling kernel as ``TopoCache.sample_hot`` launches it: the
    # sub-CSR, and each hop's frontier as sub-rows with -1 for a miss
    sub_frontiers, hot_share = [], []
    for fr in hop_frontiers(batch, caps):
        hit, row = topo.lookup(fr)
        sub_frontiers.append(torch.where(hit, row, -1))
        hot_share.append(int(hit.sum()) / max(int((fr >= 0).sum()), 1))
    require(all(0.0 < x < 1.0 for x in hot_share),
            f"each hop's frontier holds hot and cold ids ({hot_share})")
    SubCsr = collections.namedtuple("SubCsr", "indptr indices")
    sub_hops = check_sampling_kernel(
        SubCsr(topo.sub_indptr, topo.sub_indices), sub_frontiers,
        cfg.sampler.fanouts, seed=9)
    for rec, share in zip(sub_hops, hot_share):
        rec["hot_share"] = share
    results["sample_neighbors"][hops_key] = sub_hops
    # K2 on that batch's layer-1 block at the path's width (172 classes,
    # bf16): transformed activations and an upstream gradient from a seed
    blk1 = batch.blocks[0]
    gen = torch.Generator(device=dev).manual_seed(10)
    h_t = torch.randn((caps[1], pa_cell.CLASSES), generator=gen,
                      device=dev).to(torch.bfloat16)
    gd = torch.randn((blk1.nbr_mask.shape[0], pa_cell.CLASSES), generator=gen,
                     device=dev).to(torch.bfloat16)
    k2_fwd, k2_bwd = check_k2(h_t, blk1.nbr_pos, blk1.nbr_mask, gd, "mean")
    results["gathered_masked_mean"]["shapes"][k2_key] = k2_fwd
    results["gathered_masked_mean_backward"]["shapes"][k2_key] = k2_bwd
    del h_t, gd
    # K3 on the cache merge's inputs (``FeatureCache.combine_rows``): the
    # cached rows by slot and the staged miss rows by miss rank, -1 for
    # the rest; the merged matrix then equals the host rows, with zeros
    # for padding and for the misses past the staging capacity
    plan = fcache.plan(batch.frontier)
    n_miss = min(int(plan.num_miss), fcache.miss_cap)
    staged = fcache.stage_to(dev, plan.miss_ids[:n_miss].cpu().numpy())
    staged[n_miss:] = 0                 # rows no plan reads; set for the timing
    miss = (batch.frontier >= 0) & ~plan.hit
    k3_cached, rec_cached = check_gather_rows(
        fcache.rows, torch.where(plan.hit, plan.slot, -1))
    k3_missed, rec_staged = check_gather_rows(
        staged, torch.where(miss & (plan.miss_idx < staged.shape[0]),
                            plan.miss_idx, -1))
    merged = fcache.combine(plan, staged, batch.frontier)
    require(torch.equal(merged, torch.where(plan.hit[:, None], k3_cached,
                                            k3_missed)),
            "the cache merge is the two gathers joined by the hit mask")
    seen = plan.hit | (miss & (plan.miss_idx < fcache.miss_cap))
    want = torch.zeros_like(merged)
    want[seen] = fcache.stage(
        batch.frontier[seen].cpu().numpy()).to(dev)
    require(torch.equal(merged, want),
            "the merged rows are the host's feature rows")
    results["gather_rows"][k3_key] = {"cached": rec_cached,
                                      "staged": rec_staged}
    del merged, want, k3_cached, k3_missed, staged
    return batch, {"frontier_ids_past_2_24": big,
            "num_frontier": int(batch.num_frontier),
            "sampler_hot_fraction": res["sampler"].hot_fraction(),
            "kernel_checks": {
                "sample_neighbors_hops": sub_hops,
                "k2": {"forward": k2_fwd, "backward": k2_bwd},
                "gather_rows": {"cached": rec_cached, "staged": rec_staged,
                                "staged_rows": n_miss,
                                "overflowed": int(plan.overflow())}}}


def hybrid_epochs(hist):
    """A hybrid driver's epoch records as the phases print them."""
    return [{"epoch": r["epoch"], "losses": r["losses"],
             "ms_per_step": 1e3 * r["seconds"] / r["steps"],
             "edges_per_s": r["edges_per_s"],
             "feat_hit_rate": r["feat_hit_rate"],
             "topo_hot_fraction": r["topo_hot_fraction"],
             "host_feat_gb": r["host_feat_gb"],
             "host_topo_gb": r["host_topo_gb"],
             "host_topo_copied_gb": r["host_topo_copied_gb"],
             "fetches": r["fetches"],
             "staging_overflow": r["staging_overflow"],
             "cap_overflow": r["cap_overflow"], "stage_s": r["stage_s"],
             "host_sample_s": r["host_sample_s"], "fetch_s": r["fetch_s"],
             "valid_acc": r["valid"]} for r in hist]


def hybrid_path(kernels, results):
    """Phase 8: the host-topology path at uk-union class. Returns the
    launch counts of the driver's whole run. After the run every kernel
    of the path is held against its plain version on one more batch's
    tensors: the sampling kernel on the sub-CSR with each hop's
    ``where(hit, row, -1)`` frontier, K2 on the layer-1 block, K3 on the
    cache merge's two gathers."""
    import torch

    from legion_tpu_torch.cache.hybrid import HybridTrainer
    from legion_tpu_torch.tools import hybrid_cell, pa_cell
    from legion_tpu_torch.train.hybrid_driver import run_hybrid_training
    lines = []

    def log(s):
        lines.append(s)
        print(s, file=sys.stderr, flush=True)

    data, gen_s, load_s = hybrid_cell.dataset(REPO, log)
    cfg = hybrid_cell.config(epochs=2)
    hops = len(cfg.sampler.fanouts)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_launches(kernels)
    t0 = time.perf_counter()
    res = run_hybrid_training(cfg, data, "cuda", log=log)
    run_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist, cost, tr = res["history"], res["cost"], res["trainer"]
    require_hybrid_run(res, hops)
    require_hybrid_launches(launches, hist, data, hops, "the hybrid path")
    # the driver's trainer (its stages captured) against its twin on the
    # same tables without a pool
    state = res["state"]
    seeds = seed_rows(data.train_ids, pa_cell.STEPS, pa_cell.BATCH,
                      seed=22).numpy()
    labels = labels_of(data, seeds)
    require(tr.pool is not None and tr.pool.captures,
            "the hybrid driver's trainer captures")
    captured = staged_vs_eager(
        kernels, "hybrid_path", tr,
        HybridTrainer(cfg, tr.model, tr.caps, tr.topo, tr.host_indptr,
                      tr.host_indices, tr.fcache), state,
        lambda t: t.run_epoch(state, seeds, labels, 2), HYBRID_FIGURES)
    require(captured["host_meters"]["fetches"] == hops * pa_cell.STEPS + 1,
            f"{hops} reads a step plus one: {captured['host_meters']}")
    del state
    _, checks = hybrid_batch_checks(res, data, cfg, results,
                                    "hybrid_path_hops", "hybrid_uk_bf16",
                                    "hybrid_merge")
    h = hist[-1]
    emit({"phase": "hybrid_path",
          "graph": {"nodes": data.num_nodes, "edges": data.num_edges,
                    "features": data.feature_dim,
                    "num_nodes_cut": f"{pa_cell.NODES} of "
                                     f"{hybrid_cell.FULL_NODES}",
                    "gen_s": gen_s, "load_s": load_s},
          "budget_bytes": hybrid_cell.BUDGET, "driver_log": lines,
          "run_s": run_s, "presample_s": h["presample_s"],
          "cost_model": {"alpha": cost.alpha,
                         "feat_capacity": cost.feat_capacity,
                         "topo_capacity": cost.topo_capacity,
                         "saved_feat_bytes": cost.saved_feat_bytes,
                         "saved_topo_bytes": cost.saved_topo_bytes},
          "sub_csr_bytes": tr.topo.device_bytes(),
          "sub_csr_edges": int(tr.topo.sub_indptr[-1]),
          "feature_cache_bytes": tr.fcache.rows.numel()
          * tr.fcache.rows.element_size(),
          "caps": h["caps"], "miss_cap": h["miss_cap"],
          # epoch 0 carries the warm-up; epoch 1 is the steady state
          "epochs": hybrid_epochs(hist),
          "steady_ms_per_step": 1e3 * h["seconds"] / h["steps"],
          "steady_edges_per_s": h["edges_per_s"],
          "test_acc": res["test_acc"], "launches": launches, **checks,
          "peak_mem_gb": peak, "mem_before_gb": mem0 / 2 ** 30,
          "captured": captured})
    return launches, {
        "losses": [r["losses"] for r in hist], "launches": launches,
        "epochs": [{k: r[k] for k in ("topo_hot_fraction", "feat_hit_rate",
                                      "fetches", "staging_overflow",
                                      "host_topo_gb", "seconds", "steps")}
                   for r in hist]}


def bigcsr(kernels, results, smi, ref):
    """Phase "bigcsr": phase 8's cell with every real adjacency run past
    edge 2^31 (``tools/scale.py::holed_twins``: a leading node 0 owns a
    run of 2^31 + 2^20 edges that is a hole in the indices file, every
    real node moves up by one), beside its twin, where node 0 has degree
    0. The hybrid driver (its stages captured) and the striped hybrid
    driver at one NCCL rank each run two epochs on the big CSR with
    phase 8's checks (``ref``: its launches and losses); a steady epoch
    is traced, each kernel as bookkept. The seams are held against the
    twin: the host presample's counts, ``TopoCache.build``'s and
    ``StripedTopoCache.build``'s sub-CSRs for the same hot ids and the C++
    sampler's draws for one batch's cold ids, bitwise. K2, K3 and the
    sampling kernel are held against their plain versions on one more
    batch of the run. Returns the hybrid driver's launch counts."""
    import torch
    import torch.distributed as dist

    from legion_tpu_torch import runtime
    from legion_tpu_torch.cache.striped import StripedTopoCache
    from legion_tpu_torch.cache.topo_cache import TopoCache
    from legion_tpu_torch.parallel import mesh
    from legion_tpu_torch.tools import hybrid_cell, pa_cell, scale
    from legion_tpu_torch.train.hybrid_driver import (presample_hotness_host,
                                                      run_hybrid_training)
    t_phase = time.perf_counter()
    lines = []
    log = _phase_log(lines)
    data, _, _ = hybrid_cell.dataset(REPO, log)
    work = os.path.join(REPO, ".bench_cache", "bigcsr")
    shutil.rmtree(work, ignore_errors=True)
    try:
        big, twin, facts = scale.holed_twins(data, work, write_hole=True)
        del data
        start = facts["smallest_real_run_start"]
        require(start > 2 ** 31,
                f"every real run starts past edge 2^31 (first at {start})")
        cfg = hybrid_cell.config(epochs=2)
        fanouts, hops = tuple(cfg.sampler.fanouts), len(cfg.sampler.fanouts)

        # the host presample on both CSRs: the same counts past node 0
        pre_seeds = seed_rows(big.train_ids, cfg.cache.presample_steps,
                              pa_cell.BATCH, seed=31).numpy()
        t0 = time.perf_counter()
        pre_big = presample_hotness_host(big.indptr, big.indices, pre_seeds,
                                         fanouts, big.num_nodes, 0)
        presample_s = time.perf_counter() - t0
        pre_twin = presample_hotness_host(twin.indptr, twin.indices,
                                          pre_seeds, fanouts, twin.num_nodes,
                                          0)
        for name, a, b in zip(("node_hot", "edge_hot", "max_per_hop"),
                              pre_big, pre_twin):
            lo = 1 if name != "max_per_hop" else 0
            require(torch.equal(torch.from_numpy(a[lo:]),
                                torch.from_numpy(b[lo:])),
                    f"the host presample's {name} equals the twin's")

        # the hybrid driver on the big CSR
        reset_launches(kernels)
        t0 = time.perf_counter()
        res = run_hybrid_training(cfg, big, "cuda", log=log)
        run_s = time.perf_counter() - t0
        launches = read_launches(kernels)
        hist, cost, tr = res["history"], res["cost"], res["trainer"]
        require_hybrid_run(res, hops)
        require_hybrid_launches(launches, hist, big, hops,
                                "the hybrid driver on the big CSR")
        require(tr.pool is not None and tr.pool.captures,
                "the hybrid driver's trainer captures")
        scale.shares(tr.host_indices, big.indices, "the host CSR's indices")
        scale.shares(tr.fcache.host_features, big.features,
                     "the feature cache's host table")
        # a steady epoch of the captured stages, traced
        state = res["state"]
        seeds = seed_rows(big.train_ids, pa_cell.STEPS, pa_cell.BATCH,
                          seed=22).numpy()
        labels = labels_of(big, seeds)
        traced, counted, busy_ms, wall_ms, _ = staged_trace(
            kernels, lambda: tr.run_epoch(state, seeds, labels, 2))
        n = pa_cell.STEPS
        want = {"sample_neighbors": hops * n + 1, "gathered_masked_mean": n,
                "gathered_masked_mean_backward": n, "gather_rows": 2 * n,
                "identity_masked_mean": 0, "grouped_masked_sum": 0,
                "dedup_tail": hops * n, "gathered_feature_mean": n,
                "act_dropout": n, "act_dropout_backward": n}
        require(traced == counted == want,
                f"a steady epoch traced {traced} and counted {counted} "
                f"launches, want {want}")
        del state

        # TopoCache.build on the twin for the same hot ids
        topo_twin = TopoCache.build(twin.indptr, twin.indices,
                                    cost.topo_order, cost.topo_capacity,
                                    "cuda")
        for name in ("hot_ids", "sub_indptr", "sub_indices"):
            require(torch.equal(getattr(tr.topo, name),
                                getattr(topo_twin, name)),
                    f"TopoCache.build's {name} equals the twin's")
        hot_edges = int(tr.topo.sub_indptr[-1])
        del topo_twin

        # the kernels on one more batch, and the C++ sampler on its cold ids
        batch, checks = hybrid_batch_checks(res, big, cfg, results,
                                            "bigcsr_hops", "bigcsr_bf16",
                                            "bigcsr_merge")
        cold = {}
        for k, fr in enumerate(hop_frontiers(batch, tr.caps)):
            hit, _ = tr.topo.lookup(fr)
            ids = fr[(fr >= 0) & ~hit].cpu().numpy()
            a = runtime.sample_neighbors(big.indptr, big.indices, ids,
                                         fanouts[k], seed=77 + k)
            b = runtime.sample_neighbors(twin.indptr, twin.indices, ids,
                                         fanouts[k], seed=77 + k)
            require(torch.equal(torch.from_numpy(a), torch.from_numpy(b))
                    and bool((a >= 0).any()),
                    f"the C++ sampler's draws for hop {k}'s cold ids equal "
                    "the twin's")
            cold[f"hop{k}"] = {"cold_ids": len(ids),
                               "valid_draws": int((a >= 0).sum())}
        del batch

        # the striped hybrid driver at one NCCL rank on the big CSR
        with tempfile.TemporaryDirectory() as tmp:
            mesh.init_process(0, 1, os.path.join(tmp, "init"), "cuda")
            try:
                backend = dist.get_backend()
                reset_launches(kernels)
                t0 = time.perf_counter()
                sres = run_hybrid_training(cfg, big, "cuda",
                                           mesh=mesh.make_mesh(1), log=log)
                striped_s = time.perf_counter() - t0
                s_launches = read_launches(kernels)
                st = sres["trainer"]
                stripe_twin = StripedTopoCache.build(
                    twin.indptr, twin.indices, sres["cost"].topo_order,
                    sres["cost"].topo_capacity, st.mesh, "cuda")
                for name in ("hot_ids", "sub_indptr", "sub_indices"):
                    require(torch.equal(getattr(st.topo, name),
                                        getattr(stripe_twin, name)),
                            f"StripedTopoCache.build's {name} equals the "
                            "twin's")
                scale.shares(st.host_indices, big.indices,
                             "the striped trainer's host indices")
                shist = sres["history"]
                del sres, st, stripe_twin
            finally:
                dist.destroy_process_group()
        require(backend == "nccl", f"the one-rank group runs NCCL, not "
                f"{backend}")
        for h in shist:
            require(h["exchange_overflow"] == 0 and 0.0 < h[
                "topo_hot_fraction"] < 1.0,
                f"striped epoch {h['epoch']}: hot fraction in (0, 1), no "
                "exchange overflow")
        worst = loss_drift([h["losses"] for h in shist],
                           [h["losses"] for h in hist],
                           "the striped hybrid driver against the hybrid "
                           "driver on the big CSR")
        s_want = dict(launches, gather_rows=launches["gather_rows"]
                      + launches["gathered_masked_mean"])
        require(s_launches == s_want,
                f"striped launches {s_launches} (want {s_want})")
        h = hist[-1]
        record = {
            "phase": "bigcsr", "nvidia_smi": smi,
            "graph": {"nodes": big.num_nodes, "edges": big.num_edges,
                      "real_edges": twin.num_edges,
                      "hole_edges": facts["hole_edges"]},
            "file": facts, "gen_s": facts["seconds"],
            "smallest_real_run_start": start,
            "seams": {"presample_equal_past_node_0": True,
                      "node_0_counts": [int(pre_big[0][0]),
                                        int(pre_big[1][0]),
                                        int(pre_twin[0][0]),
                                        int(pre_twin[1][0])],
                      "presample_s": presample_s,
                      "topo_cache_equal": True, "hot_edges": hot_edges,
                      "cold_draws_equal": cold,
                      "striped_topo_equal": True},
            "driver_log": lines, "run_s": run_s,
            "cost_model": {"alpha": cost.alpha,
                           "feat_capacity": cost.feat_capacity,
                           "topo_capacity": cost.topo_capacity},
            "caps": h["caps"], "miss_cap": h["miss_cap"],
            "epochs": hybrid_epochs(hist),
            "phase8_ms_per_step": [1e3 * r["seconds"] / r["steps"]
                                   for r in ref["epochs"]],
            "launches": launches,
            "traced_epoch": {"traced": traced, "counted": counted,
                             "busy_ms": busy_ms, "wall_ms": wall_ms},
            **checks,
            "striped": {"backend": backend, "world": 1, "run_s": striped_s,
                        "launches": s_launches, "worst_rel_diff": worst,
                        "epochs": [{"epoch": r["epoch"],
                                    "losses": r["losses"],
                                    "topo_hot_fraction":
                                        r["topo_hot_fraction"],
                                    "ms_per_step": 1e3 * r["seconds"]
                                    / r["steps"]} for r in shist]}}
        del res, tr, hist
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    record["phase_s"] = time.perf_counter() - t_phase
    emit(record)
    return launches


# Per-step losses of a striped driver against its twin on the same seeds:
# step 0 bitwise (the forward kernels are deterministic), later steps
# within a relative distance, since K2 backward adds with float atomics
# and two runs differ in rounding. In bf16 at full width that drift
# reached 0.93-3.1e-5 over 20-24 steps on an H100 80GB HBM3 (700 W), and
# mesh_dp's steps 1-4 reached 1.18e-5, so bf16 runs are held to 1e-4;
# float32 runs drifted 1.6e-7 and are held to 1e-5.
STRIPED_LOSS_RTOL = {"bfloat16": 1e-4, "float32": 1e-5}


def loss_drift(got, want, what, dtype="bfloat16"):
    """The worst relative distance of ``got``'s per-step losses from
    ``want``'s (lists of epochs' lists), after checking step 0 bitwise and
    every step within ``STRIPED_LOSS_RTOL[dtype]``."""
    flat_g = [v for ep in got for v in ep]
    flat_w = [v for ep in want for v in ep]
    require(len(flat_g) == len(flat_w) and flat_g[0] == flat_w[0],
            f"{what}: as many steps, step 0 bitwise ({flat_g[:1]} against "
            f"{flat_w[:1]})")
    worst = max(abs(a - b) / abs(b) for a, b in zip(flat_g, flat_w))
    rtol = STRIPED_LOSS_RTOL[dtype]
    require(worst <= rtol,
            f"{what}: losses within {rtol} relative, worst {worst}")
    return worst


def check_exchange(table, req, group, cap=None):
    """K3 on the exact exchange's two gathers of the (M,) requests ``req``
    over ``group``: the serve (this rank's stripe by the slots its peers
    asked for) and the reassembly (the responses by owner x cap +
    position), each bitwise its plain version and timed; together they
    are ``sharded_row_fetch_stats``'s rows."""
    import torch
    import torch.distributed as dist

    from legion_tpu_torch.parallel.feature_exchange import (
        owner_cap, response_index, route_by_owner, sharded_row_fetch_stats)
    from legion_tpu_torch.utils import comm
    k = dist.get_world_size(group)
    cap = cap if cap is not None else owner_cap(req.shape[0], k)
    send, pos, in_cap, _ = route_by_owner(req, k, cap)
    recv = comm.all_to_all(send.reshape(-1), group)
    slot = torch.where(recv >= 0, recv // k, -1).to(torch.int32)
    rows, serve = check_gather_rows(table, slot)
    resp = comm.all_to_all(rows, group)
    out, reassembly = check_gather_rows(
        resp, response_index(req, pos, in_cap, k, cap))
    want, _ = sharded_row_fetch_stats(table, req, group, cap)
    require(torch.equal(out, want),
            "the exchange's two gathers give its rows")
    return {"owner_cap": cap, "requests": int((req >= 0).sum()),
            "serve": serve, "reassembly": reassembly}


def mesh_sharded(kernels, data, dp_losses, dp_ms):
    """Part of phase "mesh_striped", run on phase 4's graph after
    ``mesh_dp``: ``MeshTrainer`` with ``feature_placement="hbm_sharded"``
    at world size 1 through NCCL (its one-rank cache group holds the
    whole table and each step fetches the frontier's rows through the
    exchange) with ``mesh_dp``'s configuration, two epochs. Step 0's loss
    bitwise ``mesh_dp``'s, the rest within ``STRIPED_LOSS_RTOL``; exact
    launches (K3 twice a step: the exchange's serve and reassembly); the
    epoch's collectives (two all-to-alls a step of the closed form's
    bytes, the gradient's all-reduce); then K3's two gathers of the
    exchange held against their plain versions on one batch (the
    sampling kernel, K1 and K2 see ``mesh_dp``'s tensors there)."""
    import torch
    import torch.distributed as dist

    from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                         ParallelConfig, SamplerConfig,
                                         TrainConfig)
    from legion_tpu_torch.parallel import mesh
    from legion_tpu_torch.parallel.trainer import MeshTrainer
    from legion_tpu_torch.sampling.sampler import sample_batch
    from legion_tpu_torch.utils import comm
    cfg = Config(
        dataset=DatasetConfig(num_classes=CLASSES,
                              feature_placement="hbm_sharded"),
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=8000,
                              observed_cap_slack=1.03, probe_caps=False),
        model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype="bfloat16"),
        train=TrainConfig(learning_rate=0.003),
        parallel=ParallelConfig(num_devices=1))
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_process(0, 1, os.path.join(tmp, "init"), "cuda")
        try:
            tr = MeshTrainer(cfg, data, device="cuda")
            reset_launches(kernels)
            comm.reset_counts()
            rec = tr.train_one_epoch(0)
            launches = read_launches(kernels)
            counts, calls = comm.read_counts(), comm.read_calls()
            steady = tr.train_one_epoch(1)
            ids = tr.shards_train[0][:8000].copy()
            batch = sample_batch(
                tr.graph, torch.from_numpy(ids).to(dev),
                torch.tensor(len(ids), dtype=torch.int32, device=dev),
                torch.from_numpy(data.labels[ids]).to(dev),
                cfg.sampler.fanouts, tr.caps,
                dedup_last=cfg.sampler.dedup_last,
                generator=torch.Generator(device=dev).manual_seed(6))
            k3 = check_exchange(tr.features, batch.frontier, tr.mesh.group)
            backend = dist.get_backend()
            a2a_step = comm.exact_exchange_bytes(
                tr.caps[-1], 1, tr.features.shape[1])["all_to_all"]
            captured = mesh_trainer_captured(
                kernels, "mesh_striped hbm_sharded", tr, data,
                ({"all_reduce": 1, "all_to_all": 2},
                 {"all_reduce": comm.param_bytes(tr.model),
                  "all_to_all": a2a_step}))
        finally:
            dist.destroy_process_group()
    t = rec["steps"]
    require(backend == "nccl", f"the one-rank group runs NCCL, not {backend}")
    require(tr.features.shape[0] == data.num_nodes,
            "a one-rank cache group's stripe is the whole table")
    worst = loss_drift([rec["losses"]], [dp_losses],
                       "hbm_sharded MeshTrainer against mesh_dp")
    want = {"sample_neighbors": 2 * t, "identity_masked_mean": t,
            "gathered_masked_mean": t, "gathered_masked_mean_backward": t,
            "gather_rows": 2 * t, "grouped_masked_sum": 0, "dedup_tail": t,
            "gathered_feature_mean": 0, "act_dropout": t,
            "act_dropout_backward": t}
    require(launches == want, f"exact launches {launches} (want {want})")
    m, d = tr.caps[-1], tr.features.shape[1]
    a2a = t * comm.exact_exchange_bytes(m, 1, d)["all_to_all"]
    require(calls.get("all_to_all") == 2 * t
            and counts.get("all_to_all") == a2a,
            f"two all-to-alls a step of {a2a // t} B, got {calls} / {counts}")
    return {"world": 1, "backend": backend, "caps": list(tr.caps),
            "steps": t, "losses": rec["losses"], "mesh_dp_losses": dp_losses,
            "worst_rel_diff": worst, "cap_overflow": rec["cap_overflow"],
            "ms_per_step": 1e3 * steady["epoch_s"] / t,
            "mesh_dp_ms_per_step": dp_ms, "epoch_counts": counts,
            "epoch_calls": calls, "launches": launches,
            "kernel_checks": {"gather_rows": k3},
            "captured": captured}, launches


def _phase_log(lines):
    def log(s):
        lines.append(s)
        print(s, file=sys.stderr, flush=True)
    return log


def striped_cached(kernels, results, ref):
    """Part of phase "mesh_striped": ``run_cached_training`` on a mesh of
    world size 1 on phase 6's cell against phase 6's run without one
    (``ref``): the same seeds, so step 0 bitwise and the rest within
    ``STRIPED_LOSS_RTOL``, and the same hit rate, staging overflow and
    host bytes, no exchange overflow, and exact launches (K3 once more a
    step than the cached path: the exchange's serve and reassembly where
    the cache read its rows once). Then one batch's tensors: the sampling
    kernel on both hops, K3 on the exchange's two gathers, K2 on the
    layer-1 block. Last, ``run_cached_training`` once more, so that the
    striped run's ms/step stands between two of its twin's."""
    import torch
    import torch.distributed as dist

    from legion_tpu_torch.cache.striped_pipeline import StripedCachedTrainer
    from legion_tpu_torch.parallel import mesh
    from legion_tpu_torch.sampling.sampler import sample_batch
    from legion_tpu_torch.tools import pa_cell
    from legion_tpu_torch.train.cached_driver import run_cached_training
    lines = []
    data, _, _ = pa_cell.dataset(REPO, _phase_log(lines))
    cfg = pa_cell.config(epochs=2)
    reset_launches(kernels)
    t0 = time.perf_counter()
    res = run_cached_training(cfg, data, "cuda", mesh=mesh.make_mesh(1),
                              log=_phase_log(lines))
    run_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    hist, tr = res["history"], res["trainer"]
    worst = loss_drift([h["losses"] for h in hist], ref["losses"],
                       "run_cached_training on a mesh against "
                       "run_cached_training")
    for h, w in zip(hist, ref["epochs"]):
        for key in ("cache_hit_rate", "staging_overflow", "host_gb"):
            require(h[key] == w[key], f"epoch {h['epoch']}: {key} "
                    f"{h[key]} equals the cached driver's {w[key]}")
        require(h["exchange_overflow"] == 0, "no exchange overflow")
    want = dict(ref["launches"], gather_rows=ref["launches"]["gather_rows"]
                + ref["launches"]["gathered_masked_mean"])
    require(launches == want, f"exact launches {launches} (want {want})")
    # its stages captured on the NCCL group against its twin without a
    # pool, the collectives inside the graphs
    require(tr.pool is not None and tr.pool.captures,
            "the striped driver's trainer captures on NCCL")
    state = res["state"]
    seeds = seed_rows(data.train_ids, pa_cell.STEPS, pa_cell.BATCH,
                      seed=23).numpy()
    labels = labels_of(data, seeds)
    captured = staged_vs_eager(
        kernels, "striped_cached", tr,
        StripedCachedTrainer(cfg, tr.model, tr.caps, tr.graph, tr.cache),
        state, lambda t: t.run_epoch(state, seeds, labels),
        ("cache_hit_rate", "host_gb", "staging_overflow", "edges",
         "exchange_overflow"), striped_cached_comm(tr, pa_cell.STEPS))
    del state
    # one batch at the path's caps, through the striped cache
    caps, dev = tr.caps, torch.device("cuda")
    seeds = torch.tensor(data.train_ids[:pa_cell.BATCH], device=dev)
    batch = sample_batch(tr.graph, seeds,
                         torch.tensor(pa_cell.BATCH, dtype=torch.int32,
                                      device=dev),
                         torch.zeros_like(seeds), cfg.sampler.fanouts, caps,
                         dedup_last=True,
                         generator=torch.Generator(device=dev).manual_seed(3))
    hops = check_sampling_kernel(tr.graph, hop_frontiers(batch, caps),
                                 cfg.sampler.fanouts, seed=4)
    plan = tr.cache.plan(batch.frontier)
    k3 = check_exchange(tr.cache.rows, torch.where(plan.hit, plan.slot, -1),
                        tr.cache.group, tr.cache.owner_cap_rows)
    blk1 = batch.blocks[0]
    gen = torch.Generator(device=dev).manual_seed(6)
    h_t = torch.randn((caps[1], pa_cell.CLASSES), generator=gen,
                      device=dev).to(torch.bfloat16)
    gd = torch.randn((blk1.nbr_mask.shape[0], pa_cell.CLASSES), generator=gen,
                     device=dev).to(torch.bfloat16)
    fwd, bwd = check_k2(h_t, blk1.nbr_pos, blk1.nbr_mask, gd, "mean")
    results["gathered_masked_mean"]["shapes"]["striped_pa_bf16"] = fwd
    results["gathered_masked_mean_backward"]["shapes"]["striped_pa_bf16"] = (
        bwd)
    results["gather_rows"]["striped_pa_exchange"] = k3
    results["sample_neighbors"]["striped_pa_hops"] = hops
    require(dist.get_world_size(tr.cache.group) == 1, "a one-rank group")
    del res, tr, batch, plan, blk1, h_t, gd
    torch.cuda.empty_cache()
    # the single-device driver once more, so that the striped run's
    # ms/step stands between two of its twin's in this call
    again = run_cached_training(cfg, data, "cuda", log=_phase_log(lines))
    out = {"driver_log": lines, "run_s": run_s, "worst_rel_diff": worst,
           "epochs": [{"epoch": h["epoch"], "losses": h["losses"],
                       "hit_rate": h["cache_hit_rate"],
                       "host_gb": h["host_gb"],
                       "staging_overflow": h["staging_overflow"],
                       "exchange_overflow": h["exchange_overflow"],
                       "ms_per_step": 1e3 * h["seconds"] / h["steps"]}
                      for h in hist],
           "cached_ms_per_step": [1e3 * w["seconds"] / w["steps"]
                                  for w in ref["epochs"]],
           "cached_again_ms_per_step": [1e3 * w["seconds"] / w["steps"]
                                        for w in again["history"]],
           "launches": launches, "captured": captured,
           "kernel_checks": {"sample_neighbors_hops": hops,
                             "gather_rows": k3,
                             "k2": {"forward": fwd, "backward": bwd}}}
    return out, launches


def striped_hybrid(kernels, results, ref):
    """Part of phase "mesh_striped": ``run_hybrid_training`` on a mesh of
    world size 1 on phase 8's cell against phase 8's run without one
    (``ref``): step 0 bitwise and the rest within
    ``STRIPED_LOSS_RTOL``, the same hot fraction, hit rate and packed
    reads, no exchange overflow, exact launches (K3 once more a step).
    Then one batch through the trainer's own stages: the sampling kernel
    on the sub-CSR stripe with the rows the exchange hands the owner, K3
    on the feature exchange's two gathers, K2 on the layer-1 block. Last,
    ``run_hybrid_training`` once more (see ``striped_cached``)."""
    import collections

    import torch

    from legion_tpu_torch.cache.striped_hybrid import StripedHybridTrainer
    from legion_tpu_torch.parallel import mesh
    from legion_tpu_torch.parallel.feature_exchange import (owner_cap,
                                                            route_by_owner)
    from legion_tpu_torch.tools import hybrid_cell, pa_cell
    from legion_tpu_torch.train.hybrid_driver import run_hybrid_training
    from legion_tpu_torch.utils import comm
    lines = []
    data, _, _ = hybrid_cell.dataset(REPO, _phase_log(lines))
    cfg = hybrid_cell.config(epochs=2)
    reset_launches(kernels)
    t0 = time.perf_counter()
    res = run_hybrid_training(cfg, data, "cuda", mesh=mesh.make_mesh(1),
                              log=_phase_log(lines))
    run_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    hist, tr = res["history"], res["trainer"]
    worst = loss_drift([h["losses"] for h in hist], ref["losses"],
                       "run_hybrid_training on a mesh against "
                       "run_hybrid_training")
    for h, w in zip(hist, ref["epochs"]):
        for key in ("topo_hot_fraction", "feat_hit_rate", "fetches",
                    "staging_overflow", "host_topo_gb"):
            require(h[key] == w[key], f"epoch {h['epoch']}: {key} "
                    f"{h[key]} equals the hybrid driver's {w[key]}")
        require(h["exchange_overflow"] == 0, "no exchange overflow")
    want = dict(ref["launches"], gather_rows=ref["launches"]["gather_rows"]
                + ref["launches"]["gathered_masked_mean"])
    require(launches == want, f"exact launches {launches} (want {want})")
    # its stages captured on the NCCL group against its twin without a
    # pool, the collectives inside the graphs
    require(tr.pool is not None and tr.pool.captures,
            "the striped hybrid driver's trainer captures on NCCL")
    state = res["state"]
    seeds = seed_rows(data.train_ids, pa_cell.STEPS, pa_cell.BATCH,
                      seed=24).numpy()
    labels = labels_of(data, seeds)
    eager = StripedHybridTrainer(cfg, tr.model, tr.caps, tr.topo,
                                 tr.host_indptr, tr.host_indices, tr.fcache,
                                 tr.mesh, topo_owner_caps=tr.topo_owner_caps)
    captured = staged_vs_eager(
        kernels, "striped_hybrid", tr, eager, state,
        lambda t: t.run_epoch(state, seeds, labels, 2),
        HYBRID_FIGURES + ("exchange_overflow",),
        striped_hybrid_comm(tr, pa_cell.STEPS))
    del state
    # one batch through the trainer's stages
    dev, caps, topo = torch.device("cuda"), tr.caps, tr.topo
    batch, plan = staged_batch(tr, eager, data.train_ids[:pa_cell.BATCH],
                               pa_cell.BATCH)
    # the rows the exchange hands the owner for each hop's hits
    rows, hot_share = [], []
    for fr in hop_frontiers(batch, caps):
        hit, rank = topo.lookup(fr)
        send = route_by_owner(torch.where(hit, rank, -1), 1,
                              owner_cap(fr.shape[0], 1))[0]
        recv = comm.all_to_all(send.reshape(-1), topo.group)
        rows.append(torch.where(recv >= 0, recv, -1).to(torch.int32))
        hot_share.append(int(hit.sum()) / max(int((fr >= 0).sum()), 1))
    SubCsr = collections.namedtuple("SubCsr", "indptr indices")
    sub_hops = check_sampling_kernel(
        SubCsr(topo.sub_indptr, topo.sub_indices), rows,
        cfg.sampler.fanouts, seed=9)
    for rec, share in zip(sub_hops, hot_share):
        rec["hot_share"] = share
    k3 = check_exchange(tr.fcache.rows,
                        torch.where(plan.hit, plan.slot, -1),
                        tr.fcache.group, tr.fcache.owner_cap_rows)
    blk1 = batch.blocks[0]
    g2 = torch.Generator(device=dev).manual_seed(10)
    h_t = torch.randn((caps[1], pa_cell.CLASSES), generator=g2,
                      device=dev).to(torch.bfloat16)
    gd = torch.randn((blk1.nbr_mask.shape[0], pa_cell.CLASSES), generator=g2,
                     device=dev).to(torch.bfloat16)
    fwd, bwd = check_k2(h_t, blk1.nbr_pos, blk1.nbr_mask, gd, "mean")
    results["gathered_masked_mean"]["shapes"]["striped_uk_bf16"] = fwd
    results["gathered_masked_mean_backward"]["shapes"]["striped_uk_bf16"] = (
        bwd)
    results["gather_rows"]["striped_uk_exchange"] = k3
    results["sample_neighbors"]["striped_uk_hops"] = sub_hops
    del res, tr, eager, batch, plan, blk1, h_t, gd
    torch.cuda.empty_cache()
    # the single-device driver once more (see striped_cached)
    again = run_hybrid_training(cfg, data, "cuda", log=_phase_log(lines))
    out = {"driver_log": lines, "run_s": run_s, "worst_rel_diff": worst,
           "epochs": [{"epoch": h["epoch"], "losses": h["losses"],
                       "topo_hot_fraction": h["topo_hot_fraction"],
                       "feat_hit_rate": h["feat_hit_rate"],
                       "fetches": h["fetches"],
                       "exchange_overflow": h["exchange_overflow"],
                       "staging_overflow": h["staging_overflow"],
                       "ms_per_step": 1e3 * h["seconds"] / h["steps"]}
                      for h in hist],
           "hybrid_ms_per_step": [1e3 * w["seconds"] / w["steps"]
                                  for w in ref["epochs"]],
           "hybrid_again_ms_per_step": [1e3 * w["seconds"] / w["steps"]
                                        for w in again["history"]],
           "launches": launches, "captured": captured,
           "kernel_checks": {"sample_neighbors_hops": sub_hops,
                             "gather_rows": k3,
                             "k2": {"forward": fwd, "backward": bwd}}}
    return out, launches


def mesh_striped(kernels, results, smi, sharded, refs):
    """Phase "mesh_striped": the cache-group paths at world size 1 through
    NCCL, in this process (file rendezvous), each against its
    single-device twin in this call: ``sharded`` (from
    ``mesh_sharded``), then the striped cached and the striped hybrid
    drivers on phases 6's and 8's cells. Cut: 4-8 ranks to 1, the
    machine's one card. Returns each path's launch counts."""
    import torch
    import torch.distributed as dist

    from legion_tpu_torch.parallel import mesh
    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_process(0, 1, os.path.join(tmp, "init"), "cuda")
        try:
            backend = dist.get_backend()
            cached, l_cached = striped_cached(kernels, results,
                                              refs["cached"])
            torch.cuda.empty_cache()
            hybrid, l_hybrid = striped_hybrid(kernels, results,
                                              refs["hybrid"])
        finally:
            dist.destroy_process_group()
    require(backend == "nccl", f"the one-rank group runs NCCL, not {backend}")
    record, l_sharded = sharded
    emit({"phase": "mesh_striped", "nvidia_smi": smi, "backend": backend,
          "world": 1, "cut": "4-8 ranks to 1 (one card)",
          "loss_rtol": STRIPED_LOSS_RTOL["bfloat16"], "hbm_sharded": record,
          "striped_cached": cached, "striped_hybrid": hybrid,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return {"mesh_striped_sharded": l_sharded,
            "mesh_striped_cached": l_cached,
            "mesh_striped_hybrid": l_hybrid}


def mesh_striped_k2(smi):
    """Phase "mesh_striped_k2": ``legion_tpu_torch.tools.cache_group_cell``
    on two gloo ranks sharing this card (``share_device``: every
    collective staged through host memory; behaviour, not speed) on the
    learning smoke's graph. Each path at cache axis 2 against the same
    run at cache axis 1 (same seeds and hot sets): one batch's feature
    matrix (and one hop's hot draws) bitwise equal, losses within
    ``STRIPED_LOSS_RTOL``, the exchange's bytes the closed forms', the
    same launches at both axes, the striped cached run's validation
    accuracy > 0.15 after 2 epochs. Returns rank 0's launches of each
    path at cache axis 2."""
    from legion_tpu_torch.tools import cache_group_cell
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cache_group_cell.json")
        t0 = time.perf_counter()
        cache_group_cell.main([path])
        run_s = time.perf_counter() - t0
        with open(path) as f:
            out = json.load(f)

    def losses(rec):
        if "losses" in rec:
            return [rec["losses"]]
        return [h["losses"] for h in rec["history"]]

    worst = {}
    for r in out["ranks"]:
        require(all(r["x_equal"].values()),
                f"rank {r['rank']}: feature matrices equal at cache axes 1 "
                f"and 2: {r['x_equal']}")
        require(r["hot_draws_equal"], f"rank {r['rank']}: hot draws equal")
        for name, b in r["bytes"].items():
            require(b["counted"] == b["closed_form"],
                    f"rank {r['rank']} {name}: bytes {b}")
        for p in ("sharded", "cached", "hybrid"):
            worst[f"{p}_rank{r['rank']}"] = loss_drift(
                losses(r[f"{p}_k2"]), losses(r[f"{p}_k1"]),
                f"{p} at cache axis 2 against 1, rank {r['rank']}",
                dtype="float32")
    r0 = out["ranks"][0]
    for p in ("sharded", "cached", "hybrid"):
        l1, l2 = r0["launches"][f"{p}_k1"], r0["launches"][f"{p}_k2"]
        require(l1 == l2 and l2["gather_rows"] > 0
                and l2["sample_neighbors"] > 0,
                f"{p}: the same launches at both axes: {l1} / {l2}")
    acc = r0["cached_k2"]["history"][-1]["valid"]
    require(acc > 0.15, f"striped cached validation accuracy {acc} > 0.15")
    emit({"phase": "mesh_striped_k2", "nvidia_smi": smi,
          "mode": "2 gloo ranks sharing cuda:0, collectives staged "
                  "through host memory: behaviour, not speed",
          "graph": out["size"], "run_s": run_s,
          "loss_rtol": STRIPED_LOSS_RTOL["float32"],
          "worst_rel_diff": worst, "valid_acc": {
              f"{p}_k{k}": ([h["valid"] for h in r0[f"{p}_k{k}"]["history"]]
                            if "history" in r0[f"{p}_k{k}"]
                            else [r0[f"{p}_k{k}"]["valid"]])
              for p in ("sharded", "cached", "hybrid") for k in (1, 2)},
          "exchange_overflow": {
              f"{p}_k2": [h["exchange_overflow"]
                          for h in r0[f"{p}_k2"]["history"]]
              for p in ("cached", "hybrid")},
          "hit_rate": {f"cached_k{k}": [h["cache_hit_rate"] for h in
                                        r0[f"cached_k{k}"]["history"]]
                       for k in (1, 2)},
          "owner_caps": {"cached": r0["cached_k2"]["history"][0]["owner_cap"],
                         "hybrid_topo": r0["hybrid_k2"]["history"][0][
                             "topo_owner_caps"],
                         "hybrid_feat": r0["hybrid_k2"]["history"][0][
                             "feat_owner_cap"]},
          "bytes": r0["bytes"], "ranks": [
              {"rank": r["rank"], "x_equal": r["x_equal"],
               "hot_draws_equal": r["hot_draws_equal"]}
              for r in out["ranks"]],
          "launches": r0["launches"]})
    return {f"mesh_striped_k2_{p}": r0["launches"][f"{p}_k2"]
            for p in ("sharded", "cached", "hybrid")}


def mesh_partitioned(kernels, results, smi, cached_ref):
    """Phase "mesh_partitioned": the edge-partitioned path at world size 1
    through NCCL, in this process, on phase 6's papers100M-class graph
    (cut: 2-8 ranks to 1, the machine's one card; no request leaves the
    rank, so the exchange makes no collective and the step's host and
    device cost is what shows) with SAGE-256 bf16, fanout [25,10], batch
    8000 and the reference's loose caps: ``run_partitioned_training`` for
    two epochs of 10 steps, each followed by eval on the valid set, then
    the test set. Finite losses, no halo overflow, exact launch counts
    (per train step the sampling kernel twice, K3, K2 forward and
    backward and the gathered feature mean once each; per eval step the
    same but K2 backward; K1 and K5 never). On one more batch, sampled
    with one set of grids through the exact exchange and through the psum
    exchange (whose all-gather and reduce-scatter run through NCCL):
    bitwise the same draws and feature
    matrix, ids >= 2^24 in the frontier, and the logits within 3e-2 x
    max|logit| of the same batch through the plain versions on the CPU.
    Then every kernel of the path against its plain version on that
    batch's tensors: the sampling kernel on the compact CSR with each
    hop's ``where(mine, row, -1)`` frontier, K3 on the self-served gather
    of the whole frontier, K2 forward and backward on layer 1's block; and
    K2 at layer 0's block shape (the block's positions into the
    transformed features, width 256), which the path does not run: layer 0
    widens 32 -> 256 and aggregates the raw features first, as the
    reference's model does, with the gathered feature mean. Returns the
    run's launch counts."""
    import resource
    import types

    import torch
    import torch.distributed as dist

    from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                         ParallelConfig, SamplerConfig,
                                         TrainConfig)
    from legion_tpu_torch.models import build_model
    from legion_tpu_torch.parallel import mesh
    from legion_tpu_torch.parallel.halo import _local_lookup
    from legion_tpu_torch.parallel.multihost import HaloPath
    from legion_tpu_torch.sampling.block import Block
    from legion_tpu_torch.sampling.sampler import DeviceGraph
    from legion_tpu_torch.tools import pa_cell
    from legion_tpu_torch.train.partitioned_driver import (
        run_partitioned_training)
    from legion_tpu_torch.utils import comm
    lines = []

    def log(s):
        lines.append(s)
        print(s, file=sys.stderr, flush=True)

    data, _, _ = pa_cell.dataset(REPO, log)
    b, fanouts = pa_cell.BATCH, (25, 10)
    cfg = Config(
        dataset=DatasetConfig(num_classes=pa_cell.CLASSES),
        sampler=SamplerConfig(fanouts=fanouts, batch_size=b),
        model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype="bfloat16"),
        train=TrainConfig(learning_rate=0.003, epochs=2),
        parallel=ParallelConfig(num_devices=1))
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_process(0, 1, os.path.join(tmp, "init"), "cuda")
        try:
            backend = dist.get_backend()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(kernels)
            t0 = time.perf_counter()
            res = run_partitioned_training(cfg, data, dev, log=log)
            run_s = time.perf_counter() - t0
            launches = read_launches(kernels)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            # one batch through both exchanges, the same grids
            tr, model = res["trainer"], res["state"].model
            shard = tr.path.shard
            seeds = torch.from_numpy(data.train_ids[:b].copy()).to(dev)
            labels = torch.from_numpy(data.labels[data.train_ids[:b]]).to(dev)
            nb = torch.tensor(b, dtype=torch.int32, device=dev)
            gen = torch.Generator(device=dev).manual_seed(11)
            grids = [torch.rand((c, f), generator=gen, device=dev)
                     for c, f in zip(tr.caps, fanouts)]
            tr.path.overflow.zero_()
            batch = tr.path.sampler(fanouts, tr.caps)(
                shard, seeds, nb, labels, None, grids)
            x = tr.path.fetch(shard.feat_rows, batch.frontier)
            batch_overflow = int(tr.path.overflow)
            psum = HaloPath(shard, tr.path.owner_of, None)
            comm.reset_counts()
            pbatch = psum.sampler(fanouts, tr.caps)(shard, seeds, nb, labels,
                                                    None, grids)
            px = psum.fetch(shard.feat_rows, pbatch.frontier)
            torch.cuda.synchronize()
            psum_counts = comm.read_counts()
            # the captured steps against eager ones, through both exchanges
            captured = partitioned_captured(kernels, res, data, cfg, psum)
        finally:
            dist.destroy_process_group()
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    require(backend == "nccl", f"the one-rank group runs NCCL, not {backend}")
    hist = res["history"]
    require(len(hist) == 2 and all(h["steps"] == pa_cell.STEPS
                                   for h in hist),
            f"two epochs of {pa_cell.STEPS} steps")
    for h in hist:
        require(all(math.isfinite(v) for v in h["losses"]),
                f"finite losses in epoch {h['epoch']}")
        require(h["halo_overflow"] == 0 and h["cap_overflow"] == 0,
                f"no halo or cap overflow in epoch {h['epoch']}")
    require(tr.caps == (8000, 208000, 2288000) and res["dist_caps"] == (),
            f"the loose caps and no distance at one rank: {tr.caps}, "
            f"{res['dist_caps']}")
    t = sum(h["steps"] for h in hist)
    e = (2 * -(-len(data.valid_ids) // cfg.sampler.eval_batch_size)
         + -(-len(data.test_ids) // cfg.sampler.eval_batch_size))
    want = {"sample_neighbors": 2 * (t + e), "identity_masked_mean": 0,
            "gathered_masked_mean": t + e,
            "gathered_masked_mean_backward": t, "gather_rows": t + e,
            "grouped_masked_sum": 0, "dedup_tail": 2 * (t + e),
            "gathered_feature_mean": t + e, "act_dropout": t,
            "act_dropout_backward": t}
    require(launches == want, f"exact launches over {t} train and {e} eval "
            f"steps: {launches} (want {want})")
    same = (torch.equal(batch.frontier, pbatch.frontier)
            and all(torch.equal(a.nbr_pos, c.nbr_pos)
                    and torch.equal(a.nbr_mask, c.nbr_mask)
                    and torch.equal(a.num_src, c.num_src)
                    for a, c in zip(batch.blocks, pbatch.blocks)))
    require(same, "the exact and psum exchanges draw bitwise the same")
    require(torch.equal(x, px), "the exact and psum exchanges give bitwise "
            "the same feature matrix")
    require(batch_overflow == 0, "no halo overflow on the batch")
    big = int((batch.frontier >= 1 << 24).sum())
    require(big > 0, "the sampled frontier holds ids >= 2^24")
    num_frontier = int(batch.num_frontier)
    # the logits through the kernels against the plain versions on the CPU
    blocks = tuple(reversed(batch.blocks))
    with torch.no_grad():
        out = model(blocks, x, deterministic=True).float().cpu()
        cpu_model = build_model("sage", data.feature_dim, 256,
                                pa_cell.CLASSES, 2, 0.5, "bfloat16")
        cpu_model.load_state_dict({k: v.cpu()
                                   for k, v in model.state_dict().items()})
        ref = cpu_model(tuple(Block(k.nbr_pos.cpu(), k.nbr_mask.cpu(),
                                    k.num_src.cpu(), k.num_dst.cpu())
                              for k in blocks), x.cpu()).float()
    scale = float(ref.abs().max())
    logit_err = float((out - ref).abs().max())
    require(bool(torch.isfinite(out).all()) and logit_err <= 3e-2 * scale,
            f"logits on the card within 3e-2 x max|logit| of the CPU plain "
            f"path ({logit_err} vs {scale})")
    del cpu_model, ref, out
    # every kernel of the path on the batch's own tensors
    graph = DeviceGraph(shard.sub_indptr, shard.sub_indices)
    local = []
    for fr in hop_frontiers(batch, tr.caps) + [batch.frontier]:
        mine, row = _local_lookup(shard.owned_ids, fr)
        local.append(torch.where(mine, row, -1))
    hops = check_sampling_kernel(graph, local[:2], fanouts, seed=12)
    results["sample_neighbors"]["mesh_partitioned_hops"] = hops
    _, k3 = check_gather_rows(shard.feat_rows, local[2])
    results["gather_rows"]["mesh_partitioned"] = k3
    xb = x.to(torch.bfloat16)
    fwd, bwd = check_k2(*layer1_inputs(types.SimpleNamespace(model=model),
                                       batch, xb), "mean")
    shapes = "partitioned_pa_bf16"
    results["gathered_masked_mean"]["shapes"][shapes] = fwd
    results["gathered_masked_mean_backward"]["shapes"][shapes] = bwd
    layer0 = model.layers[0]
    blk0 = blocks[0]
    with torch.no_grad():
        h_t0 = layer0._dense(layer0.fc_neigh, xb)
    g0 = torch.randn((blk0.dst_cap, h_t0.shape[1]), generator=gen,
                     device=dev).to(torch.bfloat16)
    fwd0, bwd0 = check_k2(h_t0, blk0.nbr_pos, blk0.nbr_mask, g0, "mean")
    off = "partitioned_pa_bf16_layer0_not_on_path"
    results["gathered_masked_mean"]["shapes"][off] = fwd0
    results["gathered_masked_mean_backward"]["shapes"][off] = bwd0
    del h_t0, g0, xb, x, px, batch, pbatch, graph, local
    steady = hist[-1]
    cached_steady = cached_ref["epochs"][-1]
    emit({"phase": "mesh_partitioned", "nvidia_smi": smi,
          "backend": backend, "world": 1,
          "cut": "2-8 ranks to 1 (one card): no collective in the exchange",
          "graph": {"nodes": data.num_nodes, "edges": data.num_edges,
                    "features": data.feature_dim},
          "caps": list(tr.caps), "dist_caps": list(res["dist_caps"]),
          "edge_cut": res["edge_cut"], "setup_s": res["setup_s"],
          "run_s": run_s, "driver_log": lines,
          "epochs": [{"epoch": h["epoch"], "losses": h["losses"],
                      "ms_per_step": 1e3 * h["seconds"] / h["steps"],
                      "edges_per_s": h["edges_per_s"], "valid_acc": h["valid"],
                      "halo_overflow": h["halo_overflow"]} for h in hist],
          "steady_ms_per_step": 1e3 * steady["seconds"] / steady["steps"],
          "steady_edges_per_s": steady["edges_per_s"],
          "cached_path_steady_ms_per_step": 1e3 * cached_steady["seconds"]
          / cached_steady["steps"],
          "test_acc": res["test_acc"], "train_steps": t, "eval_steps": e,
          "launches": launches, "frontier_ids_past_2_24": big,
          "num_frontier": num_frontier,
          "psum_counts": psum_counts,
          "logits_vs_cpu_max_abs_err": logit_err, "logits_max_abs": scale,
          "captured": captured,
          "kernel_checks": {"sample_neighbors_hops": hops, "gather_rows": k3,
                            "k2_layer1": {"forward": fwd, "backward": bwd},
                            "k2_layer0_shape_not_on_path": {
                                "forward": fwd0, "backward": bwd0}},
          "peak_mem_gb": peak, "peak_host_rss_gb": rss_gb})
    return launches


def partitioned_captured(kernels, res, data, cfg, psum_path):
    """``captured_vs_eager`` on the partitioned run ``res`` (the exact
    exchange, one rank: the gradient's all-reduce is its one collective
    a step) and on a trainer of the same model and state through the
    psum exchange ``psum_path`` (its all-gathers and reduce-scatters, 3
    each a step, through NCCL), each on ``pa_cell.STEPS`` rows of train
    seeds and 3 steps of the validation schedule; with the share of the
    last hop's frontier cap that the sampled frontier fills (the rest is
    padding the step carries)."""
    import torch

    from legion_tpu_torch.parallel.multihost import PartitionedTrainer
    from legion_tpu_torch.tools import pa_cell
    from legion_tpu_torch.train.graphed import GraphPool
    from legion_tpu_torch.train.partitioned_driver import eval_chunks
    from legion_tpu_torch.utils import comm
    tr, state = res["trainer"], res["state"]
    shard = tr.path.shard
    dev = shard.owned_ids.device
    labels_all = torch.as_tensor(data.labels).int()
    seeds = seed_rows(data.train_ids, pa_cell.STEPS, cfg.sampler.batch_size,
                      seed=7)
    vs, vc, _ = eval_chunks(data.valid_ids, res["partition"], 1,
                            cfg.sampler.eval_batch_size)
    vs, vc = torch.as_tensor(vs[0][:3]), torch.as_tensor(vc[0][:3])
    vl = torch.where(vs >= 0, labels_all[vs.clamp(min=0).long()], -1)
    args = (state, shard, shard.feat_rows, seeds.to(dev),
            labels_all[seeds.long()].to(dev),
            (vs.to(dev), vc.to(dev), vl.to(dev)))
    pb = comm.param_bytes(state.model)
    d = shard.feat_rows.shape[1]
    exact = captured_vs_eager(kernels, "mesh_partitioned", tr.fns,
                              tr.fns_eval, *args,
                              ({"all_reduce": 1}, {"all_reduce": pb}),
                              overflow=tr.path.overflow)
    ptr = PartitionedTrainer(cfg, state.model, psum_path, tr.caps,
                             tr.eval_caps, GraphPool(dev))
    per = comm.psum_exchange_bytes(tr.caps[-1], 1, d)
    for c, f in zip(tr.caps, cfg.sampler.fanouts):
        per = {k: v + per[k]
               for k, v in comm.psum_exchange_bytes(c, 1, f).items()}
    psum = captured_vs_eager(
        kernels, "mesh_partitioned psum", ptr.fns, ptr.fns_eval, *args,
        ({"all_reduce": 1, "all_gather": 3, "reduce_scatter": 3},
         {"all_reduce": pb, **per}), overflow=psum_path.overflow)
    fill = [f / tr.caps[-1] for f in exact["frontier"]]
    return {"exact": exact, "psum": psum,
            "last_hop_frontier_fill": fill,
            "last_hop_padding_share": 1.0 - sum(fill) / len(fill)}

def mesh_partitioned_k2(smi):
    """Phase "mesh_partitioned_k2": ``legion_tpu_torch.tools.partition_cell``
    on two gloo ranks sharing this card (every collective staged through
    host memory: behaviour, not speed), then on one rank, on the learning
    smoke's graph with the greedy partition (its edge cut printed beside
    hash's), SAGE-256 float32, 2 epochs. On every rank one batch drawn
    through the exact and the psum exchange with the same grids gives
    bitwise the same draws and feature matrix, the exact exchange's
    counted collective-permute bytes equal ``halo_exact_hop_bytes`` (both
    hops) plus ``halo_exact_fetch_bytes`` at the probed caps, no halo
    overflow anywhere, validation accuracy > 0.15 at both world sizes,
    and the launches per step are those the CPU test pins: at 2 ranks the
    sampling kernel 4 times (twice a hop), K3 3 times, K2 forward once
    (layer 1; layer 0 widens 100 -> 256), K2 backward and the
    activation-dropout forward and backward once a train step;
    at 1 rank the sampling kernel twice and K3 once. Returns rank 0's
    launches of the 2-rank driver run."""
    from legion_tpu_torch.tools import partition_cell
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "partition_cell.json")
        t0 = time.perf_counter()
        partition_cell.main([path])
        run_s = time.perf_counter() - t0
        with open(path) as f:
            out = json.load(f)
    for world, per_hop, k3 in ((2, 4, 3), (1, 2, 1)):
        run = out[f"world{world}"]
        for r in run["ranks"]:
            what = f"world {world} rank {r['rank']}"
            ob = r["one_batch"]
            require(ob["draws_equal"] and ob["x_equal"],
                    f"{what}: exact and psum draws and rows bitwise equal")
            require(ob["exact_bytes"] == ob["closed_form_bytes"],
                    f"{what}: collective-permute bytes {ob['exact_bytes']} "
                    f"are the closed form's {ob['closed_form_bytes']}")
            ovs = ([h["halo_overflow"] for h in r["history"]]
                   + [r["extra_epoch_halo_overflow"],
                      r["extra_eval_halo_overflow"], ob["overflow"]])
            require(not any(ovs), f"{what}: no halo overflow, got {ovs}")
            t, e = r["train_steps"], r["eval_steps"]
            want_t = {"sample_neighbors": per_hop * t,
                      "identity_masked_mean": 0, "gathered_masked_mean": t,
                      "gathered_masked_mean_backward": t,
                      "gather_rows": k3 * t, "grouped_masked_sum": 0,
                      "dedup_tail": 2 * t, "edge_softmax_aggregate": 0,
                      "edge_softmax_aggregate_backward": 0,
                      "gathered_feature_mean": t, "act_dropout": t,
                      "act_dropout_backward": t}
            want_e = dict(want_t, sample_neighbors=per_hop * e,
                          gathered_masked_mean=e,
                          gathered_masked_mean_backward=0,
                          gather_rows=k3 * e, dedup_tail=2 * e,
                          gathered_feature_mean=e, act_dropout=0,
                          act_dropout_backward=0)
            require(r["train_launches"] == want_t
                    and r["eval_launches"] == want_e,
                    f"{what}: launches per step, train {r['train_launches']}"
                    f" (want {want_t}), eval {r['eval_launches']} (want "
                    f"{want_e})")
        acc = run["ranks"][0]["history"][-1]["valid"]
        require(acc > 0.15, f"world {world}: validation accuracy {acc} > "
                "0.15")
    r0 = out["world2"]["ranks"][0]
    emit({"phase": "mesh_partitioned_k2", "nvidia_smi": smi,
          "mode": "2 gloo ranks sharing cuda:0, collectives staged "
                  "through host memory: behaviour, not speed; then 1 rank "
                  "through NCCL",
          "graph": out["world2"]["size"], "run_s": run_s,
          "edge_cut": out["world2"]["edge_cut"],
          "dist_caps": r0["dist_caps"], "caps": r0["caps"],
          "valid_acc": {w: [h["valid"] for h in
                            out[w]["ranks"][0]["history"]]
                        for w in ("world2", "world1")},
          "test_acc": {w: out[w]["ranks"][0]["test_acc"]
                       for w in ("world2", "world1")},
          "losses": {w: [h["losses"] for h in out[w]["ranks"][0]["history"]]
                     for w in ("world2", "world1")},
          "one_batch": {w: [r["one_batch"] for r in out[w]["ranks"]]
                        for w in ("world2", "world1")},
          "launches": {w: {"train": out[w]["ranks"][0]["train_launches"],
                           "eval": out[w]["ranks"][0]["eval_launches"],
                           "train_steps": out[w]["ranks"][0]["train_steps"],
                           "eval_steps": out[w]["ranks"][0]["eval_steps"]}
                       for w in ("world2", "world1")},
          "run_seconds": {w: out[w]["ranks"][0]["run_s"]
                          for w in ("world2", "world1")}})
    return r0["run_launches"]


# epochs of the ogb_products phase's harness run (its default is 10)
OGB_EPOCHS = 3


# the kernels that a train step launches and an eval step does not
TRAIN_ONLY = ("gathered_masked_mean_backward", "act_dropout",
              "act_dropout_backward")


def per_step(launches, train_steps, eval_steps):
    """Launches per step as exact fractions: a ``TRAIN_ONLY`` kernel's per
    train step, every other kernel's per train or eval step."""
    return {name: Fraction(n, train_steps + (
        0 if name in TRAIN_ONLY else eval_steps))
        for name, n in launches.items()}


def ogb_products(kernels, results, smi, main_rec):
    """Phase "ogb_products": a user's path from an OGB dataset to training
    on the card, on ``tools/products_cell.py``'s stand-in at the published
    shapes of ogbn-products (2,449,029 nodes, 61,859,140 edges, 100
    float32 features, 47 classes; cut: none). It converts the stand-in
    with ``convert_ogb_node_dataset`` into a fresh directory under
    .bench_cache/ (seconds, peak host RSS; ``meta.json`` must equal the
    registry's ``PR`` entry in nodes, edges, width and classes), trains
    through the harness ``legion_tpu_torch.tools.parity_ogb`` in this
    process (SAGE-256 bf16, fanout [25,10], batch 8000, ``OGB_EPOCHS``
    epochs, target 0.15, 7x chance: verdict PASS above 0.15, finite
    losses, no cap overflow, and each kernel's launches per step equal to
    ``main_rec``'s, the main path's, once the cap probe's are taken off),
    holds every kernel against its plain version on one batch of a
    ``Trainer`` of the same configuration on ``load_dataset(packed)``, and
    runs ``python -m legion_tpu_torch.train --dataset PR --data-dir
    <packed>`` for one epoch (exit 0, no registry complaint, finite
    losses, the test line). Returns the harness run's launch counts."""
    import contextlib
    import io
    import re

    import torch

    from legion_tpu_torch.config import (DATASET_REGISTRY, Config,
                                         DatasetConfig, ModelConfig,
                                         SamplerConfig, TrainConfig)
    from legion_tpu_torch.data.format import load_dataset
    from legion_tpu_torch.data.ogb import convert_ogb_node_dataset
    from legion_tpu_torch.tools import parity_ogb, products_cell
    from legion_tpu_torch.train.loop import Trainer
    reg = DATASET_REGISTRY["PR"]
    t0 = time.perf_counter()
    root = products_cell.standin(REPO, log=stderr_log)
    gen_s = time.perf_counter() - t0
    cache = os.path.join(REPO, ".bench_cache")
    names = ("ogb", "ogb.nodeproppred")
    saved = {k: sys.modules.get(k) for k in names}
    stand_in = products_cell.ogb_module()
    sys.modules.update({k: stand_in for k in names})
    try:
        with tempfile.TemporaryDirectory(dir=cache,
                                         prefix="ogb_products_") as tmp:
            packed = os.path.join(tmp, "packed")
            rss_before = resident_gb()
            t0 = time.perf_counter()
            _, peak = with_peak_rss(lambda: convert_ogb_node_dataset(
                "ogbn-products", root, packed))
            convert_s = time.perf_counter() - t0
            with open(os.path.join(packed, "meta.json")) as f:
                meta = json.load(f)
            want = [reg.num_nodes, reg.num_edges, reg.feature_dim,
                    reg.num_classes]
            got = [meta["num_nodes"], meta["num_edges"],
                   meta["feature_dim"], meta["num_classes"]]
            require(got == want, f"the converted meta.json has the PR "
                    f"registry's nodes, edges, width and classes: {got} "
                    f"against {want}")

            # the harness, in this process; its log goes to stderr after
            out, err = io.StringIO(), io.StringIO()
            reset_launches(kernels)
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(err):
                    rc = parity_ogb.main([
                        "--ogb-root", root, "--out", packed, "--dtype",
                        "bfloat16", "--epochs", str(OGB_EPOCHS), "--target",
                        "0.15"])
            finally:
                stderr_log(out.getvalue() + err.getvalue())
            harness_s = time.perf_counter() - t0
            launches = read_launches(kernels)
            torch.cuda.empty_cache()
            verdict = json.loads(out.getvalue().strip().splitlines()[-1])
            epochs = [rec for rec in (json.loads(s) for s in
                                      err.getvalue().splitlines()
                                      if s.startswith("{"))
                      if rec.get("event") == "train_epoch"]
            require(rc == 0 and verdict["parity"] == "PASS"
                    and verdict["test_acc"] > 0.15,
                    f"the harness passes above 0.15: rc {rc}, {verdict}")
            require(len(epochs) == OGB_EPOCHS, f"{OGB_EPOCHS} epochs logged")
            for rec in epochs:
                require(all(math.isfinite(v) for v in rec["losses"]),
                        f"finite losses in epoch {rec['epoch']}")
                require(rec["cap_overflow"] == 0,
                        f"no cap overflow in epoch {rec['epoch']}")

            # a Trainer of the harness's configuration on the packed
            # directory: its set-up launches (the cap probe's draws) and
            # every kernel on one batch of its step
            data = load_dataset(packed)
            cfg = Config(
                dataset=DatasetConfig(
                    name="ogbn-products", path=packed,
                    num_nodes=data.num_nodes, num_edges=data.num_edges,
                    feature_dim=data.feature_dim,
                    num_classes=data.num_classes),
                sampler=SamplerConfig(fanouts=(25, 10), batch_size=8000),
                model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                                  dropout=0.5, dtype="bfloat16"),
                train=TrainConfig(learning_rate=0.003, epochs=OGB_EPOCHS))
            reset_launches(kernels)
            t0 = time.perf_counter()
            tr = Trainer(cfg, data, device="cuda")
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            setup = read_launches(kernels)
            plan = tr.plan
            t_steps = OGB_EPOCHS * plan.train_steps
            # a validation pass after each epoch and one more, and the test
            e_steps = (OGB_EPOCHS + 1) * plan.valid_steps + plan.test_steps
            require(all(rec["steps"] == plan.train_steps for rec in epochs),
                    "the harness trained the plan's steps")
            got_rate = per_step({k: launches[k] - setup[k] for k in kernels},
                                t_steps, e_steps)
            want_rate = per_step(main_rec["launches"], *main_rec["steps"])
            require(got_rate == want_rate,
                    f"launches per step as on the main path: {got_rate} "
                    f"against {want_rate}")
            checks = trainer_kernel_checks(tr, data.labels, seed=11)
            record_kernel_checks(results, "ogb_products", checks)
            # its captured step's replays run what the bookkeeping says
            traced = replays_traced(kernels, trainer_scan(tr, 5), 5, {
                k: int(v) for k, v in want_rate.items()}, "ogb_products")
            caps = list(tr.caps)
            del tr, data
            torch.cuda.empty_cache()

            # the command line, as a user runs it on the packed directory
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "legion_tpu_torch.train", "--dataset",
                 "PR", "--data-dir", packed, "--batch-size", "8000",
                 "--fanouts", "25,10", "--hidden-dim", "256", "--dtype",
                 "bfloat16", "--epochs", "1"], capture_output=True,
                text=True, timeout=600, cwd=REPO,
                env=dict(os.environ, PYTHONPATH=REPO))
            cli_s = time.perf_counter() - t0
    finally:
        for k, mod in saved.items():
            if mod is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = mod
    require(r.returncode == 0,
            f"--dataset PR on the packed directory exits 0: "
            f"{r.stderr[-2000:]}")
    require("registry" not in r.stderr, "no registry complaint")
    losses = [float(v) for v in re.findall(r"Loss:([^,]+),", r.stdout)]
    require(len(losses) == 1 and all(math.isfinite(v) for v in losses),
            f"one finite epoch loss from the command line, got {losses}")
    require("Accuracy on test data" in r.stdout,
            "the command line prints the test line")
    steady = epochs[1:]
    emit({"phase": "ogb_products", "nvidia_smi": smi,
          "source": {"name": "ogbn-products", "stand_in": "tools/"
                     "products_cell.py", "num_nodes": reg.num_nodes,
                     "edge_index_columns": products_cell.SHAPE["num_edges"],
                     "split": list(products_cell.SHAPE["split"]),
                     "gen_s": gen_s},
          "packed": meta, "registry_pr": want, "convert_s": convert_s,
          "convert_peak_rss_gb": peak, "rss_before_convert_gb": rss_before,
          "harness_s": harness_s, "verdict": verdict, "caps": caps,
          "trainer_init_s": init_s,
          "epochs": [{"epoch": rec["epoch"], "steps": rec["steps"],
                      "losses": rec["losses"],
                      "cap_overflow": rec["cap_overflow"],
                      "epoch_s": rec["epoch_s"],
                      "ms_per_step": 1e3 * rec["epoch_s"] / rec["steps"],
                      "edges_per_s": rec["edges_per_s"]} for rec in epochs],
          "steady_ms_per_step": 1e3 * sum(rec["epoch_s"] for rec in steady)
          / sum(rec["steps"] for rec in steady),
          "steady_edges_per_s": [rec["edges_per_s"] for rec in steady],
          "main_path": {"ms_per_step": main_rec["ms_per_step"],
                        "edges_per_s": main_rec["edges_per_s"]},
          "train_steps": t_steps, "eval_steps": e_steps,
          "launches": launches, "setup_launches": setup,
          "launches_per_step": {k: str(v) for k, v in got_rate.items()},
          "kernel_checks": checks, "replays_traced": traced,
          "cli": {"seconds": cli_s, "losses": losses,
                  "test_line": r.stdout.strip().splitlines()[-1]}})
    return launches


BENCH_STEPS = 40          # the in-process variants' steps (3 passes each)
BENCH_CLI_TIMEOUT = 420


def bench_phase(kernels, smi, data, main_rec):
    """The benchmark entry point (``legion_tpu_torch.bench``) on phase 2's
    graph. (a) In this process, its measuring function ``run_variant`` at
    full width for ``BENCH_STEPS`` steps (a warm-up pass and two timed
    trials) for each variant: ``fanout`` must launch per step exactly what
    the main path launches per step (K1, K2 forward and backward, K3
    and the activation-dropout forward and backward once, the sampling
    kernel twice, K5 never) and ``coo_segment`` K3 and the
    activation-dropout once each and the sampling kernel twice, no K1 or
    K2; finite losses; and
    5 replays of a fresh variant's captured step traced: the profiler's
    kernel counts and the bookkeeping must both be 5 times those launches
    per step. (b) The graph saved under a fresh ``--cache-dir`` and ``python -m
    legion_tpu_torch.bench --cache-dir <dir>`` run twice at its defaults:
    exactly one stdout line each, with bench.py's keys, finite positive
    ``value`` and ``step_ms``, ``kernel_gate`` "pass"; the first run
    probes and measures the baseline, the second reads both memos.
    Returns each variant's launches over its run."""
    import torch

    from legion_tpu_torch import bench
    from legion_tpu_torch.data.format import save_dataset
    want = {"fanout": {"identity_masked_mean": 1, "gathered_masked_mean": 1,
                       "gathered_masked_mean_backward": 1, "gather_rows": 1,
                       "sample_neighbors": 2, "grouped_masked_sum": 0,
                       "dedup_tail": 1, "gathered_feature_mean": 0,
                       "act_dropout": 1, "act_dropout_backward": 1},
            "coo_segment": {"identity_masked_mean": 0,
                            "gathered_masked_mean": 0,
                            "gathered_masked_mean_backward": 0,
                            "gather_rows": 1, "sample_neighbors": 2,
                            "grouped_masked_sum": 0, "dedup_tail": 1,
                            "gathered_feature_mean": 0, "act_dropout": 1,
                            "act_dropout_backward": 1}}
    main_per_step = per_step(main_rec["launches"], *main_rec["steps"])
    require(main_per_step == want["fanout"],
            f"the main path's launches per step {main_per_step}")
    os.makedirs(os.path.join(REPO, ".bench_cache"), exist_ok=True)
    cache = tempfile.mkdtemp(prefix="bench_phase_",
                             dir=os.path.join(REPO, ".bench_cache"))
    try:
        args = bench.parse_args(["--steps", str(BENCH_STEPS), "--cache-dir",
                                 os.path.join(cache, "in_process")])
        setup = bench.prepare(args, data, log=stderr_log)
        by_variant, variants, traced = {}, {}, {}
        for agg in ("fanout", "coo_segment"):
            reset_launches(kernels)
            rec = bench.run_variant(agg, setup, log=stderr_log)
            launches = read_launches(kernels)
            got = {n: Fraction(c, 3 * setup.steps)
                   for n, c in launches.items()}
            require(got == want[agg],
                    f"bench variant {agg} launches per step {got}")
            require(all(math.isfinite(v) for v in rec["losses"]),
                    f"bench variant {agg}: finite losses")
            by_variant[f"bench_{agg}"] = launches
            variants[agg] = {**rec, "launches": launches}
            state, fns = bench.build_variant(agg, setup)
            traced[agg] = replays_traced(
                kernels, lambda: fns.epoch_scan(
                    state, setup.graph, setup.feats, setup.seeds[:5],
                    setup.labels[:5]),
                5, {k: int(v) for k, v in want[agg].items()},
                f"bench {agg}")
            del state, fns
        caps = setup.caps
        del setup
        torch.cuda.empty_cache()

        cli_cache = os.path.join(cache, "cli")
        t0 = time.perf_counter()
        save_dataset(data, bench.graph_dir(cli_cache, args.nodes, args.deg))
        save_s = time.perf_counter() - t0
        lines, run_s = [], []
        for i in range(2):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "legion_tpu_torch.bench",
                 "--cache-dir", cli_cache], cwd=REPO, capture_output=True,
                text=True, timeout=BENCH_CLI_TIMEOUT)
            run_s.append(time.perf_counter() - t0)
            stderr_log(res.stderr)
            require(res.returncode == 0,
                    f"bench run {i} exits 0 (got {res.returncode})")
            out = res.stdout.splitlines()
            require(len(out) == 1, f"bench run {i} prints one stdout line")
            rec = json.loads(out[0])
            require(tuple(rec) == bench.KEYS,
                    f"bench run {i} prints bench.py's keys: {list(rec)}")
            for k in ("value", "step_ms"):
                require(math.isfinite(rec[k]) and rec[k] > 0,
                        f"bench run {i}: {k} finite and > 0")
            require(rec["kernel_gate"] == "pass",
                    f"bench run {i}: kernel_gate {rec['kernel_gate']}")
            memo = ("observed caps from cache" in res.stderr,
                    "[coo_segment] baseline from cache" in res.stderr)
            require(memo == ((False, False) if i == 0 else (True, True)),
                    f"bench run {i}: memos read {memo}")
            lines.append(out[0])
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    emit({"phase": "bench", "nvidia_smi": smi, "caps": list(caps),
          "in_process_steps": BENCH_STEPS,
          "in_process": {agg: {k: v[k] for k in (
              "edges_per_s", "step_ms", "trials_ms_per_step",
              "edges_per_step", "losses", "launches")}
              for agg, v in variants.items()},
          "replays_traced": traced,
          "graph_save_s": save_s, "cli_s": run_s})
    for line in lines:     # the entry point's own lines, as it printed them
        print(line, flush=True)
    return by_variant


def main():
    import torch
    start = time.perf_counter()

    def announce(phase):
        """One stderr line as each phase starts, so that a failure's
        traceback follows the name of the phase that raised it."""
        stderr_log(f"phase {phase} start {time.perf_counter() - start:.1f}s")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)

    from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                         ModelConfig, SamplerConfig,
                                         TrainConfig)
    from legion_tpu_torch.data.synthetic import (bench_graph,
                                                 random_power_law_graph)
    from legion_tpu_torch.sampling.sampler import sample_batch
    from legion_tpu_torch.train.cached_driver import run_cached_training
    from legion_tpu_torch.train.loop import Trainer

    # float32 products in full float32, as the CPU reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = kernel_table()
    results = {name: {} for name in kernels}

    # -- 1. toolchain and card ------------------------------------------------
    announce("toolchain")
    smi = toolchain()

    # -- 2. the main path's set-up: data and Trainer (which probes caps) ---
    announce("setup")
    t0 = time.perf_counter()
    data = bench_graph(num_nodes=NODES)
    gen_s = time.perf_counter() - t0
    cfg = Config(
        dataset=DatasetConfig(num_classes=CLASSES),
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=8000,
                              observed_cap_slack=1.03),
        model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype="bfloat16"),
        train=TrainConfig(learning_rate=0.003))
    t0 = time.perf_counter()
    tr = Trainer(cfg, data, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # -- 3. kernels against their plain versions on one main-path step -----
    # A batch of the first training seeds, sampled at the trainer's probed
    # caps, and the tensors the step hands each kernel: each hop's frontier
    # (sampling), the frontier ids (K3), the gathered features and
    # identity block (K1), layer 1's transformed activations and gathered
    # block (K2 forward) and the gradient of the step's loss at layer 1's
    # aggregate (K2 backward). Dropout is off so that the gradient is a
    # function of the inputs.
    announce("kernels")
    b = cfg.sampler.batch_size
    seed_ids = data.train_ids[:b].copy()
    batch = sample_batch(
        tr.graph, torch.from_numpy(seed_ids).to(dev),
        torch.tensor(b, dtype=torch.int32, device=dev),
        torch.from_numpy(data.labels[seed_ids]).to(dev), cfg.sampler.fanouts,
        tr.caps, dedup_last=cfg.sampler.dedup_last,
        generator=torch.Generator(device=dev).manual_seed(0))
    hops = check_sampling_kernel(tr.graph, hop_frontiers(batch, tr.caps),
                                 cfg.sampler.fanouts, seed=1)
    # the kernels line carries the larger hop (hop 2 from the hop-1
    # frontier); both are in this phase's line
    results["sample_neighbors"].update(
        {k: hops[-1][k] for k in KERNEL_KEYS}, main_path_hops=hops,
        ragged_cases=check_sampling_sweep())
    blk0, blk1 = reversed(batch.blocks)        # model order
    require(blk0.identity_offset is not None, "layer 0's block is identity")
    table, ids = tr.features, batch.frontier
    # the identity-appended frontier repeats ids
    k3, rec = check_gather_rows(table, ids)
    results["gather_rows"].update(rec)

    x, m1, off = k3, blk0.nbr_mask, blk0.identity_offset
    results["identity_masked_mean"].update(
        check_identity_mean(x, m1, off),
        sqrt_max_abs_err=compared(       # GCN's norm
            compare_identity_mean(x, m1, off, "sqrt"),
            "identity_masked_mean with norm sqrt"))
    h_t, pos, m0, gd = layer1_inputs(tr, batch, x)
    # K2 at the shapes the full-width paths give it: SAGE's layer 1 in bf16
    # (norm "mean"; GCN bf16 runs the same tensors with "sum", checked
    # here too), and GCN float32's layer 1 (the same block in float32)
    fwd, bwd = check_k2(h_t, pos, m0, gd, "mean")
    fwd32, bwd32 = check_k2(h_t.float(), pos, m0, gd.float(), "sum")
    results["gathered_masked_mean"].update(
        fwd, shapes={"sage_main_bf16": fwd, "gcn_main_f32": fwd32})
    results["gathered_masked_mean_backward"].update(
        bwd, shapes={"sage_main_bf16": bwd, "gcn_main_f32": bwd32})
    results["grouped_masked_sum"].update(check_grouped_masked_sum(x, m1, off))
    fill = k2_fill_case()
    # hop 1 is the hop this path dedups (its last hop is identity-appended)
    dedups = dedup_cases("main", tr.graph, hop_frontiers(batch, tr.caps)[:1],
                         [batch.num_seeds], cfg.sampler.fanouts, tr.caps,
                         seed=2)
    results["dedup_tail"].update({k: dedups[0][k] for k in KERNEL_KEYS},
                                 main_path_hops=dedups)
    emit({"phase": "kernels", "caps": list(tr.caps),
          "shapes": {"table": list(table.shape), "ids": ids.shape[0],
                     "identity": [*m1.shape, x.shape[1], off],
                     "gathered": [*m0.shape, *h_t.shape]},
          "k2_fill": fill, "results": results})
    del batch, blk0, blk1, x, k3, m1, h_t, pos, m0, gd
    torch.cuda.empty_cache()

    # -- 4. the main path at full width ------------------------------------
    announce("main_path")
    reset_launches(kernels)
    epochs = [tr.train_one_epoch(e) for e in range(2)]
    valid_acc = tr.evaluate("valid")
    launches = read_launches(kernels)
    for rec in epochs:
        require(all(math.isfinite(v) for v in rec["losses"]),
                f"finite losses in epoch {rec['epoch']}")
        require(rec["cap_overflow"] == 0,
                f"no cap overflow in epoch {rec['epoch']}")
    for name, n in launches.items():
        # GCN's kernel, below; the feature mean: the cached path's layer 0
        if name in ("grouped_masked_sum", "gathered_feature_mean"):
            require(n == 0, f"the main path does not reach {name}")
        else:
            require(n > 0, f"the main path launched {name}")
    emit({"phase": "main_path",
          "graph": {"nodes": data.num_nodes, "edges": data.num_edges,
                    "features": data.feature_dim, "num_nodes_cut": None,
                    "gen_s": gen_s},
          "trainer_init_s": init_s, "caps": list(tr.caps),
          "eval_caps": list(tr.eval_caps),
          "epochs": [{"epoch": r["epoch"], "steps": r["steps"],
                      "losses": r["losses"], "cap_overflow": r["cap_overflow"],
                      "epoch_s": r["epoch_s"],
                      "ms_per_step": 1e3 * r["epoch_s"] / r["steps"],
                      "edges_per_s": r["edges_per_s"]} for r in epochs],
          "valid_acc": valid_acc, "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    # what the ogb_products phase holds its run to: the same Trainer's
    # launches per step, and its steady epoch beside its own
    main_rec = {"launches": launches, "caps": list(tr.caps),
                "steps": (sum(r["steps"] for r in epochs),
                          tr.plan.valid_steps),
                "ms_per_step": 1e3 * epochs[-1]["epoch_s"]
                / epochs[-1]["steps"],
                "edges_per_s": epochs[-1]["edges_per_s"]}
    # the same Trainer's captured steps against eager ones
    announce("graphed")
    by_path = {"main_path": launches,
               "graphed": graphed(kernels, smi, tr, data)["epoch_launches"]}
    del tr
    torch.cuda.empty_cache()
    # the benchmark's entry point on the same graph: its two variants in
    # this process, then its command line twice
    announce("bench")
    by_path.update(bench_phase(kernels, smi, data, main_rec))
    torch.cuda.empty_cache()
    # GCN at the same width on the same graph: bf16 (K1 "sqrt", K2 "sum")
    # and float32 (K5)
    for dtype in ("bfloat16", "float32"):
        announce(f"gcn_{dtype}")
        by_path[f"gcn_{dtype}"] = gcn_path(kernels, data, dtype)
        torch.cuda.empty_cache()
    # GAT (PyG's products example) on the same graph: its attention
    # kernels at layers 0 and 2, an epoch, and its launches a step
    announce("gat")
    gat = gat_path(kernels, data)
    by_path["gat"] = gat["launches"]
    torch.cuda.empty_cache()
    # the activation and dropout between layers at SAGE's and GAT's
    # layer-0 shapes
    announce("act_dropout")
    emit(check_act_dropout(results, main_rec["caps"][1], gat["caps"][2]))
    torch.cuda.empty_cache()
    # MeshTrainer at world size 1 through NCCL on the same graph, then on
    # the table striped over its one-rank cache group
    announce("mesh_dp")
    by_path["mesh_dp"], dp_losses, dp_ms = mesh_dp(kernels, results, data,
                                                   smi)
    torch.cuda.empty_cache()
    announce("mesh_striped (hbm_sharded)")
    sharded = mesh_sharded(kernels, data, dp_losses, dp_ms)
    torch.cuda.empty_cache()
    del data

    # -- 5. it learns, and agrees with the plain versions on a small input --
    announce("learn")
    data = random_power_law_graph(num_nodes=50_000, avg_degree=15,
                                  feature_dim=100, num_classes=CLASSES,
                                  seed=0)
    cfg = Config(dataset=DatasetConfig(num_classes=CLASSES),
                 sampler=SamplerConfig(fanouts=(25, 10), batch_size=1024),
                 model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2),
                 train=TrainConfig(epochs=2))
    tr = Trainer(cfg, data, device="cuda")
    res = tr.fit(log=stderr_log)
    valid_acc = tr.evaluate("valid")
    require(valid_acc > 0.15, f"validation accuracy {valid_acc} > 0.15")

    ref_err, scale = logits_vs_cpu(tr, cfg, data.valid_ids[:512], 1e-4)
    del tr
    # the cached driver on the same graph: host features, a budget of a
    # quarter of its float32 rows
    ccfg = Config(dataset=DatasetConfig(num_classes=CLASSES,
                                        feature_placement="host"),
                  sampler=SamplerConfig(fanouts=(25, 10), batch_size=1024,
                                        dedup_last=True),
                  model=ModelConfig(arch="sage", hidden_dim=256,
                                    num_layers=2),
                  train=TrainConfig(epochs=2),
                  cache=CacheConfig(enabled=True,
                                    budget_bytes=data.num_nodes // 4
                                    * data.feature_dim * 4))
    cres = run_cached_training(ccfg, data, "cuda", log=stderr_log)
    ch = cres["history"][-1]
    require(ch["valid"] > 0.15,
            f"cached validation accuracy {ch['valid']} > 0.15")
    require(0.0 < ch["cache_hit_rate"] < 1.0, "cached hit rate inside (0, 1)")
    emit({"phase": "learn", "valid_acc": valid_acc,
          "test_acc": res["test_acc"],
          "mean_loss": [h["mean_loss"] for h in res["history"]],
          "logits_vs_cpu_max_abs_err": ref_err, "logits_max_abs": scale,
          "cached": {"valid_acc": [h["valid"] for h in cres["history"]],
                     "test_acc": cres["test_acc"],
                     "feat_capacity": cres["cost"].feat_capacity,
                     "hit_rate": [h["cache_hit_rate"]
                                  for h in cres["history"]],
                     "host_gb": [h["host_gb"] for h in cres["history"]],
                     "staging_overflow": [h["staging_overflow"]
                                          for h in cres["history"]]}})
    del cres
    for phase, fn in (("gcn_learn", gcn_learns), ("lp_sage", lp_sage_path),
                      ("checkpoint_resume", checkpoint_resume),
                      ("hybrid_learn", hybrid_learns)):
        announce(phase)
        emit({"phase": phase, **fn(data)})
    del data
    torch.cuda.empty_cache()

    # -- 6. the cached path at papers100M class -----------------------------
    announce("cached_path")
    by_path["cached_path"], cached_ref = cached_path(kernels, results, dedups)
    torch.cuda.empty_cache()

    # -- 7. the dedup's kernel against its plain version ---------------------
    emit({"phase": "dedup", "nvidia_smi": smi, "cases": dedups})

    # -- 8. the host-topology path at uk-union class ------------------------
    announce("hybrid_path")
    by_path["hybrid_path"], hybrid_ref = hybrid_path(kernels, results)
    torch.cuda.empty_cache()

    # -- 20. the same cell with every adjacency run past edge 2^31 --------
    announce("bigcsr")
    by_path["bigcsr"] = bigcsr(kernels, results, smi, hybrid_ref)

    # -- 11. the cache-group paths at world size 1 (NCCL), each against its
    # single-device twin above, and 12. at cache axis 2 on two ranks
    # sharing the card
    announce("mesh_striped")
    by_path.update(mesh_striped(kernels, results, smi, sharded,
                                {"cached": cached_ref, "hybrid": hybrid_ref}))
    torch.cuda.empty_cache()
    announce("mesh_striped_k2")
    by_path.update(mesh_striped_k2(smi))

    # -- 13. the edge-partitioned path at world size 1 (NCCL) on phase 6's
    # graph, and 14. at two ranks sharing the card against one -----------
    announce("mesh_partitioned")
    by_path["mesh_partitioned"] = mesh_partitioned(kernels, results, smi,
                                                   cached_ref)
    torch.cuda.empty_cache()
    announce("mesh_partitioned_k2")
    by_path["mesh_partitioned_k2"] = mesh_partitioned_k2(smi)

    # -- 15. from an OGB dataset (the products stand-in) through conversion,
    # the harness and the command line --------------------------------------
    announce("ogb_products")
    by_path["ogb_products"] = ogb_products(kernels, results, smi, main_rec)
    torch.cuda.empty_cache()

    # -- 10. the command line, as a user runs it ----------------------------
    announce("cli")
    cli_runs(smi)
    announce("summary")

    print(smi, flush=True)
    # launches: the count on the SAGE main path (phase 4), for K5, which
    # SAGE does not reach, on the float32 GCN path, and for the gathered
    # feature mean on the cached path; launches_by_path holds every
    # full-width path's count, each taken with the counts set to 0 just
    # before the path ran and read just after
    home = {"grouped_masked_sum": "gcn_float32",
            "gathered_feature_mean": "cached_path"}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": tpu,
         "launches": by_path[home.get(name, "main_path")][name],
         "launches_by_path": {p: n[name] for p, n in by_path.items()},
         **{k: results[name][k] for k in KERNEL_KEYS}}
        for name, (_, tpu) in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
