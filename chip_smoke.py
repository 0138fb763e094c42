#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (legion_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

It imports only torch and legion_tpu_torch. It builds the port's CUDA
kernels from csrc/ with nvcc, then runs these phases, printing one JSON
line for each but the set-up; any failure raises and the script exits
non-zero:

1. toolchain: torch and CUDA versions, the card, nvcc, the kernel build;
2. set-up: the full-size products-scale synthetic graph and a
   ``Trainer`` with bench.py's configuration (SAGE-256, bf16, fanout
   [25,10], batch 8000), which probes its frontier caps;
3. kernels: one batch sampled at those caps, and each CUDA kernel held
   against its plain PyTorch version on the tensors that batch's step
   gives it, with the error against a stated tolerance and the median
   time of both (CUDA events, 20 reps after warm-up): the sampling kernel
   bitwise at the batch's two hop shapes, K3, K1, K2 forward and
   backward; then K2 on a tiny block with a position past its rows
   (NaN in exactly the plain version's rows, the slot dropped backward);
4. main path: two training epochs and a validation pass through the
   ``Trainer``; every kernel's launch count over that run must be > 0;
5. learning: the reference's verify recipe (50k-node planted-label
   graph, 2 epochs) must reach validation accuracy > 0.15 (7x chance),
   one batch's logits from the kernels must match the plain versions on
   the CPU, and the cached driver on the same graph, with a budget that
   caches a quarter of its rows, must reach > 0.15 as well;
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
   and K3 must have launched, and the sampling kernel must be bitwise its
   plain version on the path's hop-1 and hop-2 inputs.

Then it prints the card's name and power limit as nvidia-smi reports
them, a JSON line with every kernel's numbers, and, last,
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
at once and prints no result.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "legion_tpu_torch/csrc/legion_kernels.cu"

# bench_graph's full size (the ogbn-products stand-in) and its classes
NODES, CLASSES = 2_449_029, 47


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=20, warmup=3, trials=5):
    """Device time of one fn() call in ms: the median over trials of a
    CUDA event pair around reps back-to-back calls, divided by reps. Each
    trial first parks the stream in a ~10 ms device sleep so the host can
    queue all reps before the device starts, so host launch overhead
    (tens of us per call, more than the smallest kernels take) does not
    count as device time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)             # cycles, ~10 ms
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def kernel_table():
    """name -> (wrapper holding the launch count, TPU kernel it replaces)."""
    from legion_tpu_torch.ops.gather import gather_rows
    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean, gathered_masked_mean_backward,
        identity_masked_mean)
    from legion_tpu_torch.ops.sample import sample_neighbors
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

    from legion_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "toolchain", "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "nvcc": nvcc, "kernel_build_s": time.perf_counter() - t0,
          "library_was_prebuilt": prebuilt})
    return smi


def check_sampling_kernel(graph, frontiers, fanouts, seed):
    """The sampling kernel bitwise against its plain version on each hop's
    (frontier, uniforms), and both timed. Returns per-hop records."""
    import torch

    from legion_tpu_torch.ops.sample import (sample_neighbors,
                                             sample_neighbors_plain)
    gen = torch.Generator(device=graph.indptr.device).manual_seed(seed)
    out = []
    for fr, f in zip(frontiers, fanouts):
        u = torch.rand((fr.shape[0], f), generator=gen,
                       device=fr.device, dtype=torch.float32)
        args = (graph.indptr, graph.indices, fr, u)
        k, p = sample_neighbors(*args), sample_neighbors_plain(*args)
        require(torch.equal(k, p), f"sample_neighbors at {tuple(u.shape)} "
                "is bitwise its plain version")
        out.append({"shape": list(u.shape),
                    "valid_slots": int((k >= 0).sum()),
                    "max_abs_err": float((k - p).abs().max()),
                    "ms": time_ms(lambda: sample_neighbors(*args)),
                    "plain_ms": time_ms(
                        lambda: sample_neighbors_plain(*args))})
    return out


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
    require(bool(((k[ok].float() - pl[ok].float()).abs()
                  <= 8e-3 * pl[ok].float().abs() + 1e-3).all()),
            "K2 forward's finite rows within bf16 tolerance")
    g = torch.randn((p, d), generator=gen, device=dev)
    kb = gathered_masked_mean_backward(g, pos, mask, s, "mean", torch.float32)
    pb = gathered_masked_mean_backward_plain(g, pos, mask, s, "mean",
                                             torch.float32)
    mag = gathered_masked_mean_backward_plain(g.abs(), pos, mask, s, "mean",
                                              torch.float32)
    require(bool(torch.isfinite(kb).all())
            and bool(((kb - pb).abs() <= 1e-5 * mag).all()),
            "K2 backward drops the slots past the rows as its plain version")
    return {"nan_rows": nan_rows, "finite_rows": int(ok.sum()),
            "bwd_max_abs_err": float((kb - pb).abs().max())}


def cached_path(kernels, results):
    """Phase 6: the cached host-feature path at papers100M class."""
    import torch

    from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
    from legion_tpu_torch.tools import pa_cell
    from legion_tpu_torch.train.cached_driver import run_cached_training
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
                 "gathered_masked_mean_backward", "gather_rows"):
        require(launches[name] > 0, f"the cached path launched {name}")
    cost = {k: getattr(res["cost"], k) for k in (
        "feat_capacity", "topo_capacity", "alpha", "saved_feat_bytes")}
    del res

    # one batch at the path's caps: ids past 2^24, and the sampling
    # kernel on its hop-1 and hop-2 inputs
    caps = tuple(h["caps"])
    graph = DeviceGraph.from_host(data.indptr, data.indices, "cuda")
    dev = torch.device("cuda")
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
          "sample_neighbors_hops": hops, "peak_mem_gb": peak,
          "cost_model": cost})


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)

    from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                         ModelConfig, SamplerConfig,
                                         TrainConfig)
    from legion_tpu_torch.data.synthetic import (bench_graph,
                                                 random_power_law_graph)
    from legion_tpu_torch.models import build_model
    from legion_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean, gathered_masked_mean_backward,
        gathered_masked_mean_backward_plain, gathered_masked_mean_plain,
        identity_masked_mean, identity_masked_mean_plain)
    from legion_tpu_torch.sampling.block import Block
    from legion_tpu_torch.sampling.sampler import (gather_features,
                                                   sample_batch)
    from legion_tpu_torch.train.cached_driver import run_cached_training
    from legion_tpu_torch.train.loop import Trainer, masked_softmax_ce

    # float32 products in full float32, as the CPU reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = kernel_table()
    results = {name: {} for name in kernels}

    # -- 1. toolchain and card ------------------------------------------------
    smi = toolchain()

    # -- 2. the main path's set-up: data and Trainer (which probes caps) ---
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
        {k: hops[-1][k] for k in ("max_abs_err", "ms", "plain_ms")},
        main_path_hops=hops)
    blk0, blk1 = reversed(batch.blocks)        # model order
    require(blk0.identity_offset is not None, "layer 0's block is identity")
    table, ids = tr.features, batch.frontier
    k3 = gather_rows(table, ids)
    p3 = gather_rows_plain(table, ids)
    require(torch.equal(k3, p3), "gather_rows is bitwise its plain version")
    results["gather_rows"].update(
        max_abs_err=float((k3 - p3).abs().max()),
        ms=time_ms(lambda: gather_rows(table, ids)),
        plain_ms=time_ms(lambda: gather_rows_plain(table, ids)))
    del p3

    def bf16_err(k, p, what):
        """Within 1 bf16 ulp relative (8e-3) plus 1e-3 absolute: kernel
        and plain version sum in f32 in different orders, which can flip
        one bf16 rounding."""
        k, p = k.float(), p.float()
        excess = ((k - p).abs() - (8e-3 * p.abs() + 1e-3)).max()
        require(float(excess) <= 0, f"{what} within bf16 tolerance")
        return float((k - p).abs().max())

    x, m1, off = k3, blk0.nbr_mask, blk0.identity_offset
    results["identity_masked_mean"].update(
        max_abs_err=bf16_err(
            identity_masked_mean(x, m1, off, "mean", torch.bfloat16),
            identity_masked_mean_plain(x, m1, off, "mean", torch.bfloat16),
            "identity_masked_mean"),
        ms=time_ms(lambda: identity_masked_mean(x, m1, off)),
        plain_ms=time_ms(lambda: identity_masked_mean_plain(x, m1, off)))

    layer0, layer1 = tr.model.layers
    pos, m0 = blk1.nbr_pos, blk1.nbr_mask
    with torch.no_grad():
        h = torch.relu(layer0(blk0, x))
        h_t = layer1._dense(layer1.fc_neigh, h)
    results["gathered_masked_mean"].update(
        max_abs_err=bf16_err(gathered_masked_mean(h_t, pos, m0),
                             gathered_masked_mean_plain(h_t, pos, m0),
                             "gathered_masked_mean"),
        ms=time_ms(lambda: gathered_masked_mean(h_t, pos, m0)),
        plain_ms=time_ms(lambda: gathered_masked_mean_plain(h_t, pos, m0)))

    agg = gathered_masked_mean_plain(h_t.requires_grad_(True), pos, m0)
    logits = layer1._dense(layer1.fc_self, h[: blk1.dst_cap]).detach() + agg
    loss = masked_softmax_ce(logits[: batch.seed_cap], batch.labels,
                             batch.seed_mask())
    (gd,) = torch.autograd.grad(loss, agg)     # bf16, as the step's backward
    gd, s = gd.contiguous(), h_t.shape[0]
    # f32: within 1e-5 of the sum of the magnitudes of the terms scattered
    # into each element (atomics add in any order)
    kb = gathered_masked_mean_backward(gd.float(), pos, m0, s, "mean",
                                       torch.float32)
    pb = gathered_masked_mean_backward_plain(gd.float(), pos, m0, s, "mean",
                                             torch.float32)
    mag = gathered_masked_mean_backward_plain(gd.float().abs(), pos, m0, s,
                                              "mean", torch.float32)
    require(bool(((kb - pb).abs() <= 1e-5 * mag).all()),
            "gathered_masked_mean_backward within 1e-5 relative in f32")
    # bf16 out, as the step runs it: both sides round an f32 sum once, so
    # they differ by at most 2 bf16 half-ulps of that magnitude
    require(bool(((gathered_masked_mean_backward(gd, pos, m0, s).float()
                   - gathered_masked_mean_backward_plain(gd, pos, m0, s)
                   .float()).abs() <= 8e-3 * mag).all()),
            "gathered_masked_mean_backward within 8e-3 relative in bf16")
    results["gathered_masked_mean_backward"].update(
        max_abs_err=float((kb - pb).abs().max()),
        ms=time_ms(lambda: gathered_masked_mean_backward(gd, pos, m0, s)),
        plain_ms=time_ms(
            lambda: gathered_masked_mean_backward_plain(gd, pos, m0, s)))
    fill = k2_fill_case()
    emit({"phase": "kernels", "caps": list(tr.caps),
          "shapes": {"table": list(table.shape), "ids": ids.shape[0],
                     "identity": [*m1.shape, x.shape[1], off],
                     "gathered": [*m0.shape, *h_t.shape]},
          "k2_fill": fill, "results": results})
    del (batch, blk0, blk1, x, k3, m1, h, h_t, pos, m0, agg, logits, loss,
         gd, kb, pb, mag)
    torch.cuda.empty_cache()

    # -- 4. the main path at full width ------------------------------------
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
    del tr, data
    torch.cuda.empty_cache()

    # -- 5. it learns, and agrees with the plain versions on a small input --
    data = random_power_law_graph(num_nodes=50_000, avg_degree=15,
                                  feature_dim=100, num_classes=CLASSES,
                                  seed=0)
    cfg = Config(dataset=DatasetConfig(num_classes=CLASSES),
                 sampler=SamplerConfig(fanouts=(25, 10), batch_size=1024),
                 model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2),
                 train=TrainConfig(epochs=2))
    tr = Trainer(cfg, data, device="cuda")
    res = tr.fit(log=lambda s: print(s, file=sys.stderr, flush=True))
    valid_acc = tr.evaluate("valid")
    require(valid_acc > 0.15, f"validation accuracy {valid_acc} > 0.15")

    seeds = torch.from_numpy(data.valid_ids[:512].copy()).to(dev)
    batch = sample_batch(tr.graph, seeds,
                         torch.tensor(512, dtype=torch.int32, device=dev),
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
    out = out.cpu()
    require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
            "finite logits of the reference's shape")
    scale = float(ref.abs().max())
    ref_err = float((out - ref).abs().max())
    require(ref_err <= 1e-4 * scale,
            f"CUDA logits within 1e-4 x max|logit| of the CPU plain path "
            f"({ref_err} vs {scale})")
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
    cres = run_cached_training(ccfg, data, "cuda",
                               log=lambda s: print(s, file=sys.stderr,
                                                   flush=True))
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
    del cres, data
    torch.cuda.empty_cache()

    # -- 6. the cached path at papers100M class -----------------------------
    cached_path(kernels, results)

    print(smi, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": tpu,
         "launches": launches[name],
         **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms")}}
        for name, (_, tpu) in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
