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
   time of both (CUDA events, 20 reps after warm-up);
4. main path: two training epochs and a validation pass through the
   ``Trainer``; every kernel's launch count over that run must be > 0;
5. learning: the reference's verify recipe (50k-node planted-label
   graph, 2 epochs) must reach validation accuracy > 0.15 (7x chance),
   and one batch's logits from the kernels must match the plain versions
   on the CPU.

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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)

    from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                         SamplerConfig, TrainConfig)
    from legion_tpu_torch.data.synthetic import (bench_graph,
                                                 random_power_law_graph)
    from legion_tpu_torch.models import build_model
    from legion_tpu_torch.ops import _build
    from legion_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean, gathered_masked_mean_backward,
        gathered_masked_mean_backward_plain, gathered_masked_mean_plain,
        identity_masked_mean, identity_masked_mean_plain)
    from legion_tpu_torch.sampling.block import Block
    from legion_tpu_torch.sampling.sampler import (gather_features,
                                                   sample_batch)
    from legion_tpu_torch.train.loop import Trainer, masked_softmax_ce

    # float32 products in full float32, as the CPU reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {  # name -> (wrapper holding the launch count, TPU kernel)
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
    }
    results = {name: {} for name in kernels}

    # -- 1. toolchain and card ------------------------------------------------
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
    # caps, and the tensors the step hands each kernel: the frontier ids
    # (K3), the gathered features and identity block (K1), layer 1's
    # transformed activations and gathered block (K2 forward) and the
    # gradient of the step's loss at layer 1's aggregate (K2 backward).
    # Dropout is off so that the gradient is a function of the inputs.
    b = cfg.sampler.batch_size
    seed_ids = data.train_ids[:b].copy()
    batch = sample_batch(
        tr.graph, torch.from_numpy(seed_ids).to(dev),
        torch.tensor(b, dtype=torch.int32, device=dev),
        torch.from_numpy(data.labels[seed_ids]).to(dev), cfg.sampler.fanouts,
        tr.caps, dedup_last=cfg.sampler.dedup_last,
        generator=torch.Generator(device=dev).manual_seed(0))
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
    emit({"phase": "kernels", "caps": list(tr.caps),
          "shapes": {"table": list(table.shape), "ids": ids.shape[0],
                     "identity": [*m1.shape, x.shape[1], off],
                     "gathered": [*m0.shape, *h_t.shape]},
          "results": results})
    del (batch, blk0, blk1, x, k3, m1, h, h_t, pos, m0, agg, logits, loss,
         gd, kb, pb, mag)
    torch.cuda.empty_cache()

    # -- 4. the main path at full width ------------------------------------
    for fn, _ in kernels.values():
        fn.launches = 0
    epochs = [tr.train_one_epoch(e) for e in range(2)]
    valid_acc = tr.evaluate("valid")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
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
    emit({"phase": "learn", "valid_acc": valid_acc,
          "test_acc": res["test_acc"],
          "mean_loss": [h["mean_loss"] for h in res["history"]],
          "logits_vs_cpu_max_abs_err": ref_err, "logits_max_abs": scale})

    print(smi, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": tpu,
         "launches": launches[name], **results[name]}
        for name, (_, tpu) in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
