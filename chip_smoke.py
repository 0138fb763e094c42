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
   bitwise at the batch's two hop shapes (beside its byte bound, the
   distinct 32-byte sectors its reads touch and their time at the memory
   peak), K3, K1 (also with GCN's "sqrt" norm), K2 forward and backward
   with every norm at SAGE's layer-1 shape in bf16 and at GCN float32's
   (the backward's zero fill, scatter kernel and cast pass timed apart)
   and K5 (``grouped_masked_sum``: float32 value and gradient on the
   batch's identity block, a bf16 case, and width 47 with a float mask);
   K3 and K5 are also timed beside the one PyTorch call that computes
   the same function (``index_select``, ``einsum``), and each kernel's
   time stands beside its bound: the larger of the bytes this batch
   makes it move over 3.35 TB/s and its operations over 67 TFLOP/s; then
   K2 on a tiny block with a position past its rows (NaN in exactly the
   plain version's rows, the slot dropped backward);
4. main path: two training epochs and a validation pass through the
   ``Trainer``; every kernel's launch count over that run must be > 0
   but K5's, which SAGE does not reach. Then GCN at the same width on
   the same graph, one epoch and a validation pass each in bf16 and in
   float32: finite losses, no cap overflow, one batch's logits against
   the plain versions on the CPU, and exact launch counts (bf16: K1 once
   per train and eval step, K2 forward once per step and backward once
   per train step, K5 never; float32: K5 once per train and eval step,
   K1 never);
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
   batch's layer-1 block at the path's width (172 columns, bf16).

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
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "legion_tpu_torch/csrc/legion_kernels.cu"

# bench_graph's full size (the ogbn-products stand-in) and its classes
NODES, CLASSES = 2_449_029, 47

# Published peaks of the H100 SXM (NVIDIA's data sheet) that the kernels'
# bounds are stated against: device memory, and float32 outside the
# tensor cores (none of these kernels holds a matrix product).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


# what the kernels line holds of each kernel, beside its launch counts
KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


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


def bound(nbytes, flops):
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory peak, or the operations
    at the float32 peak, whichever is larger."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_F32_FLOP_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(nbytes), "bound_flops": int(flops)}


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
    (frontier, uniforms), and both timed. Returns per-hop records, each
    with ``bound_ms`` (the useful bytes) and ``sector_ms`` (the distinct
    32-byte sectors those reads touch) at the memory peak."""
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
        slots, valid = u.numel(), int((k >= 0).sum())
        # frontier, uniforms and output once; an indptr pair per valid
        # node and one index per valid slot; ~3 operations per slot
        nbytes = (4 * fr.numel() + 8 * slots + 8 * int((fr >= 0).sum())
                  + 4 * valid)
        # The same reads in the 32-byte sectors device memory moves: the
        # distinct sectors of indptr (two entries a valid node) and of
        # indices (the drawn entry of each valid slot; eight int32 to a
        # sector), beside the coalesced frontier, uniforms and output.
        ids = fr[fr >= 0].long()
        start = graph.indptr[ids]
        deg = (graph.indptr[ids + 1] - start)[:, None]
        draw = torch.minimum((u[fr >= 0] * deg.float()).to(torch.int32),
                             (deg - 1).clamp(min=0))
        slot = torch.arange(f, dtype=torch.int32, device=fr.device)
        addr = (start[:, None].long() + draw)[(slot[None, :] < deg)
                                              & (deg > 0)]
        require(addr.numel() == valid, "one drawn entry per valid slot")
        sectors = (int(torch.unique(addr // 8).numel())
                   + int(torch.unique(torch.cat([ids, ids + 1]) // 8).numel()))
        sector_bytes = 32 * sectors + 4 * fr.numel() + 8 * slots
        del ids, start, deg, draw, addr
        out.append({"shape": list(u.shape), "valid_slots": valid,
                    **bound(nbytes, 3 * slots), "library_ms": None,
                    "sector_bytes": sector_bytes,
                    "sector_ms": 1e3 * sector_bytes / PEAK_BYTES_PER_S,
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
    round an f32 sum once). Returns the forward's and the backward's
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
        k = gathered_masked_mean(h_t, pos, mask, nm).float()
        pl = gathered_masked_mean_plain(h_t, pos, mask, nm).float()
        if low:
            tol = 8e-3 * pl.abs() + 1e-3
        else:
            tol = 1e-5 * gathered_masked_mean_plain(h_t.abs(), pos, mask, nm)
        require(bool(((k - pl).abs() <= tol).all()),
                f"{what}: forward, norm {nm}, within tolerance")
        fwd_err[nm] = float((k - pl).abs().max())
        g32 = g.float()
        kb = gathered_masked_mean_backward(g32, pos, mask, s, nm,
                                           torch.float32)
        pb = gathered_masked_mean_backward_plain(g32, pos, mask, s, nm,
                                                 torch.float32)
        mag = gathered_masked_mean_backward_plain(g32.abs(), pos, mask, s, nm,
                                                  torch.float32)
        require(bool(((kb - pb).abs() <= 1e-5 * mag).all()),
                f"{what}: backward, norm {nm}, within 1e-5 in f32")
        bwd_err[nm] = float((kb - pb).abs().max())
        if low:
            kl = gathered_masked_mean_backward(g, pos, mask, s, nm).float()
            require(bool(((kl - gathered_masked_mean_backward_plain(
                g, pos, mask, s, nm).float()).abs() <= 8e-3 * mag).all()),
                f"{what}: backward, norm {nm}, within 8e-3 in bf16")
        del k, pl, tol, g32, kb, pb, mag
    slots = int(mask.sum())
    rows = int(torch.unique(pos[mask]).numel())
    shape = {"shape": [p, f, s, d], "dtype": str(h_t.dtype).split(".")[-1],
             "norm": norm, "valid_slots": slots, "library_ms": None}
    # the distinct rows the valid slots name read once, positions and mask
    # read, the dst rows written; one add per gathered element
    fwd = {**shape,
           **bound(rows * d * es + 5 * mask.numel() + p * d * es, slots * d),
           "max_abs_err": fwd_err[norm], "max_abs_err_by_norm": fwd_err,
           "ms": time_ms(lambda: gathered_masked_mean(h_t, pos, mask, norm)),
           "plain_ms": time_ms(
               lambda: gathered_masked_mean_plain(h_t, pos, mask, norm))}
    ld = staging_width(d, h_t.dtype)    # float32: d itself, no cast pass
    staging = torch.zeros((s, ld), dtype=torch.float32, device=h_t.device)
    # the upstream gradient, positions and mask read, every src row of the
    # gradient written; one add per scattered element
    bwd = {**shape,
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

    def f32_close(k, pl, mag, what):
        require(bool(((k - pl).abs() <= 1e-5 * mag + 1e-30).all()),
                f"grouped_masked_sum {what} within 1e-5 of the magnitudes")
        return float((k - pl).abs().max())

    def bf16_close(k, pl, what):
        k, pl = k.float(), pl.float()
        require(float(((k - pl).abs() - (8e-3 * pl.abs() + 1e-3)).max()) <= 0,
                f"grouped_masked_sum {what} within bf16 tolerance")
        return float((k - pl).abs().max())

    rec = {"shape": [p, f, d]}
    k, pl = grouped_masked_sum(x2, mask, f), grouped_masked_sum_plain(
        x2, mask, f)
    rec["max_abs_err"] = f32_close(
        k, pl, grouped_masked_sum_plain(x2.abs(), mask, f), "forward")
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
    rec["bf16_max_abs_err"] = bf16_close(
        grouped_masked_sum(xb, mask, f),
        grouped_masked_sum_plain(xb, mask, f), "bf16")
    # width 47 and float weights: no 16-byte loads, a multiply per slot
    xo = x2[:, :47].contiguous()
    wm = mask * (0.5 + torch.rand(mask.shape, generator=gen,
                                  device=x.device))
    rec["odd_f32_max_abs_err"] = f32_close(
        grouped_masked_sum(xo, wm, f), grouped_masked_sum_plain(xo, wm, f),
        grouped_masked_sum_plain(xo.abs(), wm, f), "at width 47")
    xob = xo.to(torch.bfloat16)[1:-(f - 1)]     # a 2-byte-aligned start
    rec["odd_bf16_max_abs_err"] = bf16_close(
        grouped_masked_sum(xob, wm[:-1], f),
        grouped_masked_sum_plain(xob, wm[:-1], f), "bf16 at width 47")
    del xb, xo, xob
    mf = mask.to(x2.dtype)
    x3 = x2.view(p, f, d)
    lib = torch.einsum("pfd,pf->pd", x3, mf)
    rec["library_max_abs_err"] = float((lib - pl).abs().max())
    del lib, k, pl
    rec.update(
        bound(x2.numel() * x2.element_size() + mask.numel()
              + p * d * x2.element_size(), 2 * x2.numel()),
        ms=time_ms(lambda: grouped_masked_sum(x2, mask, f)),
        plain_ms=time_ms(lambda: grouped_masked_sum_plain(x2, mask, f)),
        library_ms=time_ms(lambda: torch.einsum("pfd,pf->pd", x3, mf)))
    return rec


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
            "gathered_masked_mean_backward": (t, 0)}
    for name, (nt, ne) in want.items():
        require((train_launches[name], eval_launches[name]) == (nt, ne),
                f"GCN {dtype} launched {name} {nt} times in {t} train steps "
                f"and {ne} in {e} eval steps, got {train_launches[name]} and "
                f"{eval_launches[name]}")
    err, scale = logits_vs_cpu(tr, cfg, data.valid_ids[:512],
                               3e-2 if bf16 else 1e-4)
    launches = {k: train_launches[k] + eval_launches[k] for k in kernels}
    emit({"phase": f"gcn_{dtype}", "trainer_init_s": init_s,
          "caps": list(tr.caps), "steps": t, "eval_steps": e,
          "losses": rec["losses"], "cap_overflow": rec["cap_overflow"],
          "ms_per_step": 1e3 * rec["epoch_s"] / t,
          "edges_per_s": rec["edges_per_s"], "valid_acc": valid_acc,
          "train_launches": train_launches, "eval_launches": eval_launches,
          "logits_vs_cpu_max_abs_err": err, "logits_max_abs": scale,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches


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
          "peak_mem_gb": peak,
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
    from legion_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean_plain, identity_masked_mean,
        identity_masked_mean_plain)
    from legion_tpu_torch.sampling.sampler import sample_batch
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
        {k: hops[-1][k] for k in KERNEL_KEYS}, main_path_hops=hops)
    blk0, blk1 = reversed(batch.blocks)        # model order
    require(blk0.identity_offset is not None, "layer 0's block is identity")
    table, ids = tr.features, batch.frontier
    k3 = gather_rows(table, ids)
    p3 = gather_rows_plain(table, ids)
    require(torch.equal(k3, p3), "gather_rows is bitwise its plain version")
    # each distinct valid row read once (the identity-appended frontier
    # repeats ids), every output row written once
    row_bytes = table.shape[1] * table.element_size()
    distinct = int(torch.unique(ids[ids >= 0]).numel())
    idx = ids.clamp(min=0).long()       # index_select zeroes no -1 row
    results["gather_rows"].update(
        bound(4 * ids.numel() + (distinct + ids.numel()) * row_bytes, 0),
        max_abs_err=float((k3 - p3).abs().max()),
        ms=time_ms(lambda: gather_rows(table, ids)),
        plain_ms=time_ms(lambda: gather_rows_plain(table, ids)),
        library_ms=time_ms(lambda: torch.index_select(table, 0, idx)))
    del p3, idx

    def bf16_err(k, p, what):
        """Within 1 bf16 ulp relative (8e-3) plus 1e-3 absolute: kernel
        and plain version sum in f32 in different orders, which can flip
        one bf16 rounding."""
        k, p = k.float(), p.float()
        excess = ((k - p).abs() - (8e-3 * p.abs() + 1e-3)).max()
        require(float(excess) <= 0, f"{what} within bf16 tolerance")
        return float((k - p).abs().max())

    x, m1, off = k3, blk0.nbr_mask, blk0.identity_offset
    d1, slots1 = x.shape[1], int(m1.sum())
    # masked slots are skipped: the valid slots' rows and the mask are
    # read, the bf16 rows written; one add per element read
    results["identity_masked_mean"].update(
        bound(slots1 * d1 * x.element_size() + m1.numel()
              + m1.shape[0] * d1 * 2, slots1 * d1),
        library_ms=None,
        sqrt_max_abs_err=bf16_err(       # GCN's norm
            identity_masked_mean(x, m1, off, "sqrt", torch.bfloat16),
            identity_masked_mean_plain(x, m1, off, "sqrt", torch.bfloat16),
            "identity_masked_mean with norm sqrt"),
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
    agg = gathered_masked_mean_plain(h_t.requires_grad_(True), pos, m0)
    logits = layer1._dense(layer1.fc_self, h[: blk1.dst_cap]).detach() + agg
    loss = masked_softmax_ce(logits[: batch.seed_cap], batch.labels,
                             batch.seed_mask())
    (gd,) = torch.autograd.grad(loss, agg)     # bf16, as the step's backward
    gd, h_t = gd.contiguous(), h_t.detach()
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
    emit({"phase": "kernels", "caps": list(tr.caps),
          "shapes": {"table": list(table.shape), "ids": ids.shape[0],
                     "identity": [*m1.shape, x.shape[1], off],
                     "gathered": [*m0.shape, *h_t.shape]},
          "k2_fill": fill, "results": results})
    del (batch, blk0, blk1, x, k3, m1, h, h_t, pos, m0, agg, logits, loss,
         gd)
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
        if name == "grouped_masked_sum":     # GCN's kernel, below
            require(n == 0, "SAGE does not reach grouped_masked_sum")
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
    del tr
    torch.cuda.empty_cache()
    # GCN at the same width on the same graph: bf16 (K1 "sqrt", K2 "sum")
    # and float32 (K5)
    by_path = {"main_path": launches}
    for dtype in ("bfloat16", "float32"):
        by_path[f"gcn_{dtype}"] = gcn_path(kernels, data, dtype)
        torch.cuda.empty_cache()
    del data

    # -- 5. it learns, and agrees with the plain versions on a small input --
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
    emit({"phase": "gcn_learn", **gcn_learns(data)})
    emit({"phase": "lp_sage", **lp_sage_path(data)})
    emit({"phase": "checkpoint_resume", **checkpoint_resume(data)})
    del data
    torch.cuda.empty_cache()

    # -- 6. the cached path at papers100M class -----------------------------
    cached_path(kernels, results)

    print(smi, flush=True)
    # launches: the count on the SAGE main path (phase 4), and for K5, which
    # SAGE does not reach, on the float32 GCN path; launches_by_path holds
    # every full-width path's count
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": tpu,
         "launches": by_path["gcn_float32" if name == "grouped_masked_sum"
                             else "main_path"][name],
         "launches_by_path": {p: n[name] for p, n in by_path.items()},
         **{k: results[name][k] for k in KERNEL_KEYS}}
        for name, (_, tpu) in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
