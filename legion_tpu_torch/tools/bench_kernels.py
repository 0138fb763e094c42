"""The on-card gate: every CUDA kernel of the port built, launched and held
against its plain PyTorch version (counterpart of ``tools/bench_kernels.py``).

The CPU tests reach only the plain versions, so a kernel that stops
building or computes wrong on the card would pass them. This gate calls
each of the six wrappers that ``chip_smoke.py`` counts on seeded tensors
at the JAX gate's shapes, holds it against its plain version with the
kernel's tolerance (the ``compare_*`` functions below), and requires the
wrapper's launch count to rise (a CUDA tensor never takes the plain version).

    python -m legion_tpu_torch.tools.bench_kernels           # timed
    python -m legion_tpu_torch.tools.bench_kernels --quick   # untimed

It prints one line per check and a final JSON summary, and exits non-zero
on a mismatch. ``legion_tpu_torch.bench`` runs it with ``quick=True``.
It builds its tensors on the card and raises where there is none:
nothing passes on the CPU.

The module also holds what ``chip_smoke.py`` shares with the gate: the
``compare_*`` functions, one per kernel, each holding a wrapper against
its plain version with the kernel's stated tolerance (the gate calls them
at the JAX gate's shapes, the smoke at the main path's), ``time_ms``
(CUDA events) and ``bound`` (the H100's data-sheet peaks).
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

# Published peaks of the H100 SXM (NVIDIA's data sheet) that the kernels'
# bounds are stated against: device memory, and float32 outside the
# tensor cores (none of these kernels holds a matrix product).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# what ``time_ms(cold=True)`` writes before each call: over twice the
# H100's 50 MB L2
FLUSH_BYTES = 128 << 20


def time_ms(fn, reps=20, warmup=3, trials=5, cold=False):
    """Device time of one fn() call in ms: the median over trials of a
    CUDA event pair around reps back-to-back calls, divided by reps. Each
    trial first parks the stream in a ~10 ms device sleep so the host can
    queue all reps before the device starts, so host launch overhead
    (tens of us per call, more than the smallest kernels take) does not
    count as device time.

    With ``cold`` the L2 holds none of fn's data when it starts, as in a
    training step, where the kernels between two calls move far more than
    the L2's 50 MB: before each call a scratch buffer of ``FLUSH_BYTES``
    is written, and each call has its own event pair, after the write; a
    trial's time is the mean of its reps pairs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    scratch = (torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                           device="cuda") if cold else None)
    times = []
    for _ in range(trials):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(reps if cold else 1)]
        torch.cuda._sleep(20_000_000)             # cycles, ~10 ms
        if cold:
            for start, end in pairs:
                scratch.zero_()
                start.record()
                fn()
                end.record()
        else:
            pairs[0][0].record()
            for _ in range(reps):
                fn()
            pairs[0][1].record()
        pairs[-1][1].synchronize()
        times.append(sum(s.elapsed_time(e) for s, e in pairs) / reps)
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


def within_bf16(k: torch.Tensor, p: torch.Tensor) -> bool:
    """Within 1 bf16 ulp relative (8e-3) plus 1e-3: two f32 sums in
    different orders can flip one bf16 rounding."""
    k, p = k.float(), p.float()
    return bool(((k - p).abs() <= 8e-3 * p.abs() + 1e-3).all())


def within_f32(k: torch.Tensor, p: torch.Tensor, mag: torch.Tensor,
               rel: float = 1e-5) -> bool:
    """Within ``rel`` of the summed magnitudes (``mag``: the plain version
    on the absolute values): the same f32 sum in another order."""
    return bool(((k.float() - p.float()).abs() <= rel * mag.float()
                 + 1e-30).all())


class Compared(NamedTuple):
    """A kernel held against its plain version on one input."""
    ok: bool              # within the kernel's stated tolerance
    max_abs_err: float    # largest |kernel - plain| over the output
    out: torch.Tensor     # the kernel's result


def _compared(ok: bool, k: torch.Tensor, p: torch.Tensor) -> Compared:
    return Compared(bool(ok), float((k.float() - p.float()).abs().max()), k)


def compare_identity_mean(x, mask, off, norm="mean",
                          out=torch.bfloat16) -> Compared:
    """K1 on the identity block (mask (P, f) over the rows past ``off``):
    bf16 out within one flipped rounding, float32 within 1e-5 of the
    summed magnitudes."""
    from legion_tpu_torch.ops.identity_agg import (identity_masked_mean,
                                                   identity_masked_mean_plain)
    k = identity_masked_mean(x, mask, off, norm, out)
    p = identity_masked_mean_plain(x, mask, off, norm, out)
    if out == torch.bfloat16:
        return _compared(within_bf16(k, p), k, p)
    return _compared(within_f32(k, p, identity_masked_mean_plain(
        x.abs(), mask, off, norm, out)), k, p)


def compare_k2_forward(h_t, pos, mask, norm="mean") -> Compared:
    """K2's forward over the rows of h_t (S, D) that pos and mask (P, f)
    name: bf16 within one flipped rounding, float32 within 1e-5 of the
    summed magnitudes."""
    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean, gathered_masked_mean_plain)
    k = gathered_masked_mean(h_t, pos, mask, norm)
    p = gathered_masked_mean_plain(h_t, pos, mask, norm)
    if h_t.dtype == torch.bfloat16:
        return _compared(within_bf16(k, p), k, p)
    return _compared(within_f32(k, p, gathered_masked_mean_plain(
        h_t.abs(), pos, mask, norm)), k, p)


def compare_k2_backward(g, pos, mask, num_rows, norm="mean",
                        dtype=None) -> Compared:
    """K2's backward, the upstream gradient g (P, D) scattered to
    ``num_rows`` rows in ``dtype`` (None: g's type, as the step runs it):
    float32 within 1e-5 of the summed magnitudes of the terms scattered
    into each element (atomics add in any order), bf16 within 8e-3 of
    them (both sides round an f32 sum once)."""
    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean_backward, gathered_masked_mean_backward_plain)
    k = gathered_masked_mean_backward(g, pos, mask, num_rows, norm, dtype)
    p = gathered_masked_mean_backward_plain(g, pos, mask, num_rows, norm,
                                            dtype)
    mag = gathered_masked_mean_backward_plain(
        g.float().abs(), pos, mask, num_rows, norm, torch.float32)
    rel = 1e-5 if k.dtype == torch.float32 else 8e-3
    return _compared(within_f32(k, p, mag, rel), k, p)


def compare_gather_rows(table, ids) -> Compared:
    """K3, rows of ``table`` by id (-1: a zero row), bitwise."""
    from legion_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    k, p = gather_rows(table, ids), gather_rows_plain(table, ids)
    return _compared(torch.equal(k, p), k, p)


def compare_sample(indptr, indices, frontier, u) -> Compared:
    """The sampling kernel's draws, bitwise."""
    from legion_tpu_torch.ops.sample import (sample_neighbors,
                                             sample_neighbors_plain)
    k = sample_neighbors(indptr, indices, frontier, u)
    p = sample_neighbors_plain(indptr, indices, frontier, u)
    return _compared(torch.equal(k, p), k, p)


def compare_grouped_sum(x2, mask, f) -> Compared:
    """K5, sums over groups of ``f`` rows of x2 under a bool or float mask
    (P, f): float32 within 1e-5 of the summed magnitudes, bf16 within one
    flipped rounding."""
    from legion_tpu_torch.ops.spmm import (grouped_masked_sum,
                                           grouped_masked_sum_plain)
    k = grouped_masked_sum(x2, mask, f)
    p = grouped_masked_sum_plain(x2, mask, f)
    if x2.dtype == torch.bfloat16:
        return _compared(within_bf16(k, p), k, p)
    return _compared(within_f32(k, p, grouped_masked_sum_plain(
        x2.abs(), mask, f)), k, p)


def run_gate(quick: bool = False,
             log: Callable[[str], None] = print) -> Dict:
    """Build, launch and check every kernel of the port on the card.

    quick=True skips the timing (``ms`` None): build and check only, as
    the bench runs it. Returns {"kernels": [{"kernel", "ok", "ms"}],
    "failures": [names]}; a check fails when the kernel disagrees with
    its plain version (the ``compare_*`` rules, which ``chip_smoke.py``
    applies at the main path's shapes) or its wrapper did not launch it.
    Raises where no CUDA device exists."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel gate needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    from legion_tpu_torch.ops.gather import gather_rows as k3
    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean as k2)
    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean_backward as k2_bwd)
    from legion_tpu_torch.ops.identity_agg import (
        gathered_masked_mean_backward_plain)
    from legion_tpu_torch.ops.identity_agg import identity_masked_mean as k1
    from legion_tpu_torch.ops.sample import sample_neighbors as k4
    from legion_tpu_torch.ops.spmm import grouped_masked_sum as k5
    from legion_tpu_torch.tools.k4_bench import ragged_cases
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results: List[Dict] = []
    failures: List[str] = []

    def check(name: str, wrapper, run: Callable[[], bool],
              timed: Optional[Callable[[], object]]) -> None:
        before = wrapper.launches
        ok = run()
        torch.cuda.synchronize()
        ok = bool(ok) and wrapper.launches > before
        ms = None if quick or timed is None else time_ms(timed)
        results.append({"kernel": name, "ok": ok, "ms": ms})
        tm = "built and checked (untimed)" if ms is None else f"{ms:8.4f} ms"
        log(f"{name:44s} {'OK ' if ok else 'FAIL'} {tm}")
        if not ok:
            failures.append(name)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- K1: identity_masked_mean, f32 in, bf16 and f32 out, every norm --
    p, f, d, off = 8192, 10, 128, 1024
    x = cuda(rng.standard_normal((off + p * f, d)).astype(np.float32))
    mask_np = rng.random((p, f)) > 0.2
    mask_np[7] = False
    mask = cuda(mask_np)
    for norm in ("mean", "sqrt", "sum"):
        for out in (torch.bfloat16, torch.float32):
            check(f"identity_masked_mean[f32,{norm},"
                  f"{str(out).split('.')[-1]}]", k1,
                  lambda norm=norm, out=out: compare_identity_mean(
                      x, mask, off, norm, out).ok,
                  lambda norm=norm, out=out: k1(x, mask, off, norm, out))
    xb = x.to(torch.bfloat16)
    check("identity_masked_mean[bf16,mean,bfloat16]", k1,
          lambda: compare_identity_mean(xb, mask, off).ok,
          lambda: k1(xb, mask, off))
    del xb

    # ---- K2: gathered_masked_mean over S rows of 100 columns, and its
    # backward ------------------------------------------------------------
    s = 4096
    h = cuda(rng.standard_normal((s, 100)).astype(np.float32))
    pos = cuda(np.where(mask_np, rng.integers(0, s, (p, f)), 0).astype(
        np.int32))
    hb = h.to(torch.bfloat16)
    g = cuda(rng.standard_normal((p, 100)).astype(np.float32))
    gb = g.to(torch.bfloat16)
    for norm in ("mean", "sqrt", "sum"):
        check(f"gathered_masked_mean[bfloat16,{norm}]", k2,
              lambda norm=norm: compare_k2_forward(hb, pos, mask, norm).ok,
              lambda norm=norm: k2(hb, pos, mask, norm))
        check(f"gathered_masked_mean_backward[float32,{norm}]", k2_bwd,
              lambda norm=norm: compare_k2_backward(
                  g, pos, mask, s, norm, torch.float32).ok,
              lambda norm=norm: k2_bwd(g, pos, mask, s, norm, torch.float32))
        check(f"gathered_masked_mean_backward[bfloat16,{norm}]", k2_bwd,
              lambda norm=norm: compare_k2_backward(
                  gb, pos, mask, s, norm).ok,
              lambda norm=norm: k2_bwd(gb, pos, mask, s, norm))
    # through autograd, as the train step reaches the backward: the
    # gradient of sum(out * w) is the backward of w in out's type, held
    # to compare_k2_backward's bf16 rule
    wb = cuda(rng.standard_normal((p, 100)).astype(np.float32)).to(
        torch.bfloat16)
    mag = gathered_masked_mean_backward_plain(wb.float().abs(), pos, mask, s,
                                              "mean", torch.float32)

    def vjp():
        a = hb.clone().requires_grad_(True)
        (k2(a, pos, mask).float() * wb.float()).sum().backward()
        return a.grad

    check("gathered_masked_mean[vjp]", k2_bwd,
          lambda: within_f32(vjp(), gathered_masked_mean_backward_plain(
              wb, pos, mask, s), mag, 8e-3), vjp)
    del h, hb, g, gb, wb, mag, pos

    # ---- K3: gather_rows from a 100,000 x 128 table, -1 ids zero rows ----
    tbl = cuda(rng.standard_normal((100_000, 128)).astype(np.float32))
    ids = cuda(rng.integers(-1, 100_000, 8192).astype(np.int32))
    check("gather_rows[float32]", k3,
          lambda: compare_gather_rows(tbl, ids).ok, lambda: k3(tbl, ids))
    del tbl, ids

    # ---- K4: the sampling kernel, bitwise, on the ragged cases -----------
    cases = ragged_cases()
    csr = [t.to(dev) for t in cases[0][1:3]]       # one CSR for every case
    args = [(*csr, fr.to(dev), u.to(dev)) for _, _, _, fr, u in cases]
    check(f"sample_neighbors[{len(cases)} ragged cases]", k4,
          lambda: all(compare_sample(*a).ok for a in args),
          lambda: k4(*max(args, key=lambda a: a[3].numel())))
    del csr, args, cases

    # ---- K5: grouped_masked_sum at P 8192, f 10, D 128 -------------------
    x2 = x[off:]
    wm = mask * cuda((0.5 + rng.random((p, f))).astype(np.float32))
    check("grouped_masked_sum[float32]", k5,
          lambda: compare_grouped_sum(x2, mask, f).ok,
          lambda: k5(x2, mask, f))
    xb2 = x2.to(torch.bfloat16)
    check("grouped_masked_sum[bfloat16]", k5,
          lambda: compare_grouped_sum(xb2, mask, f).ok,
          lambda: k5(xb2, mask, f))
    check("grouped_masked_sum[float32,float mask]", k5,
          lambda: compare_grouped_sum(x2, wm, f).ok,
          lambda: k5(x2, wm, f))
    return {"kernels": results, "failures": failures}


def main() -> None:
    out = run_gate(quick="--quick" in sys.argv[1:])
    print(json.dumps(out), flush=True)
    sys.exit(1 if out["failures"] else 0)


if __name__ == "__main__":
    main()
