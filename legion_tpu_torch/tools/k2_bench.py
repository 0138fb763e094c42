"""K2 alone: ``gathered_masked_mean`` forward, backward and the backward's
three passes, timed at the shapes the port runs it at.

    python legion_tpu_torch/tools/k2_bench.py [TREE]

Run as a script from a repository root on a machine with the card. It
imports ``legion_tpu_torch`` from ``TREE`` (a checkout, e.g. a ``git
archive`` of another commit unpacked into a gitignored directory; default:
this one), builds that tree's kernels and times them with
``chip_smoke.py``'s ``time_ms`` (this checkout's) on tensors made from a
seed:

* SAGE main path, layer 1: P 8000, f 25, S 121,856, D 47 bf16, "mean";
* GCN float32, layer 1: the same in float32, "sum";
* cached path at papers100M class, layer 1: P 9600, f 25, S 84,464,
  D 172 bf16, "mean";

with the share of valid slots those paths see (0.98, 0.98, 0.56) and
positions skewed toward the low rows (``S * u^2``), as a deduped frontier
repeats its hubs. Each shape's kernel results are first held against the
plain versions. A tree whose backward is split into passes
(``scatter_masked_rows``, ``narrow_rows``) also gets ``parts_ms`` (zero
fill, scatter kernel, cast) and the forward on a row-strided input: rows
padded to the next multiple of 4 elements (4 more where D is one). It
prints the card's name and power limit and one JSON line. Compare two
trees in one call, in the order A, B, B, A.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = (
    # name, P, f, S, D, dtype, norm, share of valid slots
    ("sage_main_bf16", 8000, 25, 121_856, 47, "bfloat16", "mean", 0.98),
    ("gcn_main_f32", 8000, 25, 121_856, 47, "float32", "sum", 0.98),
    ("cached_pa_bf16", 9600, 25, 84_464, 172, "bfloat16", "mean", 0.56),
)


def make_case(torch, p, f, s, d, dtype, valid, seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((s, d), generator=gen, device=dev).to(dtype)
    g = torch.randn((p, d), generator=gen, device=dev).to(dtype)
    mask = torch.rand((p, f), generator=gen, device=dev) < valid
    u = torch.rand((p, f), generator=gen, device=dev)
    pos = (u * u * s).to(torch.int32).clamp(max=s - 1)
    return h, torch.where(mask, pos, 0), mask, g


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tree = os.path.abspath(args.tree or here)
    sys.path.insert(0, here)
    from chip_smoke import time_ms
    sys.path.insert(0, tree)
    import torch

    import legion_tpu_torch
    got = os.path.dirname(os.path.dirname(os.path.abspath(
        legion_tpu_torch.__file__)))
    if got != tree:
        raise SystemExit(f"imported legion_tpu_torch from {got}, not {tree}")
    from legion_tpu_torch.ops import identity_agg as k2
    if not torch.cuda.is_available():
        raise SystemExit("k2_bench.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    split = hasattr(k2, "scatter_masked_rows")
    out = {"tree": args.tree, "nvidia_smi": smi, "backward_is_split": split,
           "shapes": {}}
    for seed, (name, p, f, s, d, dtype, norm, valid) in enumerate(SHAPES):
        dt = getattr(torch, dtype)
        h, pos, mask, g = make_case(torch, p, f, s, d, dt, valid, seed)
        fwd = k2.gathered_masked_mean(h, pos, mask, norm)
        ref = k2.gathered_masked_mean_plain(h, pos, mask, norm)
        bwd = k2.gathered_masked_mean_backward(g, pos, mask, s, norm,
                                               torch.float32)
        bref = k2.gathered_masked_mean_backward_plain(g, pos, mask, s, norm,
                                                      torch.float32)
        mag = k2.gathered_masked_mean_backward_plain(g.abs(), pos, mask, s,
                                                     norm, torch.float32)
        torch.cuda.synchronize()
        if not bool(((bwd - bref).abs() <= 1e-5 * mag).all()):
            raise SystemExit(f"{name}: backward differs from its plain "
                             "version by more than 1e-5 of the magnitudes")
        rec = {
            "shape": [p, f, s, d], "dtype": dtype, "norm": norm,
            "valid_slots": int(mask.sum()),
            "fwd_max_abs_err": float((fwd.float() - ref.float()).abs().max()),
            "bwd_max_abs_err": float((bwd - bref).abs().max()),
            "fwd_ms": time_ms(
                lambda: k2.gathered_masked_mean(h, pos, mask, norm)),
            "bwd_ms": time_ms(
                lambda: k2.gathered_masked_mean_backward(g, pos, mask, s,
                                                         norm))}
        del fwd, ref, bwd, bref, mag
        if split:
            ld = k2.staging_width(d, dt)
            staging = torch.zeros((s, ld), dtype=torch.float32,
                                  device=h.device)
            rec["parts_ms"] = {
                "fill": time_ms(lambda: torch.zeros(
                    (s, ld), dtype=torch.float32, device=h.device)),
                "scatter": time_ms(lambda: k2.scatter_masked_rows(
                    g, pos, mask, staging, norm)),
                "cast": time_ms(lambda: k2.narrow_rows(staging, d, dt))}
            wide = -(-d // 4) * 4 + (4 if d % 4 == 0 else 0)
            padded = torch.zeros((s, wide), dtype=dt, device=h.device)
            padded[:, :d] = h
            view = padded[:, :d]
            same = torch.equal(k2.gathered_masked_mean(view, pos, mask, norm),
                               k2.gathered_masked_mean(h, pos, mask, norm))
            rec["fwd_padded_rows"] = {
                "row_stride": wide, "bitwise_equal": same,
                "ms": time_ms(lambda: k2.gathered_masked_mean(
                    view, pos, mask, norm))}
        out["shapes"][name] = rec
    print(smi, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
