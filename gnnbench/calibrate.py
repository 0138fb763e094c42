"""The readings that the cells' limits are set from, on the card:

    python3 -m gnnbench.calibrate --workload <cell> --seeds 11,12,13,...

For each seed, one process-local run of the cell's set-up with no window
(the program's observed steps, checked as a run checks them), then the
same training numbers of the control (the reference in float8 in the
program's place) and of a planted half-batch fault against the
reference. One JSON line a seed on stdout, then the largest program
reading and the smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gnnbench.cell import load_cell
from gnnbench.run import run_cell

NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(cell, seed, 0.0, False, "cuda", [], cell["limits"],
                       control=True)
        rows.append(res["readings"])
        print(json.dumps({"seed": seed, **res["readings"]}), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for k in NUMBERS:
        summary[f"program_max.{k}"] = max(r[k] for r in rows)
        for side in ("control", "half_batch"):
            summary[f"{side}_min.{k}"] = min(r[f"{side}.{k}"] for r in rows)
    summary["leaves_left_out"] = max(r["leaves_left_out"] for r in rows)
    for k in ("sampler_faults", "row_faults"):
        summary[f"program_max.{k}"] = max(r[k] for r in rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
