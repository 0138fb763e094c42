"""Megabytes (10^6 B) a step copied from host memory to the device: the
program's ``h2d_bytes`` counter (seeds, labels, seed counts, staged rows,
cold topology, an epoch's totals) over the traced epochs' steps
(``gnnbench/spans.py``)."""

from gnnbench import spans

UNIT, LAYER, MOVES = "MB", "cache pipeline", "train_edges_per_s"


def read(ctx):
    ring = spans.window_epochs(ctx)
    if not ring:
        return None
    b = spans.counted(ring, "h2d_bytes")
    n = spans.steps(ring)
    return None if b is None or not n else b / 1e6 / n
