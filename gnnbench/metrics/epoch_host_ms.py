"""The program's host milliseconds an epoch while none of that epoch's
device work is queued: its ``epoch.prepare`` (seeds, labels, the loads
into the static rows) plus its ``epoch.record`` inclusive spans, the mean
over the traced epochs (``gnnbench/spans.py``)."""

from gnnbench import spans

UNIT, LAYER, MOVES = "ms", "drivers", "train_edges_per_s"


def read(ctx):
    ring = spans.window_epochs(ctx)
    if not ring:
        return None
    parts = [spans.span_seconds(ring, n)
             for n in ("epoch.prepare", "epoch.record")]
    if all(p is None for p in parts):
        return None
    return 1e3 * sum(p or 0.0 for p in parts) / len(ring)
