"""Host milliseconds a step of the cached pipeline's staging alone: the
host gather of the misses' rows into pinned memory and their copy up
(the program's ``pipeline.stage`` inclusive span, without the wait for the
packed plan), over the traced epochs' steps (``gnnbench/spans.py``)."""

from gnnbench import spans

UNIT, LAYER, MOVES = "ms", "cache pipeline", "train_edges_per_s"


def read(ctx):
    ring = spans.window_epochs(ctx)
    if not ring:
        return None
    s = spans.span_seconds(ring, "pipeline.stage")
    n = spans.steps(ring)
    return None if s is None or not n else 1e3 * s / n
