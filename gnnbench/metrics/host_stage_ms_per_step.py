"""Host milliseconds a step spent waiting for the packed plan and
gathering the misses' rows into pinned memory (the cached trainer's
``stage_s``) over the traced epochs."""

from gnnbench.metrics import traced_steps

UNIT, LAYER, MOVES = "ms", "cache pipeline", "train_edges_per_s"


def read(ctx):
    t = ctx["trace"]
    recs = [r for r in (t["records"] if t else []) if "stage_s" in r]
    if not recs:
        return None
    return 1e3 * sum(r["stage_s"] for r in recs) / traced_steps(t)
