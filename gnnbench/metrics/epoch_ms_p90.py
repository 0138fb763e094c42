"""The 90th percentile (nearest rank) of the wall times of every epoch of
the window."""

import math

UNIT, LAYER, MOVES = "ms", "end to end", "epoch_ms_p90"


def nearest_rank(values, q: float) -> float:
    """The smallest value with at least a share ``q`` of ``values`` at or
    below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def read(ctx):
    w = ctx["window"]
    if not w:
        return None
    return 1e3 * nearest_rank(w["epoch_s"], 0.9)
