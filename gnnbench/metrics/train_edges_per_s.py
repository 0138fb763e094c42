"""Valid sampled edges of every epoch of the window (int64 on the host)
over the window's wall time, which ends in the last epoch's read back."""

UNIT, LAYER, MOVES = "edges/s", "end to end", "train_edges_per_s"


def read(ctx):
    w = ctx["window"]
    if not w:
        return None
    return sum(r["edges"] for r in w["records"]) / w["window_s"]
