"""The traced window's share of wall time in which no kernel or copy ran
on the device: 1 - busy / window, in percent."""

UNIT, LAYER, MOVES = "%", "drivers", "train_edges_per_s"


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
