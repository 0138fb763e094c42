"""Seconds of the cached driver's presampling epoch (its own
``presample_s``), part of set-up."""

UNIT, LAYER, MOVES = "s", "presample and cost model", "setup_s"


def read(ctx):
    return ctx["setup"].get("presample_s")
