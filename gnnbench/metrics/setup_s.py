"""Seconds from the process's start to the window's first step: imports,
the inputs made from the seed, the kernels' load (their build, on a
checkout's first run) and the driver's set-up through its warm-up."""

UNIT, LAYER, MOVES = "s", "end to end", "setup_s"


def read(ctx):
    return ctx["setup_s"]
