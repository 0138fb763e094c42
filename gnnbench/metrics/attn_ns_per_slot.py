"""Device nanoseconds GAT's attention takes a scored slot: the traced time
of its kernels (every kernel named ``edge_softmax_*``, forward and
backward) over the slots the traced epochs scored, self slots included
(the program's ``attn_slots`` counter, ``gnnbench/spans.py``). A program
without those kernels or that counter gives nothing to read."""

from gnnbench import spans
from gnnbench.metrics import kernel_seconds

UNIT, LAYER, MOVES = "ns", "model step", "train_edges_per_s"
KERNELS = ("edge_softmax",)


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    secs = kernel_seconds(t, KERNELS)
    ring = spans.window_epochs(ctx)
    slots = spans.counted(ring, "attn_slots") if ring else None
    if secs <= 0 or not slots:
        return None
    return 1e9 * secs / slots
