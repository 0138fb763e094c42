"""Device milliseconds a step of the dedup's kernels: the sorts, and the
scan with indices that broadcasts each group's leader (``cummax``), by
the kernel names below, over the traced steps."""

from gnnbench.metrics import kernel_seconds, traced_steps

UNIT, LAYER, MOVES = "ms", "sampler", "train_edges_per_s"
KERNELS = ("radixsort", "radix_sort", "onesweep", "_with_indices")


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    s = kernel_seconds(t, KERNELS)
    return 1e3 * s / traced_steps(t) if s > 0 else None
