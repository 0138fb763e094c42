"""The masked means' share of their roofline: the bytes K1 (the
identity-layout mean, ``masked_agg_kernel``) and K2 (the gathered mean,
``gathered_agg_kernel``, and its backward, ``scatter_rows_kernel`` and
``narrow_rows_kernel``) must move, at the card's memory peak, over the
traced time of those kernels. Counted per block from the realized sizes:
each referenced source row read once, the mask (and K2's positions) once,
each valid destination row written once; K2's rows are the transformed
ones (the classes wide, in the compute dtype), its backward reads the
output's gradient and writes each referenced row's. A kernel absent from
the trace adds neither bytes nor time."""

from gnnbench.counting import bound
from gnnbench.metrics import kernel_seconds, traced_steps

UNIT, LAYER, MOVES = "%", "kernels", "train_edges_per_s"
K1 = ("masked_agg_kernel",)
K2 = ("gathered_agg_kernel",)
K2_BWD = ("scatter_rows_kernel", "narrow_rows_kernel")


def read(ctx):
    t, z = ctx["trace"], ctx["sizes"]
    if not t:
        return None
    nbytes, secs = 0.0, 0.0
    outer, inner = z["blocks"][-1], z["blocks"][0]
    s1 = kernel_seconds(t, K1)
    if s1 > 0:
        d = z["feature_dim"]
        nbytes += (outer["valid"] * d * z["row_itemsize"]
                   + outer["slots"] + outer["num_dst"] * d * 2)
        secs += s1
    c = z["num_classes"]
    s2 = kernel_seconds(t, K2)
    if s2 > 0:
        nbytes += (inner["distinct"] * c * 2 + inner["slots"] * 5
                   + inner["num_dst"] * c * 2)
        secs += s2
    s3 = kernel_seconds(t, K2_BWD)
    if s3 > 0:
        nbytes += (inner["num_dst"] * c * 2 + inner["slots"] * 5
                   + inner["distinct"] * c * 2)
        secs += s3
    if secs <= 0:
        return None
    least = bound(nbytes, 0)["bound_ms"] / 1e3 * traced_steps(t)
    return 100.0 * least / secs
