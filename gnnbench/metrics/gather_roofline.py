"""The row gather's share of its roofline: the bytes it must move (each
valid frontier row read once from the table or the cache and staging,
every frontier row written once, one 4-byte id per row; at the
configuration's feature width and the rows' dtype) at the card's memory
peak, over the traced time of its kernels (K3, ``gather_rows_kernel``:
one launch on the device-resident path, two in the cache merge)."""

from gnnbench.counting import bound
from gnnbench.metrics import kernel_seconds, traced_steps

UNIT, LAYER, MOVES = "%", "kernels", "train_edges_per_s"
KERNELS = ("gather_rows_kernel",)


def read(ctx):
    t, z = ctx["trace"], ctx["sizes"]
    if not t:
        return None
    s = kernel_seconds(t, KERNELS)
    if s <= 0:
        return None
    rb = z["feature_dim"] * z["row_itemsize"]
    nbytes = z["valid_rows"] * rb + z["frontier_rows"] * (rb + 4)
    least = bound(nbytes, 0)["bound_ms"] / 1e3 * traced_steps(t)
    return 100.0 * least / s
