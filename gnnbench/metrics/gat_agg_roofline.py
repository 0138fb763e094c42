"""GAT's edge-softmax aggregation's share of its roofline: the bytes its
forward and backward must move (``traffic``) at the card's memory peak,
over the traced time of its kernels (every kernel named
``edge_softmax_*``: the forward, and the backward's zero fill, count,
placement, weights, src-row and dst-row passes and cast). Counted per
block at the realized sizes of the observed steps, each layer at its
head width and the compute dtype's item size. A program without those
kernels gives nothing to read."""

from gnnbench.counting import bound
from gnnbench.metrics import kernel_seconds, traced_steps

UNIT, LAYER, MOVES = "%", "kernels", "train_edges_per_s"
KERNELS = ("edge_softmax",)


def traffic(num_src: float, num_dst: float, fanout: int, heads: int,
            width: int, itemsize: int) -> float:
    """Bytes one block's forward and backward must move. Every src row is
    referenced (each dst row by its self slot, each new row by the slot
    that drew it). The forward reads each src row of z and its a_src
    once, each live dst row's positions (4 B) and mask (1 B) a slot and
    its a_dst once, and writes each live dst row's output once; the
    backward reads the output's gradient, z and the scores, positions and
    mask once, and writes each src row's gradient of z and of a_src and
    each dst row's gradient of a_dst once."""
    row, score = heads * width * itemsize, heads * itemsize
    reads = num_src * (row + score) + num_dst * (fanout * 5 + score)
    forward = reads + num_dst * row
    backward = num_dst * row + reads + num_src * (row + score) \
        + num_dst * score
    return forward + backward


def step_bytes(sizes, cell) -> float:
    """The must-move bytes of one step's three (or n) layers."""
    model = cell["configuration"]["model"]
    fanouts = cell["traffic_mix"]["fanouts"]
    itemsize = 2 if model["dtype"] == "bfloat16" else 4
    blocks = sizes["blocks"]
    n = len(blocks)
    total = 0.0
    for k, b in enumerate(blocks):           # sampling order: k = 0 last
        width = sizes["num_classes"] if k == 0 else model["hidden_dim"]
        total += traffic(b["num_src"], b["num_dst"], fanouts[k],
                         model["num_heads"], width, itemsize)
    return total if n else 0.0


def read(ctx):
    t, z = ctx["trace"], ctx["sizes"]
    if not t:
        return None
    secs = kernel_seconds(t, KERNELS)
    if secs <= 0:
        return None
    least = bound(step_bytes(z, ctx["cell"]), 0)["bound_ms"] / 1e3 \
        * traced_steps(t)
    return 100.0 * least / secs
