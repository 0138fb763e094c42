"""The whole step's share of the card's dense bf16 peak (989 TFLOP/s):
the matrix-product operations of a step that the configuration's model
module counts (``models/<arch>.py::flops``: for SAGE,
``counting.sage_flops`` at the realized seeds and hop-1 frontier a step
and the configuration's widths), times the traced steps, over the traced
window's wall time."""

from gnnbench import models
from gnnbench.counting import PEAK_BF16_FLOP_PER_S
from gnnbench.metrics import traced_steps

UNIT, LAYER, MOVES = "%", "model step", "train_edges_per_s"


def read(ctx):
    t, z = ctx["trace"], ctx["sizes"]
    if not t:
        return None
    model = ctx["cell"]["configuration"]["model"]
    flops = models.module(model["arch"]).flops(z, model)
    if flops is None:
        return None
    return 100.0 * flops * traced_steps(t) / (t["window_s"]
                                              * PEAK_BF16_FLOP_PER_S)
