"""The whole step's share of the card's dense bf16 peak (989 TFLOP/s):
``counting.sage_flops`` at the realized seeds and hop-1 frontier a step
and the configuration's widths, times the traced steps, over the traced
window's wall time."""

from gnnbench.counting import PEAK_BF16_FLOP_PER_S, sage_flops
from gnnbench.metrics import traced_steps

UNIT, LAYER, MOVES = "%", "model step", "train_edges_per_s"


def read(ctx):
    t, z = ctx["trace"], ctx["sizes"]
    if not t:
        return None
    flops = sage_flops(round(z["seeds"]), round(z["hop1_rows"]),
                       z["hidden_dim"], z["feature_dim"], z["num_classes"])
    return 100.0 * flops * traced_steps(t) / (t["window_s"]
                                              * PEAK_BF16_FLOP_PER_S)
