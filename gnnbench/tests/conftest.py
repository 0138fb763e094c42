"""Shared pieces of the benchmark's tests: a tiny cell of each
configuration (the configuration's structure at a size a CPU run holds)
and the card fixture of the ``cuda`` mark."""

from __future__ import annotations

import pytest
import torch

from gnnbench.cell import load_cell

SEED = 2 ** 31 + 12345
# The limits at the tiny size, on the CPU's plain path. Five seeds of each
# tiny cell read, for the program, loss gaps up to 2.9e-4, first-gradient
# gaps up to 1.9e-3 and change gaps up to 4.2e-4; the control (the
# reference in float8) read loss gaps from 9.6e-4 and gradient gaps from
# 4.5e-3. A batch of 128 averages the loss over fewer seeds than the
# cells' 8000, so these sit above the cells' own limits.
TINY_LIMITS = {"sampler_faults": 0, "row_faults": 0, "dropped_rows": 0,
               "loss_gap": 5e-4, "grad_gap": 3.2e-3, "change_gap": 8e-3}


# Cells deeper than any committed one, by name: (cell, layers, limits
# changed). They differ from that cell in data alone (the model's
# ``num_layers``, and the last fanout repeated to as many hops), as a new
# architecture's cell does. Through a third bf16 layer five seeds read
# loss gaps up to 1.14e-3 (1e-7 with the model in float32: the three
# masks are followed exactly), gradient gaps up to 1.7e-3 and change gaps
# up to 9.0e-4; the control read loss gaps from 1.09e-3, so its gradient
# gaps (from 1.41e-2) part it from the program.
DEEPER = {"sage-products.b8000.3layers": ("sage-products.b8000", 3,
                                          {"loss_gap": 2.5e-3})}


TINY_NODES, TINY_DEGREE, TINY_TYPE = 3000, 8.0, 8


def tiny_graph(conf: dict) -> None:
    """Cut configuration ``conf`` in place to about ``TINY_NODES`` nodes
    and in-degrees of at most ``TINY_DEGREE``, with 700 / 100 / 100 split
    ids. A typed graph's node types keep their shares of the nodes, at
    least ``TINY_TYPE`` a type, and each relation's in-degree is capped."""
    conf.update(num_nodes=TINY_NODES, avg_in_degree=TINY_DEGREE,
                train_nodes=700, valid_nodes=100, test_nodes=100)
    types = conf.get("node_types")
    if not types:
        return
    total = sum(t["num_nodes"] for t in types)
    for t in types:
        t["num_nodes"] = max(TINY_TYPE,
                             round(TINY_NODES * t["num_nodes"] / total))
    for r in conf["relations"]:
        r["avg_in_degree"] = min(r["avg_in_degree"], TINY_DEGREE)
    conf["num_nodes"] = sum(t["num_nodes"] for t in types)


def tiny_cell(name: str) -> dict:
    """Cell ``name`` (or a ``DEEPER`` one) cut to about 3000 nodes
    (``tiny_graph``), 700 train ids, batch 128, fanouts [5, 3, 2] to its
    number of hops: the same drivers, model and checks."""
    base, layers, limits = DEEPER.get(name, (name, None, {}))
    c = load_cell(base)
    mix = c["traffic_mix"]
    if layers is not None:
        c["configuration"]["model"]["num_layers"] = layers
        mix["fanouts"] += mix["fanouts"][-1:] * (layers - len(mix["fanouts"]))
    tiny_graph(c["configuration"])
    mix.update(batch_size=128, fanouts=[5, 3, 2][:len(mix["fanouts"])])
    c["limits"] = {**TINY_LIMITS, **limits}
    return c


@pytest.fixture
def card():
    """The CUDA device, or a skip where the process has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")
