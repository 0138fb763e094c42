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


def tiny_cell(name: str) -> dict:
    """Cell ``name`` cut to 3000 nodes, 700 train ids, batch 128, fanout
    [5, 3]: the same drivers, model and checks."""
    c = load_cell(name)
    c["configuration"].update(num_nodes=3000, avg_in_degree=8.0,
                              train_nodes=700, valid_nodes=100,
                              test_nodes=100)
    c["traffic_mix"].update(batch_size=128, fanouts=[5, 3])
    c["limits"] = dict(TINY_LIMITS)
    return c


@pytest.fixture
def card():
    """The CUDA device, or a skip where the process has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")
