"""The GAT cell (``gat-products.b8000f10``) cut to a tiny size: it runs
correct on the CPU, and is not correct with layer 0's dropout mask
withheld from the reference, with the program's attention replaced by a
uniform mean, or with the reference in float8 in the program's place; on
the card (the ``cuda`` mark) it runs correct through the captured step.
``models/gat.py::flops`` and ``gat_agg_roofline``'s bytes against counts
made one product and one row at a time."""

from __future__ import annotations

import itertools
from unittest import mock

import numpy as np
import pytest
import torch

from gnnbench import cell as cells
from gnnbench import metrics, reference, run
from gnnbench.metrics import attn_ns_per_slot, gat_agg_roofline
from gnnbench.models import gat
from gnnbench.tests.conftest import SEED, tiny_cell

CELL = "gat-products.b8000f10"
# The tiny cell's limits, where the cells' own do not fit a batch of 128
# through three bf16 GAT layers. Five seeds read, for the program, loss
# gaps up to 5.3e-4, first-gradient gaps up to 1.3e-2 (the attention
# vectors' gradients are sums that cancel) and change gaps up to 1.2e-2;
# the control (the reference in float8) read loss gaps from 1.7e-3.
TINY_GAT = {"loss_gap": 1e-3, "grad_gap": 2.5e-2, "change_gap": 2.5e-2}


def _cell():
    c = tiny_cell(CELL)
    c["limits"].update(TINY_GAT)
    return c


def _run(control=False, seconds=0.0, device="cpu", names=()):
    c = _cell()
    return run.run_cell(c, SEED, seconds, False, device, list(names),
                        c["limits"], control=control)


def test_tiny_gat_cell_runs_correct_on_the_cpu():
    names = [m["name"] for m in cells.benchmark()["end_to_end"]]
    res = _run(seconds=0.3, names=names)
    assert res["correct"], res["checks"]
    assert res["readings"]["sampler_faults"] == 0
    assert res["readings"]["rows_checked_steps"] >= 1
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == set(names)


def test_a_withheld_first_mask_is_not_correct():
    orig = reference.drop_masks

    def withheld(step, layers, device):
        return [None] + orig(step, layers, device)[1:]
    with mock.patch.object(reference, "drop_masks", withheld):
        res = _run()
    assert not res["correct"], res["checks"]


def test_uniform_attention_is_not_correct():
    """The program's attention a plain mean over each row's slots (every
    score zero) fails the check."""
    from legion_tpu_torch.ops import gat_attention as ga
    orig = ga.edge_softmax_aggregate_plain

    def uniform(z, a_src, a_dst, *rest):
        return orig(z, a_src * 0, a_dst * 0, *rest)
    with mock.patch.object(ga, "edge_softmax_aggregate_plain", uniform):
        res = _run()
    assert not res["correct"], res["checks"]


def test_control_is_not_correct():
    res = _run(control=True)
    assert res["correct"], res["checks"]
    lim = _cell()["limits"]
    ctl = {k.split(".", 1)[1]: v for k, v in res["readings"].items()
           if k.startswith("control.") and k.split(".", 1)[1] in lim}
    assert any(ctl[k] > lim[k] for k in ctl), (ctl, lim)


@pytest.mark.cuda
def test_tiny_gat_cell_on_the_card(card):
    c = _cell()
    res = run.run_cell(c, SEED, 0.5, False, card, [], c["limits"],
                       control=True)
    assert res["correct"], res["checks"]
    assert res["readings"]["observed_steps"] == 3


# -- the counts ---------------------------------------------------------------

def _linear_flops(rows, k, n):
    return sum(2 * k for _ in itertools.product(range(rows), range(n)))


def test_flops_counts_every_product():
    model = {"num_heads": 2, "hidden_dim": 3, "num_layers": 3}
    sizes = {"feature_dim": 5, "num_classes": 4, "blocks": [
        {"num_src": 7.2, "num_dst": 3.0},        # sampling order: layer 2
        {"num_src": 11.0, "num_dst": 7.0},
        {"num_src": 16.4, "num_dst": 11.0}]}     # layer 0
    # layer 0: lin over 16 src rows (5 -> 6), skip over 11 dst rows (5 ->
    # 6), forward and weight gradients; layer 1: 6 -> 6 over 11 and 7,
    # with input gradients; layer 2: lin 6 -> 2 heads of 4, skip 6 -> 4
    l0 = _linear_flops(16, 5, 6) + _linear_flops(11, 5, 6)
    l1 = _linear_flops(11, 6, 6) + _linear_flops(7, 6, 6)
    l2 = _linear_flops(7, 6, 8) + _linear_flops(3, 6, 4)
    assert gat.flops(sizes, model) == 2 * l0 + 3 * (l1 + l2)


def _step_blocks(seed=0):
    """One sampled step of a small graph, every hop deduplicated."""
    from legion_tpu_torch.data.synthetic import random_power_law_graph
    from legion_tpu_torch.sampling.block import frontier_caps
    from legion_tpu_torch.sampling.sampler import DeviceGraph, sample_batch
    g = random_power_law_graph(num_nodes=400, avg_degree=5, feature_dim=4,
                               num_classes=3, seed=seed)
    graph = DeviceGraph.from_host(g.indptr, g.indices, torch.device("cpu"))
    seeds = torch.from_numpy(g.train_ids[:16].astype(np.int32))
    b = sample_batch(graph, seeds, torch.tensor(16, dtype=torch.int32),
                     torch.zeros(16, dtype=torch.int32), (3, 3, 2),
                     frontier_caps(16, (3, 3, 2)), dedup_last=True,
                     generator=torch.Generator().manual_seed(seed))
    return b.blocks


@pytest.mark.parametrize("seed", range(3))
def test_roofline_bytes_against_a_count(seed):
    """Each block's bytes as ``traffic`` counts them from its sizes, against
    the rows, slots and scores the block names, counted one by one."""
    heads, width, item, fanouts = 2, 6, 2, (3, 3, 2)
    for blk, f in zip(_step_blocks(seed), fanouts):
        nd, ns = int(blk.num_dst), int(blk.num_src)
        rows = {d for d in range(nd)}                 # the self slots
        slots = 0
        for d in range(nd):
            for j in range(f):
                slots += 1                            # position and mask
                if blk.nbr_mask[d, j]:
                    rows.add(int(blk.nbr_pos[d, j]))
        assert len(rows) == ns                        # every src row named
        row, score = heads * width * item, heads * item
        fwd = (len(rows) * (row + score) + slots * 5 + nd * score
               + nd * row)
        bwd = (nd * row + len(rows) * (row + score) + slots * 5 + nd * score
               + len(rows) * (row + score) + nd * score)
        assert gat_agg_roofline.traffic(ns, nd, f, heads, width, item) == \
            fwd + bwd


def test_metrics_read_nothing_without_the_kernels():
    """A traced run of a program without the attention's kernels (the
    parent of this cell, or a SAGE cell) gives neither metric."""
    ctx = {"trace": {"kernels": [("gather_rows_kernel", 0.0, 5.0)],
                     "records": [{"steps": 2}], "window_s": 1.0},
           "sizes": {"blocks": []}, "cell": _cell()}
    assert gat_agg_roofline.read(ctx) is None
    assert attn_ns_per_slot.read(ctx) is None
    for name in ("gat_agg_roofline", "attn_ns_per_slot"):
        assert metrics.reader(name).UNIT in ("%", "ns")
