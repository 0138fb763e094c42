"""How a configuration's driver is run: one module per driver of the port,
named by a configuration's ``driver`` key. Each has ``drive(cell, inputs,
seed, device, observer, window)``: it runs the driver's own set-up (the
observer watching its first steps), hands ``window`` a function that runs
one epoch and returns its figures, and returns what set-up reported."""

from __future__ import annotations

from typing import Dict

import torch

from gnnbench.reference import initial_weights


def load_weights(model: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """The benchmark's initial weights (``reference.initial_weights``),
    drawn on the model's device and copied into its parameters in place;
    returned on the host for the reference."""
    dev = next(model.parameters()).device
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    w = initial_weights(shapes, seed, dev)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(w[k])
    return {k: v.cpu() for k, v in w.items()}


def graph_data(inputs):
    """The port's ``GraphData`` over the generated host arrays; a typed
    graph's also hands it ``edge_rel`` (each edge's relation id, aligned
    with ``indices``) and ``node_type_offsets`` (the types' id ranges)."""
    from legion_tpu_torch.data.format import GraphData
    typed = {k: getattr(inputs, k) for k in ("edge_rel", "node_type_offsets")
             if getattr(inputs, k) is not None}
    return GraphData(indptr=inputs.indptr, indices=inputs.indices,
                     features=inputs.features, labels=inputs.labels,
                     train_ids=inputs.train_ids, valid_ids=inputs.valid_ids,
                     test_ids=inputs.test_ids, **typed)
