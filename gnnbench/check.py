"""The comparison that decides ``correct``: the program's first steps,
as ``observe.Observer`` read them during set-up, against
``reference.follow`` over the same inputs, and the rows the window's own
steps reported dropped. Each number has its limit in the cell's workload
file (``limits``), set from readings listed in PERF.md."""

from __future__ import annotations

from typing import Dict

import torch

from gnnbench import reference


def program_run(observer, setup: Dict, model: Dict) -> Dict:
    """The program's side in ``reference.compare``'s layout: the losses
    it reported, its first gradient (the first moments over 1 - beta1)
    and its parameters after the observed steps."""
    b1 = model["adam_betas"][0]
    return {"losses": list(setup["first_losses"][:len(observer.steps)]),
            "first_grad": {k: v / (1 - b1)
                           for k, v in observer.first_moments.items()},
            "params": observer.params}


def readings(observer, setup: Dict, inputs, cell: Dict, device,
             dropped: int, control: bool = False) -> Dict:
    """Every number compared (and, with ``control``, the same training
    numbers of the control and of the planted half-batch fault against
    the reference)."""
    reference.no_tf32()
    model = cell["configuration"]["model"]
    dev = torch.device(device)
    graph = [None if a is None else torch.from_numpy(a).to(dev)
             for a in (inputs.indptr, inputs.indices, inputs.edge_rel,
                       inputs.node_type_offsets)]
    out = {"observed_steps": len(observer.steps),
           "sampler_faults": sum(reference.sampler_faults(s, *graph)
                                 for s in observer.steps),
           "dropped_rows": int(dropped)}
    del graph
    # the table stays on the host: each step's rows are gathered there
    feats = torch.from_numpy(inputs.features)
    out["row_faults"] = sum(reference.row_faults(s["x"], s["frontier"], feats,
                                                 dev)
                            for s in observer.steps if s["x"] is not None)
    out["rows_checked_steps"] = sum(s["x"] is not None
                                    for s in observer.steps)
    ref = reference.follow(observer.steps, setup["weights"], feats, model,
                           device=dev)
    out.update(reference.compare(program_run(observer, setup, model), ref,
                                 setup["weights"]))
    if control:
        for name, kw in (("control", dict(lowp=True)),
                         ("half_batch", dict(keep_half=True))):
            got = reference.follow(observer.steps, setup["weights"], feats,
                                   model, device=dev, **kw)
            out.update({f"{name}.{k}": v for k, v in
                        reference.compare(got, ref,
                                          setup["weights"]).items()})
    return out


def judge(values: Dict, limits: Dict, want_steps: int):
    """(correct, {name: [value, limit]}) for every limited number; too few
    observed steps is not correct."""
    checks = {k: [values[k], limits[k]] for k in limits}
    checks["observed_steps"] = [values["observed_steps"], want_steps]
    ok = values["observed_steps"] == want_steps and all(
        v <= lim for k, (v, lim) in checks.items() if k != "observed_steps")
    return ok, checks
