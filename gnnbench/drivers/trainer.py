"""The device-resident path: ``legion_tpu_torch.train.loop.Trainer``, the
topology and the whole feature table in device memory. Set-up is the
trainer's construction (the cap probe, the model, the state) and its
first epoch (the warm-up and capture of the train step); the window calls
``Trainer.train_one_epoch``, epoch after epoch."""

from __future__ import annotations

import itertools
from typing import Callable, Dict

from gnnbench.cell import port_config
from gnnbench.drivers import graph_data, load_weights


def drive(cell: Dict, inputs, seed: int, device, observer,
          window: Callable) -> Dict:
    from legion_tpu_torch.train.loop import Trainer
    warm = int(cell["traffic_mix"]["warmup_epochs"])
    cfg = port_config(cell, seed, epochs=warm)
    observer.start()
    try:
        tr = Trainer(cfg, graph_data(inputs), device)
        weights = load_weights(tr.model, seed)
        observer.watch_model(tr.model)
        observer.optimizer = tr.state.optimizer
        first = tr.train_one_epoch(0)
    finally:
        observer.stop()
    for e in range(1, warm):
        tr.train_one_epoch(e)
    epochs = itertools.count(warm)

    def epoch() -> Dict:
        rec = tr.train_one_epoch(next(epochs))
        return {"steps": rec["steps"],
                "edges": round(rec["edges_per_s"] * rec["epoch_s"]),
                "overflow": rec["cap_overflow"]}

    window(epoch)
    return {"weights": weights, "first_losses": first["losses"],
            "caps": list(tr.caps)}
