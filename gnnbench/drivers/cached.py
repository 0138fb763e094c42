"""Host-resident features behind the hot-row cache:
``legion_tpu_torch.train.cached_driver.run_cached_training``, run as it
stands (presample, cost model, cache build, the pipeline's captures, its
warm-up epochs with their evaluation and any staging growth). The trainer
it built last is reached as ``tools/profile_cached.py`` reaches it, by
wrapping ``CachedTrainer.run_epoch``; after the driver's last warm-up
epoch the window calls that trainer's ``run_epoch`` on fresh epochs of
seeds, then hands control back to the driver (its closing evaluation
runs after the window)."""

from __future__ import annotations

import sys
from typing import Callable, Dict
from unittest import mock

import numpy as np

from gnnbench.cell import port_config
from gnnbench.drivers import graph_data, load_weights


def drive(cell: Dict, inputs, seed: int, device, observer,
          window: Callable) -> Dict:
    from legion_tpu_torch.cache.pipeline import CachedTrainer
    from legion_tpu_torch.train import cached_driver
    warm = int(cell["traffic_mix"]["warmup_epochs"])
    cfg = port_config(cell, seed, epochs=warm)
    b = cfg.sampler.batch_size
    ids = np.asarray(inputs.train_ids)
    steps = (len(ids) - 1) // b
    rng = np.random.default_rng([int(seed), 17])
    out: Dict = {"records": []}
    run_epoch = CachedTrainer.run_epoch
    build_model = cached_driver.build_model

    def built(*args, **kwargs):
        model = build_model(*args, **kwargs)
        out["weights"] = load_weights(model, seed)
        observer.watch_model(model)
        return model

    def wrapped(self, state, seeds, labels, uniforms=None):
        observer.optimizer = state.optimizer
        r = run_epoch(self, state, seeds, labels, uniforms)
        out["records"].append({k: v for k, v in r.items() if k != "state"})
        if len(out["records"]) == warm:
            observer.stop()

            def epoch() -> Dict:
                s = rng.permutation(ids)[:steps * b].reshape(steps, b)
                e = run_epoch(self, state, s, inputs.labels[s])
                return {"steps": e["steps"], "edges": e["edges"],
                        "overflow": e["staging_overflow"],
                        "hit_rate": e["cache_hit_rate"],
                        "stage_s": e["stage_s"]}

            window(epoch)
        return r

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    observer.start()
    try:
        with mock.patch.object(CachedTrainer, "run_epoch", wrapped), \
                mock.patch.object(cached_driver, "build_model", built):
            res = cached_driver.run_cached_training(cfg, graph_data(inputs),
                                                    device, log=log)
    finally:
        observer.stop()
    first = out["records"][0]
    return {"weights": out["weights"], "first_losses": first["losses"],
            "caps": res["history"][0]["caps"],
            "miss_cap": res["history"][-1]["miss_cap"],
            "presample_s": res["history"][0]["presample_s"],
            "warmup": out["records"]}
