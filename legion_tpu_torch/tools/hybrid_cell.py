"""The host-topology (hybrid) path at uk-union class: its configuration.

``tools/smoke_uk_scale.py``'s configuration (SAGE-256 bf16, dropout 0.5,
lr 0.003, fanout [25,10], batch 8000, eval batches of 8000, host-resident
features and topology, 3 presample steps) on the graph of
``tools/pa_cell.py`` (2^24 + 2^20 nodes, 249.5M edges, loaded by mmap, so
the CSR stays in host memory and only the hot sub-CSR goes to the device).
That graph stands in for uk-union's 133,633,040 nodes and 5.5B edges,
which take ~40 GB to generate; the 2 GiB cache budget is scaled by the
same cut in nodes (273 MiB), and the cost model splits it between the
feature cache and the topology cache. With the cut no edge offset passes
2^31: ``chip_smoke.py``'s ``bigcsr`` phase runs this cell again with
every run moved past edge 2^31 (``tools/scale.py::holed_twins``), and
``tools/smoke_uk_scale.py`` runs the class at its full size.
"""

from __future__ import annotations

from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                     ModelConfig, SamplerConfig, TrainConfig)
from legion_tpu_torch.tools import pa_cell

FULL_NODES = 133_633_040                    # uk-union
BUDGET = (2 << 30) * pa_cell.NODES // FULL_NODES        # 286,460,570 B
dataset = pa_cell.dataset


def config(epochs: int, budget: int = BUDGET,
           num_classes: int = pa_cell.CLASSES) -> Config:
    return Config(
        dataset=DatasetConfig(num_classes=num_classes,
                              feature_placement="host",
                              topology_placement="host"),
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=pa_cell.BATCH,
                              eval_batch_size=pa_cell.BATCH, dedup_last=True),
        model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype="bfloat16"),
        train=TrainConfig(learning_rate=0.003, epochs=epochs),
        cache=CacheConfig(enabled=True, budget_bytes=budget,
                          presample_steps=3))
