"""Multi-device training over ``torch.distributed`` (counterpart of
``legion_tpu/parallel``): ``mesh`` lays out and starts the ranks and makes
the cache groups, ``dp`` is the step's gradient reduction and the striped
table, ``feature_exchange`` the row exchange over a cache group,
``trainer.MeshTrainer`` the data-parallel lifecycle; ``halo`` the
edge-partitioned shard and its halo exchange, ``multihost`` the
partitioned step, ``launch`` the start-up under torchrun and each rank's
own shard."""
