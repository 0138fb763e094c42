"""Data-parallel training over ``torch.distributed`` (counterpart of
``legion_tpu/parallel``): ``mesh`` lays out and starts the ranks, ``dp``
is the step's gradient reduction, ``trainer.MeshTrainer`` the lifecycle."""
