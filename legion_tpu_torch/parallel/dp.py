"""The data-parallel step (counterpart of ``legion_tpu/parallel/dp.py``).

Every rank samples and trains on its own batch; the gradients are
averaged over the ranks between the backward pass and the optimizer step
(DDP's all-reduce, the reference's ``legion_graphsage.py:140-141``). The
reference pins two things (``legion_tpu/train/loop.py:160-175``,
``tests/test_comm_accounting.py``): exactly one parameter-sized
all-reduce a step, and the mean of the ranks' gradients, not their sum.
``GradMean`` makes both hold: it flattens every gradient into one float32
buffer, sums it over the ranks in one ``all_reduce`` through the counting
wrapper, divides by the world size and copies the result back.
``DistributedDataParallel`` is not used: its buckets decide the number of
all-reduces.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from legion_tpu_torch.utils import comm


class GradMean:
    """``reducer(model)`` for ``make_step_fns``: every parameter's
    gradient becomes the mean over the ranks."""

    def __init__(self, model: torch.nn.Module):
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.world = dist.get_world_size()
        n = sum(p.numel() for p in self.params)
        self.flat = torch.empty(n, dtype=torch.float32,
                                device=self.params[0].device)
        self.views = []
        off = 0
        for p in self.params:
            self.views.append(self.flat[off:off + p.numel()].view_as(p))
            off += p.numel()

    def __call__(self, model: torch.nn.Module) -> None:
        for p, v in zip(self.params, self.views):
            v.copy_(p.grad)
        comm.all_reduce(self.flat)
        self.flat.div_(self.world)
        for p, v in zip(self.params, self.views):
            p.grad.copy_(v)
