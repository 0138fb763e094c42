"""What the output check reads of the program: the first training steps
that the driver's own set-up runs, through the calls the window replays.

Three seams of the port are watched while set-up runs, none of them
changing what the device executes:

* ``make_objective`` (``train/loop.py``, and its import in
  ``cache/pipeline.py``): its train loss is wrapped to note the batch it
  is handed (the sampled blocks, the frontier, the seeds and labels);
* forward pre-hooks on the model: the feature rows it is handed, and the
  hidden rows each entry of ``model.layers`` after the first is handed
  (after dropout): an entry called ``(block, h)`` or, as a head's entry
  past the last block, on ``h`` alone;
* ``GraphedStep.__call__`` (``train/graphed.py``): after each call that
  trained, the device is synchronised and the step's tensors copied to
  the host, with the optimizer's first moments after the first step and
  the parameters after the last.

A step's first call runs it eagerly (the capture's warm-up) and then
captures it; its replays run no Python. So the tensors a capture noted
are kept (they live in the graph's pool and each replay rewrites them)
and read after each replay; the feature rows are read only where the
step ran eagerly, since keeping them would hold a large buffer in the
pool. Once ``steps`` steps are read the watch does nothing.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional
from unittest import mock

import torch

WATCHED_OBJECTIVES = ("legion_tpu_torch.train.loop",
                      "legion_tpu_torch.cache.pipeline")


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _host(t):
    return None if t is None else t.detach().to("cpu", copy=True)


class Observer:
    """The program's first ``steps`` training steps, as host tensors in
    ``reference.py``'s layout (``self.steps``), its first gradient
    (``first_moments`` / (1 - beta1)) and its parameters after them."""

    def __init__(self, steps: int = 3):
        self.want = steps
        self.steps: List[Dict] = []
        self.first_moments: Optional[Dict[str, torch.Tensor]] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.optimizer = None
        self.model = None
        self._live = None                 # {"eager": {}, "capture": {}}
        self._captured: Dict[int, tuple] = {}
        self._patches: Optional[contextlib.ExitStack] = None

    @property
    def done(self) -> bool:
        return len(self.steps) >= self.want

    # -- notes made by the hooks ------------------------------------------

    def note(self, key: str, value) -> None:
        if self.done or self._live is None:
            return
        if isinstance(value, torch.Tensor):
            value = value.detach()      # keeps no autograd graph alive
        if _capturing():
            if key != "x":
                self._live["capture"][key] = value
        else:
            self._live["eager"][key] = (_host(value) if key == "x"
                                        else value)

    def watch_model(self, model: torch.nn.Module) -> None:
        """Hooks on ``model``: the rows it is handed, and the rows each
        entry ``i`` of ``model.layers`` after the first is handed (noted
        as ``h<i>``): ``args[1]`` of an entry called ``(block, h)``,
        ``args[0]`` of one called on ``h`` alone."""
        self.model = model
        model.register_forward_pre_hook(
            lambda mod, args: self.note("x", args[1]))
        for i, layer in enumerate(model.layers[1:], start=1):
            layer.register_forward_pre_hook(
                lambda mod, args, key=f"h{i}": self.note(
                    key, args[0] if len(args) == 1 else args[1]))

    # -- the steps ----------------------------------------------------------

    def _call(self, orig, graphed_step) -> None:
        if self.done:
            return orig(graphed_step)
        self._live = {"eager": {}, "capture": {}}
        try:
            orig(graphed_step)
        finally:
            live, self._live = self._live, None
        if live["capture"]:
            self._captured[id(graphed_step)] = (graphed_step, live["capture"])
        refs = live["eager"] or self._captured.get(
            id(graphed_step), (None, {}))[1]
        if "batch" in refs:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._take(refs)

    def _take(self, refs: Dict) -> None:
        b = refs["batch"]
        blocks = [(_host(k.nbr_pos), _host(k.nbr_mask), int(k.num_src),
                   int(k.num_dst), k.identity_offset) for k in b.blocks]
        rels = [_host(getattr(k, "nbr_rel", None)) for k in b.blocks]
        x = refs.get("x")
        self.steps.append({
            "seeds": _host(b.seeds), "labels": _host(b.labels),
            "num_seeds": int(b.num_seeds), "frontier": _host(b.frontier),
            "num_frontier": int(b.num_frontier), "blocks": blocks,
            "rels": rels,
            "h": [_host(refs.get(f"h{i}"))
                  for i in range(len(self.model.layers))],
            "x": x if isinstance(x, torch.Tensor) and x.device.type == "cpu"
            else None})
        names = [k for k, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        if len(self.steps) == 1:
            # an optimizer that kept no moments reads as a zero gradient
            st = self.optimizer.state
            self.first_moments = {
                k: _host(st.get(p, {}).get("exp_avg", torch.zeros_like(p)))
                for k, p in zip(names, params)}
        if self.done:
            self.params = {k: _host(p) for k, p in zip(names, params)}

    def release(self) -> None:
        """Drop every reference into the program (its model, optimizer and
        the tensors captures noted), keeping the steps read."""
        self.model = self.optimizer = self._live = None
        self._captured = {}

    def start(self) -> None:
        """Patch the seams (until ``stop``)."""
        from legion_tpu_torch.train import graphed, loop
        orig_objective = loop.make_objective
        orig_call = graphed.GraphedStep.__call__
        obs = self

        def make_objective(cfg):
            loss_of, counts_of = orig_objective(cfg)

            def noted_loss(out, batch):
                obs.note("batch", batch)
                return loss_of(out, batch)
            return noted_loss, counts_of

        def call(graphed_step):
            return obs._call(orig_call, graphed_step)

        self._patches = contextlib.ExitStack()
        for mod in WATCHED_OBJECTIVES:
            self._patches.enter_context(mock.patch(f"{mod}.make_objective",
                                                   make_objective))
        self._patches.enter_context(mock.patch.object(
            graphed.GraphedStep, "__call__", call))

    def stop(self) -> None:
        """Undo ``start``: the window runs the program unpatched (a loss
        already wrapped notes nothing once the steps are read)."""
        if self._patches is not None:
            self._patches.close()
            self._patches = None
