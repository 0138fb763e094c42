"""What the harness knows of an architecture: one module per value of a
configuration's ``model.arch``, found by that name (``module``). A new
architecture is a new file here; nothing else in the harness changes.

A module holds, in plain PyTorch and importing nothing of the port:

* ``logits(weights, x, blocks, drop, keep, lowp)``: the float32 forward
  the reference follows. ``weights`` maps the port's parameter names to
  tensors; ``x`` is the rows the first layer takes, padded to
  ``in_width(weights)`` columns; ``blocks`` come in sampling order, each
  ``(nbr_pos, nbr_mask)`` as ``reference.py`` describes them; ``drop``
  has one entry per entry of the program's ``model.layers``, and
  ``drop[i]`` holds the kept entries of entry ``i``'s output (None: no
  dropout there, as after the last entry), kept values scaled by
  ``1 / keep``; with ``lowp`` every product's operands are rounded
  through ``reference.quantize``. ``model.layers`` may hold entries past
  the last block (a head): entry ``i`` below the number of blocks takes
  block ``n - 1 - i``, and an entry past them takes no block and no
  ``rels``.
* ``TYPED`` (optional, default False): a module for typed graphs sets it
  True, and ``logits`` then also takes two keywords, each one entry per
  block in sampling order: ``rels``, the relation id of each slot's edge
  (a long tensor of ``nbr_pos``'s shape on the reference's device, or None
  where the program's block carried none), and ``num_dst``, the block's
  live dst rows (an int; rows past it are padding, which a normalisation
  over the batch leaves out). Every other module is called without them.
* ``in_width(weights)``: the padded width of the rows the first layer
  takes.
* ``flops(sizes, model)``: the matrix-product operations of one train
  step at ``sizes.realized``'s sizes and the configuration's ``model``,
  or None where the module does not count them (``step_mfu`` is then
  left out).

The reference reads entry ``i``'s dropout mask from the rows the
program hands entry ``i + 1`` (``observe.py``): the port's model takes
``forward(blocks, x, ...)``, holds its layers in ``model.layers`` (a
layer over a block called ``(block, h)``, a head's entry called on ``h``
alone), and hands each entry the previous one's output after its
dropout. A dropout inside an entry, not between two, is not followed.

``sizes.realized``, which ``flops`` reads, gives on a typed cell each
block's ``src_by_type`` and ``dst_by_type`` (its mean live rows of each
node type) and ``relation_types`` (each relation's ``[src type, dst
type]`` by index), so that a projection per relation over its source
type's rows can be counted. The check hands ``logits`` rows gathered
from the host table a step at a time, never the whole table on the
device.
"""

from __future__ import annotations

import importlib
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def module(arch: str):
    """The module of architecture ``arch`` (``models/<arch>.py``)."""
    path = os.path.join(HERE, f"{arch}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no benchmark module for arch {arch!r}: "
                         f"{path} does not exist")
    return importlib.import_module(f"gnnbench.models.{arch}")
