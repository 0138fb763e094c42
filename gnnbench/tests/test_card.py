"""On the card (the ``cuda`` mark; skipped elsewhere): a tiny cell of each
configuration through the captured drivers comes out correct, and the
control in its place does not.

    python3 -m pytest gnnbench/tests -m cuda
"""

from __future__ import annotations

import pytest

from gnnbench import run
from gnnbench.tests.conftest import SEED, tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sage-products.b8000",
                                  "sage-papers100m.cache15",
                                  "sage-products.b8000.3layers"])
def test_tiny_cell_on_the_card(card, name):
    c = tiny_cell(name)
    res = run.run_cell(c, SEED, 0.5, False, card, [], c["limits"],
                       control=True)
    assert res["correct"], res["checks"]
    assert res["readings"]["observed_steps"] == 3
    ctl = {k.split(".", 1)[1]: v for k, v in res["readings"].items()
           if k.startswith("control.") and k.split(".", 1)[1] in c["limits"]}
    assert any(ctl[k] > c["limits"][k] for k in ctl), ctl
