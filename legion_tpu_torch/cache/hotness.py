"""Cap sizing from presampling observation: ``observed_caps`` copied from
``legion_tpu/cache/hotness.py:82`` (numpy only). The port may not import
``legion_tpu.cache``, whose ``__init__`` loads JAX;
``tests/test_torch_sampler.py`` holds the two equal."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def observed_caps(max_per_hop, slack: float = 1.2, align: int = 8,
                  last_exact_fanout: int | None = None) -> Tuple[int, ...]:
    """Tightened static frontier caps from presampling observation —
    the reference's 1.2 x MaxIdNum buffer sizing (src/Server.cu:275)
    turned into tighter static shapes.

    last_exact_fanout: set to fanouts[-1] when the consumer samples with
    dedup_last=False — the final cap is then the exact identity-append
    extent caps[-2]*(1+fanout), not an observed (deduped) count.
    """
    m = np.asarray(max_per_hop)
    caps = np.ceil(m * slack / align).astype(int) * align
    caps = np.maximum.accumulate(caps)
    if last_exact_fanout is not None:
        caps[-1] = caps[-2] * (1 + last_exact_fanout)
    return tuple(int(c) for c in caps)
