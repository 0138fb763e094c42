"""One module per metric, named as ``BENCHMARK.json`` names the metric.
Each holds its ``UNIT``, the ``LAYER`` it belongs to (end-to-end metrics:
``end to end``), the end-to-end metric it ``MOVES`` (itself, for an
end-to-end metric) and ``read(ctx)``, which returns the number or None
where the run holds nothing to read (the harness then leaves the metric
out). ``ctx`` is what ``run.py`` gathered: ``cell``, ``setup_s``,
``setup`` (what the driver's set-up reported), ``window`` (the untraced
window's epochs), ``trace`` (the traced window, or None) and ``sizes``
(``sizes.realized``: the realized sizes of the observed steps)."""

from __future__ import annotations

import importlib


def reader(name: str):
    """The module of metric ``name``."""
    return importlib.import_module(f"gnnbench.metrics.{name}")


def kernel_seconds(trace, parts) -> float:
    """Seconds of the traced kernels whose lower-case name holds one of
    ``parts``."""
    return sum((b - a) / 1e6 for n, a, b in trace["kernels"]
               if any(p in n.lower() for p in parts))


def traced_steps(trace) -> int:
    return sum(r["steps"] for r in trace["records"])
