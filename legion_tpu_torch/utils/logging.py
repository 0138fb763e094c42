"""One-line JSON metrics and driver labels (counterparts of
``log_metrics`` and ``eval_labels`` in ``legion_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict


def log_metrics(record: Dict[str, Any], stream=None) -> None:
    """Emit one JSON line of metrics (machine-parseable run log)."""
    stream = stream or sys.stderr
    rec = {"ts": round(time.time(), 3), **record}
    print(json.dumps(rec), file=stream, flush=True)


def eval_labels(cfg) -> "tuple[str, str]":
    """(valid label, test label) for driver epoch lines: an ``lp_sage``
    eval figure is a loss (lower is better), not an accuracy."""
    if cfg.model.arch == "lp_sage":
        return "Val LP-loss", "LP-loss on test data"
    return "Val Acc", "Accuracy on test data"
