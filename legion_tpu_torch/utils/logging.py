"""One-line JSON metrics (counterpart of ``log_metrics`` in
``legion_tpu/utils/logging.py``)."""

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
