"""The program's own spans and counters over the traced window: the ring
of epoch tallies that ``legion_tpu_torch.utils.trace`` keeps, read for the
epochs the harness traced (the last ``len(records)`` train epochs, since
no train epoch runs after the window). A program without that tracer
gives nothing to read."""

from __future__ import annotations

from typing import Dict, List, Optional


def window_epochs(ctx: Dict) -> Optional[List[Dict]]:
    """The tracer's entries of the traced window's epochs, or None where
    the run was not traced or the program keeps no such ring."""
    t = ctx.get("trace")
    if not t or not t["records"]:
        return None
    try:
        from legion_tpu_torch.utils import trace
    except ImportError:
        return None
    n = len(t["records"])
    ring = trace.epochs("train")[-n:]
    return ring if len(ring) == n else None


def span_seconds(entries: List[Dict], name: str) -> Optional[float]:
    """Inclusive seconds of span ``name`` summed over ``entries``, or None
    where no entry holds it."""
    rows = [e["spans"][name] for e in entries if name in e["spans"]]
    return sum(r[1] for r in rows) if rows else None


def counted(entries: List[Dict], name: str) -> Optional[int]:
    """Counter ``name`` summed over ``entries``, or None where no entry
    holds it."""
    vals = [e["counts"][name] for e in entries if name in e["counts"]]
    return sum(vals) if vals else None


def steps(entries: List[Dict]) -> int:
    return sum(e["steps"] for e in entries)
