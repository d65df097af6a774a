"""Helpers the per-layer readers share: the window's untraced requests and
their host times, and the profiled stretch's summary when it holds device
events (None otherwise, so a reader reads nothing rather than 0 or 100 %)."""

from __future__ import annotations

import statistics
from typing import List, Optional


def untraced(records) -> List[dict]:
    return [r for r in records.get("requests", []) if not r["traced"] and r["error"] is None]


def timed_replies(records) -> List[dict]:
    """Untraced requests whose reply carries the service's stage timings."""
    return [r for r in untraced(records) if r["reply"] and "timings_ms" in r["reply"]]


def mean(xs) -> Optional[float]:
    xs = list(xs)
    return statistics.fmean(xs) if xs else None


def stretch(records):
    """The profiled stretch's summary, if the profiler recorded device work in it."""
    s = records.get("trace")
    return s if s is not None and s["busy_s"] is not None else None
