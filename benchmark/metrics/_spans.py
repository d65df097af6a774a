"""Helper for the readers of the program's own spans: a reply of
`GraspService.compute` carries, in `timings_ms`, the ms of its request's
spans by name (`graspnet_tpu_torch/utils/tracing.py`).  A reader gives the
mean over the window's untraced requests whose reply carries the span,
and None when none does (a program whose replies carry no spans reads
nothing)."""

from __future__ import annotations

from typing import Optional

from benchmark.metrics._common import mean, timed_replies


def request_ms(records, name: str) -> Optional[float]:
    """Mean ms a request in the span named `name`."""
    return mean(r["reply"]["timings_ms"][name] for r in timed_replies(records) if name in r["reply"]["timings_ms"])
