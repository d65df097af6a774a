"""The host cost of one span (`utils/tracing.py`), three ways: with no
recorder and no profiler (what every untraced request and step pays),
under a recording, and under a recording and torch.profiler (CPU
activity; a `--trace 1` run's profiled stretch).  Each is the best of
`--repeats` loops of `--n` empty spans, less the same loop's empty body;
one JSON line, in ns a span.

    python -m graspnet_tpu_torch.scripts.span_cost [--n 100000] [--repeats 5]

Host Python only: the number is the machine's, not the card's.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
from typing import Dict, Optional, Sequence

from torch.profiler import ProfilerActivity, profile

from graspnet_tpu_torch.utils.tracing import recording, span


def _loop_ns(n: int, body: bool) -> float:
    t0 = time.perf_counter_ns()
    if body:
        for _ in range(n):
            with span("cost"):
                pass
    else:
        for _ in range(n):
            pass
    return (time.perf_counter_ns() - t0) / n


def _best(n: int, repeats: int, rec=None) -> float:
    """The best of `repeats` loops, ns a span; `rec`, a recording to
    drain after each (every span kept, none piling up)."""
    best = float("inf")
    for _ in range(repeats):
        best = min(best, _loop_ns(n, True) - _loop_ns(n, False))
        if rec is not None:
            assert len(rec.drain()) == n
    return best


def run(n: int = 100_000, repeats: int = 5) -> Dict[str, object]:
    off = _best(n, repeats)
    with recording() as rec:
        on = _best(n, repeats, rec)
    with recording() as rec, profile(activities=[ProfilerActivity.CPU]):
        profiled = _best(n, 1, rec)
    return {"spans": n, "repeats": repeats, "off_ns": off, "on_ns": on, "profiler_ns": profiled,
            "cpu": platform.processor() or platform.machine()}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    print(json.dumps(run(args.n, args.repeats)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
