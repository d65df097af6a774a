"""Device traces, named stage scopes and a host stage timer.

Counterpart of `graspnet_tpu/utils/tracing.py`: `device_trace` records a
torch.profiler trace of the host and (on the card) the device into
`log_dir` as a Chrome trace (load it in Perfetto or chrome://tracing),
`stage_scope` labels a region in such a trace, and `StageTimer` sums host
wall time per stage across threads.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"  # in log_dir


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the body into `log_dir`/trace.json (nothing when log_dir is
    None): CPU activity, and CUDA kernels when a card is present."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def stage_scope(name: str):
    """Label a model stage in a trace."""
    return record_function(name)


class StageTimer:
    """Host-side cumulative stage timer, shared across threads."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        # apps/test.py shares one timer across its postproc threads: the
        # read-modify-write accumulation must not lose updates
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        """Mean seconds per stage."""
        with self._lock:
            return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def report(self) -> str:
        return "  ".join(f"{k}={v * 1000:.1f}ms" for k, v in sorted(self.summary().items()))
