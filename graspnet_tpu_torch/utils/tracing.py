"""The port's one tracing system: spans at the layer boundaries, an
in-memory recorder of them, and torch.profiler traces.

`span(name, trace=None, into=None, **counts)` times a region of host work
on `time.perf_counter_ns()` and always keeps its interval, so callers read
`.seconds`; given a dict `into`, it adds its seconds there under its name
when it closes (the service's reply carries a request's spans so).  With
no recorder and no profiler on, that is all it does: a test of two flags
and the two clock reads.  While a `recording()` or a `device_trace` is on,
or any torch.profiler, a span also places itself:

- its parent: the enclosing span on the same thread;
- its trace id, shared by the spans of one request or one step: given, or
  inherited from the parent;
- its thread, and the integer counts the body adds (`s.count(rows=n)`);

and, while a torch profiler is active on its thread (`device_trace`'s
or anyone's own: torch's profiler records the thread that starts it),
enters `torch.profiler.record_function(name)`, so the span appears in the
profiler's Chrome trace as a `user_annotation` on that thread, and the
device's idle gaps under it are put down to it.  A recording keeps the
spans that close while it is on, from every thread, until drained.

Clocks: spans stamp `perf_counter_ns()`, a monotonic clock; the profiler's
Chrome trace stamps each event `ts` in microseconds after the trace's
`baseTimeNanoseconds`, on the wall clock (`time.time_ns()`'s).  A
recording reads the two clocks together when it starts (the pair of the
tightest of a few back-to-back readings), and `Recording.trace_ts_us`
maps a span's stamp onto the trace's timeline with that offset.

`device_trace` records a torch.profiler trace of the host and (on the
card) the device into `log_dir` as a Chrome trace (load it in Perfetto or
chrome://tracing).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Iterator, List, Optional

import torch
import torch.autograd.profiler as _torch_profiler
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"  # in log_dir

_perf_ns = time.perf_counter_ns
_ids = itertools.count(1)
_local = threading.local()  # .stack: the open spans of this thread, innermost last
_lock = threading.Lock()
_active = 0  # recordings and device traces on: spans record while above 0
_recordings: tuple = ()


class Span:
    """One timed region, a context manager: `with span("service.select")
    as s: ...; s.count(rows=n)`.  `trace` names the request or step it
    belongs to (default: the enclosing span's); `into`, a dict that gets
    the span's seconds under its name (added to what is there).  `id`,
    `parent` and `thread` are set when the span records or is profiled."""

    __slots__ = ("name", "trace", "into", "counts", "start_ns", "end_ns", "id", "parent", "thread", "_rf", "_on")

    def __init__(self, name: str, trace=None, into: Optional[dict] = None, **counts: int):
        self.name = name
        self.trace = trace
        self.into = into
        self.counts = counts
        self._on = False

    def __enter__(self) -> "Span":
        if _active or _torch_profiler._is_profiler_enabled:
            self._open()
        self.start_ns = _perf_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = _perf_ns()
        if self.into is not None:
            self.into[self.name] = self.into.get(self.name, 0.0) + (self.end_ns - self.start_ns) * 1e-9
        if self._on:
            self._close(exc_type, exc, tb)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def count(self, **counts: int) -> None:
        """Add integer counts to the span (recorded with it)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + int(v)

    def _place(self) -> None:
        """Take an id, this thread, and the enclosing span as the parent."""
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.thread = threading.get_ident()
        self.parent = None if parent is None else parent.id
        if self.trace is None and parent is not None:
            self.trace = parent.trace

    def _open(self) -> None:
        self._place()
        _stack().append(self)
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self._on = True

    def _close(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _stack().remove(self)
        for r in _recordings:
            r._add(self)


span = Span  # the name callers use: `with span(name, trace=None, into=None, **counts) as s`


def _stack() -> List[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def current_trace():
    """The trace id of the innermost open span on this thread, while
    spans record or a profiler runs (None otherwise), to hand to work
    another thread does."""
    if not (_active or _torch_profiler._is_profiler_enabled):
        return None
    stack = _stack()
    return stack[-1].trace if stack else None


def record_interval(name: str, start_ns: int, end_ns: int, **counts: int) -> Span:
    """A span for an interval timed already (`perf_counter_ns` stamps),
    recorded as if it had closed on this thread now: its parent and trace
    are the enclosing span's.  It does not appear in a profiler's trace."""
    s = Span(name, None, **counts)
    s.start_ns, s.end_ns = start_ns, end_ns
    if _active:
        s._place()
        for r in _recordings:
            r._add(s)
    return s


class Recording:
    """The spans that closed while this recording was on, from every
    thread, until drained; and the offset of the wall clock from
    `perf_counter_ns`, read when it started."""

    def __init__(self):
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        pairs = []
        for _ in range(5):
            a = _perf_ns()
            w = time.time_ns()
            b = _perf_ns()
            pairs.append((b - a, w - (a + b) // 2))
        self.wall_offset_ns = min(pairs)[1]

    def _add(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)

    def drain(self) -> List[Span]:
        """The spans recorded since the last drain, in the order they closed."""
        with self._lock:
            out, self._spans = self._spans, []
        return out

    def trace_ts_us(self, perf_ns: int, base_time_ns: int) -> float:
        """A `perf_counter_ns` stamp on the timeline of a profiler's Chrome
        trace whose `baseTimeNanoseconds` is `base_time_ns` (its `ts` unit)."""
        return (perf_ns + self.wall_offset_ns - base_time_ns) / 1e3


def _switch(on: bool, rec: Optional[Recording] = None) -> None:
    global _active, _recordings
    with _lock:
        _active += 1 if on else -1
        if rec is not None:
            _recordings = _recordings + (rec,) if on else tuple(r for r in _recordings if r is not rec)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span that closes in the body, on any thread; off by
    default, and nothing else to set up."""
    rec = Recording()
    _switch(True, rec)
    try:
        yield rec
    finally:
        _switch(False, rec)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the body into `log_dir`/trace.json (nothing when log_dir is
    None): CPU activity, and CUDA kernels when a card is present, with the
    body's spans as `user_annotation`s."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _switch(True)
        try:
            yield
        finally:
            _switch(False)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
