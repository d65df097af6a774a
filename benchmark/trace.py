"""The traced stretch of a `--trace 1` run and what is read from it, and
the kernel clock of a `--trace 0` run's window.

`Traced` runs torch.profiler (host and device activity) around a short
steady stretch of the window, marked by a `bench.window` span, and writes
the Chrome trace under the run's temporary directory.  `summarize` reduces
that trace to what the per-layer readers and the result's `breakdown`
need: the device's busy time (the union of its kernel, copy and set
intervals inside the stretch), device time by operation name, the host's
kernel-launch calls, and the idle gaps of the device labelled by the
innermost host operation that covered them on the thread that drove the
stretch.  A stretch whose trace holds no device event gives `busy_s`
None: the profiler sometimes records no device events, and such a run
reports the metrics that need them as not read, never as 100 % idle.
`KernelClock` records the device's activity alone over a whole window and
gives the union of its kernels' intervals.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")
WINDOW_SPAN = "bench.window"
NAME_CHARS = 96  # operation names are cut to this many characters in the breakdown


class Traced:
    """Context manager: profile the body into `directory`/trace.json."""

    def __init__(self, directory: str):
        self.path = os.path.join(directory, "trace.json")
        self._prof = None
        self._span = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._torch = torch
        return self

    def __exit__(self, *exc):
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        self._prof.export_chrome_trace(self.path)
        return False


class KernelClock:
    """Context manager: the device's kernel time over the body, from the
    profiler's device activity alone (no host events are recorded, so the
    host runs close to its unprofiled pace).  `seconds` is the union of the
    kernels' intervals, None when the profiler recorded none.  Copies and
    sets are left out: a copy from pageable host memory lasts as long as
    the host takes to stage it, so its device interval is the host's time."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        cuda = self._torch.autograd.DeviceType.CUDA
        spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in self._prof.profiler.kineto_results.events()
                 if e.device_type() == cuda and not e.name().startswith(("Memcpy", "Memset"))]
        merged = _union(spans)
        self.kernels = len(spans)
        self.seconds = sum(b - a for a, b in merged) * 1e-9 if merged else None
        self._prof = None
        return False


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(path: str) -> Dict[str, object]:
    """Reduce a Chrome trace of a `Traced` stretch (or of a whole profiler
    session, when it has no `bench.window` span); times in seconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = next((e for e in events if e.get("name") == WINDOW_SPAN and "dur" in e), None)
    if window is not None:
        w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
        tid = window.get("tid")
    else:  # a trace the program wrote around its own loop: the profiler's span, its busiest host thread
        timed = [e for e in events if "dur" in e and "ts" in e]
        w0 = min(float(e["ts"]) for e in timed)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in timed)
        counts: Dict[object, int] = {}
        for e in events:
            if e.get("cat") == "cpu_op":
                counts[e.get("tid")] = counts.get(e.get("tid"), 0) + 1
        tid = max(counts, key=counts.get) if counts else None
    device = []
    by_name: Dict[str, float] = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                device.append((a, b))
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    launches = sum(1 for e in events if e.get("name") in LAUNCH_CALLS and w0 <= float(e.get("ts", -1)) <= w1)
    merged = _union(device)
    busy = sum(b - a for a, b in merged) * 1e-6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and "dur" in e and e.get("tid") == tid and e["name"] != WINDOW_SPAN)
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = "host Python outside any torch operation"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):  # the latest start covering mid
            if host[i][1] >= mid:
                label = host[i][2]
                break
        label = label[:NAME_CHARS]
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    ops: Dict[str, float] = {}
    for k, v in by_name.items():
        ops[k[:NAME_CHARS]] = ops.get(k[:NAME_CHARS], 0.0) + v
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy if merged else None,
        "device_ops": ops,
        "device_time_by_kernel": by_name,
        "launches": launches,
        "idle_gaps": gaps,
    }


def kernel_seconds(summary: Dict[str, object], *fragments: str) -> Optional[float]:
    """Device seconds of the operations whose name holds any of `fragments`
    (None when none ran in the stretch)."""
    hits = [v for k, v in summary["device_time_by_kernel"].items() if any(f in k for f in fragments)]
    return sum(hits) if hits else None


def breakdown(summary: Dict[str, object], top: int = 10) -> Dict[str, list]:
    """The result's `breakdown`: the device operations that took most time
    and the idle gaps by what the host was doing, each at most `top`."""
    ops = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
