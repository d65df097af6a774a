"""Slope-method stage timing, the counterpart of `scripts/slope_timing.py`.

`timeit(name, fn, *args)` calls fn(*args) once to warm up, then times a
window of K_LO calls back to back between two CUDA events and a window of
K_HI calls, each REPS times keeping the fastest (as `slope_timing.py:46-53`
keeps the fastest of 3), and records the slope
(T(K_HI) - T(K_LO)) / (K_HI - K_LO) in ms: what a window costs besides its
calls (the event records, the queue filling at its start) cancels, and a
host stall inside one window does not reach the record.  Every iteration
sums each output tensor into a running total, as `slope_timing.py:24-31`
consumes every output leaf, so a stage is timed with all of its outputs
made.  On CPU tensors the windows run on the host clock, on one intra-op
thread, and the records say `backend: "cpu"`: that is no device time.  (A
pool of threads on a host shared with other processes stalls at its
barriers for hundreds of ms, long enough to make every short window slower
than a long one: a negative slope under a loaded test run.)

Every `timeit` of the process records into `RECORDS`; `dump_records(path,
source)` writes `{"stage_ms", "backend", "source", "gpu"}` as JSON.  The
entry points write only where `--out` names a path.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.device import resolve_device

K_LO, K_HI = 10, 60
REPS = 3
RECORDS: Dict[str, float] = {}
RUN: Dict[str, Optional[str]] = {"backend": None}


def reset(k_lo: int = 10, k_hi: int = 60) -> None:
    """Clear the records and set the two window lengths (k_hi > k_lo >= 1)."""
    global K_LO, K_HI
    if not 1 <= k_lo < k_hi:
        raise ValueError(f"need 1 <= k_lo < k_hi, got {k_lo}, {k_hi}")
    K_LO, K_HI = k_lo, k_hi
    RECORDS.clear()
    RUN["backend"] = None


def calls_per_stage() -> int:
    """fn calls one `timeit` makes: the warm-up and REPS of each window."""
    return 1 + REPS * (K_LO + K_HI)


def gpu_name_and_power() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _device(args: Sequence[Any]) -> torch.device:
    for t in _tensors(list(args)):
        return t.device
    raise ValueError("timeit needs at least one tensor among fn's arguments")


def _window(fn, args, k: int, device: torch.device) -> float:
    """ms for k back-to-back calls, every output consumed."""
    total = torch.zeros((), dtype=torch.float32, device=device)

    def calls():
        for _ in range(k):
            for leaf in _tensors(fn(*args)):
                total.add_(leaf.detach().float().sum())

    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        calls()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    calls()
    return (time.perf_counter() - t0) * 1e3


def timeit(name: str, fn, *args, width: int = 50) -> float:
    """Record and print the slope time of fn(*args) in ms."""
    device = _device(args)
    threads = torch.get_num_threads()
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        for leaf in _tensors(fn(*args)):  # warm-up: builds kernels, fills caches
            leaf.detach().float().sum()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        lo, hi = [], []
        for _ in range(REPS):  # in turns, so that a slow stretch of the host reaches both lengths
            lo.append(_window(fn, args, K_LO, device))
            hi.append(_window(fn, args, K_HI, device))
    finally:
        torch.set_num_threads(threads)
    t_lo, t_hi = min(lo), min(hi)
    per = (t_hi - t_lo) / (K_HI - K_LO)
    print(f"{name:{width}s} {per:9.4f} ms", flush=True)
    RECORDS[name] = per
    RUN["backend"] = device.type
    return per


def dump_records(path: str, source: str) -> None:
    """Write {stage_ms, backend, source, gpu} JSON; gpu is the card's
    name and power limit, null for a CPU run."""
    backend = RUN["backend"]
    payload = {
        "stage_ms": dict(RECORDS),
        "backend": backend,
        "source": source,
        "gpu": gpu_name_and_power() if backend == "cuda" else None,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    print(f"wrote {path} ({len(RECORDS)} stages)")


def cli(
    description: str,
    argv: Optional[Sequence[str]],
    add_arguments: Optional[Callable[[argparse.ArgumentParser], None]] = None,
) -> Tuple[argparse.Namespace, GraspNetConfig, torch.device]:
    """The timing entry points' shared arguments, and an entry point's own
    (`add_arguments`); resets the records."""
    ap = argparse.ArgumentParser(description=description)
    if add_arguments is not None:
        add_arguments(ap)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() instead of GraspNetConfig()")
    ap.add_argument("--k-lo", type=int, default=10, help="calls in the short window")
    ap.add_argument("--k-hi", type=int, default=60, help="calls in the long window")
    ap.add_argument("--out", default=None, help="write the stage_ms JSON here")
    args = ap.parse_args(argv)
    reset(args.k_lo, args.k_hi)
    cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig()
    device = resolve_device(args.device, ap.prog)
    print(f"backend: {device.type}", flush=True)
    return args, cfg, device
