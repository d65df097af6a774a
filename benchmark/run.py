"""Run one cell of the benchmark of graspnet_tpu_torch once.

    python3 benchmark/run.py --workload infer.robot_b1 --seed 7 --seconds 20 --trace 0

The cell's file (`benchmark/workloads/<cell>.json`) names its model
configuration (`benchmark/configs/`), its traffic and its driver
(`benchmark/drivers/`).  The driver makes the inputs and the weights from
`--seed` (the weights from the configuration's weight seed), warms up the
shapes the cell uses, measures for `--seconds` seconds and keeps what the
timed path produced.  Then the program's state is freed and the plain
reference (`benchmark/reference/`) judges a sample of it drawn from the
seed.  With `--trace 0` the result carries the cell's end-to-end metrics;
with `--trace 1` its per-layer metrics (`benchmark/metrics/`), read from a
profiled stretch of the window and from the window's records.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and `breakdown` with
`--trace 1`), `build_s` (the seconds of set-up that built the program's
kernels: all but 0 only on a checkout's first run), and last `checks`,
each number compared with its limit; the same numbers end standard
error.  Exits 2 without a CUDA device, 3 when
the program is missing or a run fails, 4 when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the caches of the program's build tools stay at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(ROOT, "benchmark", ".cache", sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from benchmark import harness  # noqa: E402
from benchmark import trace as tracing  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell: the name of a file in benchmark/workloads/")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             overrides=None, fault=None, t_start: float = T_START) -> dict:
    """One run of `cell`; returns the result object (without printing).
    `overrides` and `fault` are for the tests, which run at a small size on
    the CPU and break the program underneath on purpose."""
    workload = harness.load_json("workloads", cell)
    config = harness.load_json("configs", workload["config"])
    tmp = tempfile.mkdtemp(prefix="graspnet-bench-")
    ctx = harness.Context(cell=cell, workload=workload, config=config, seed=seed, seconds=seconds, trace=trace,
                          device=device, tmp=tmp, t_start=t_start, overrides=overrides or {}, fault=fault)
    try:
        drv = harness.driver(workload["driver"])
        drv.run(ctx)  # set-up, the window; frees the program's state before it returns
        gc.collect()
        found = harness.forbidden_loaded()
        if found:
            return {"forbidden": found}
        drv.check(ctx)  # the reference, after the window
        metrics = {}
        if trace:
            for name, reader in harness.metric_readers(cell).items():
                value = reader.read(ctx.records)
                if value is not None:
                    metrics[name] = {"value": value, "unit": reader.UNIT}
        else:
            metrics = {k: {"value": v, "unit": u} for k, (v, u) in ctx.end_to_end.items()}
            metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
        result = {
            "correct": bool(ctx.checks) and all(c.ok for c in ctx.checks),
            "attempted": ctx.attempted,
            "failed": ctx.failed,
            "metrics": metrics,
            "device": device_entry(ctx),
        }
        summary = ctx.records.get("trace")
        if trace and summary is not None:
            result["breakdown"] = tracing.breakdown(summary)
        result["build_s"] = build_seconds()
        result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in ctx.checks}
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_seconds() -> float:
    """Seconds the program's compilers ran in this process (its own record;
    the libraries build at first use, one at a time): part of `setup_s`,
    and 0 once a checkout holds them."""
    try:
        from graspnet_tpu_torch.ops.cuda import build
    except ImportError:
        return 0.0
    return float(sum(build.BUILD_SECONDS.values()))


def device_entry(ctx: harness.Context) -> dict:
    import torch

    entry = {"platform": "gpu" if ctx.device != "cpu" else "cpu",
             "kind": torch.cuda.get_device_name(0) if ctx.device != "cpu" else "cpu",
             "count": 1, "memory_peak_bytes": ctx.memory_peak_bytes}
    if ctx.device != "cpu":
        entry["power"] = harness.card_power()
    summary = ctx.records.get("trace")
    if ctx.trace and summary is not None:
        entry["busy_s"] = summary["busy_s"]
        entry["window_s"] = summary["window_s"]
    return entry


def main(argv=None) -> int:
    args = parse_args(argv)
    bad = harness.import_violations()
    if bad:
        print("the benchmark's sources import what they may not:\n  " + "\n  ".join(bad), file=sys.stderr)
        return 4
    try:
        import torch
    except ImportError as e:
        print(f"PyTorch is missing: {e}", file=sys.stderr)
        return 3
    chips = int(harness.load_json("workloads", args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import graspnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program (graspnet_tpu_torch) is missing: {e}", file=sys.stderr)
        return 3
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except Exception:  # noqa: BLE001 — the run reports and prints no result
        traceback.print_exc()
        return 3
    found = result.get("forbidden") or harness.forbidden_loaded()
    if found:
        print("JAX or the JAX package was loaded: " + ", ".join(found), file=sys.stderr)
        return 4
    print(f"build_s = {result['build_s']!r} (the program's kernel builds, within setup_s)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
