"""One ScanNet evaluation client in a closed loop on `DetectionPipeline`
(apps/detect.py).

The client hands the pipeline a batch of room scans, waits for each
scan's boxes on the host and sends the next, as votenet's `eval.py` runs
its test set.  The scans are a pool drawn from the seed
(`inputs/rooms.py`), batched and cycled in pool order, so every seed gives
the same shapes.  Traffic parameters (the cell's file):

- `scans`, `points`, `batch_size`: the pool, the points of a scan and the
  scans of a request;
- `warm_requests`: requests before the window, off the clock;
- `trace_requests`: requests of the profiled stretch of a `--trace 1` run,
  from a third of the window on;
- `check_batches`: batches of the pool whose last result in the window
  the reference judges (the first ones).

Each request is timed on the host clock from the hand-over of the batch
to the return of its boxes.  A reply carries the request's spans by name
in `timings_ms` (`detect.dispatch`, `detect.boxes`, `detect.fetch`,
`detect.nms`); a `--trace 1` run records the spans of its profiled
stretch, keeps the `detect.boxes` and `detect.nms` counts, which it
prints, and the device time of the kernels those two spans launched.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import sys
import time

import numpy as np

from benchmark import harness, roofline_detect, trace
from benchmark.inputs.rooms import room_pool
from benchmark.reference.vn import Detector
from benchmark.weights import make_weights


def detector(ctx) -> Detector:
    return Detector.from_fields(ctx.overrides.get("detector", ctx.config["detector"]))


def program_config(ctx):
    """The configuration file's model and detector as the program's
    VoteNetConfig (whose detector fields are `Detector`'s)."""
    from graspnet_tpu_torch import config as program_config

    g = harness.model_config(ctx.model_fields(), program_config)
    backbone = {f: getattr(g, f) for f in ("num_point", "input_feature_dim", "sa1", "sa2", "sa3", "sa4",
                                           "fp1_mlp", "fp2_mlp", "bn_eps")}
    return program_config.VoteNetConfig(**backbone, **dataclasses.asdict(detector(ctx)))


def batches(ctx) -> list:
    t = ctx.traffic
    pool = room_pool(ctx.seed, int(t["scans"]), int(t["points"]))
    b = int(t["batch_size"])
    return [pool[i: i + b] for i in range(0, len(pool) - b + 1, b)]


def run(ctx) -> None:
    import torch
    from graspnet_tpu_torch import checkpoint
    from graspnet_tpu_torch.apps.detect import DetectionPipeline
    from graspnet_tpu_torch.models.votenet import VoteNet

    t = ctx.traffic
    cfg = program_config(ctx)
    pool = batches(ctx)
    ctx.records["batches"] = pool
    shapes = {k: tuple(v.shape) for k, v in VoteNet(cfg).state_dict().items()}
    weights = make_weights(shapes, ctx.weight_seed(), ctx.device)
    path = os.path.join(ctx.tmp, "weights.pt")
    checkpoint.save(path, {k: v.to("cpu") for k, v in weights.items()})
    ctx.records["weights"] = weights
    pipe = DetectionPipeline(cfg=cfg, device=ctx.device, checkpoint_path=path)
    if ctx.fault is not None:
        ctx.fault(pipe)
    for i in range(int(t["warm_requests"])):
        pipe.detect(pool[i % len(pool)])
    if ctx.device != "cpu":
        torch.cuda.synchronize()
    ctx.setup_done()
    done, last = _window(ctx, pipe, pool)
    ctx.read_memory_peak()
    # what the checked batches' last requests returned, to the host before the program's state goes
    n_check = min(int(t["check_batches"]), len(pool))
    ctx.records["returned"] = {b: (np.stack([d.rows for d in dets]), handle.end_points["head"].cpu().numpy())
                               for b, (handle, dets) in last.items() if b < n_check}
    del pipe, last
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    lat = [r["latency_s"] * 1e3 for r in done]
    ctx.attempted = len(done)
    ctx.failed = sum(1 for r in done if r["error"])
    ctx.end_to_end["latency_p50_ms"] = (statistics.median(lat), "ms")
    ctx.end_to_end["latency_p95_ms"] = (statistics.quantiles(lat, n=20)[18], "ms")
    ctx.records["requests"] = done
    batch = int(t["batch_size"])
    ctx.records["forward_flops"] = roofline_detect.forward_flops(cfg, detector(ctx), batch)
    ctx.records["fps_bound_s"] = roofline_detect.fps_bound_s(cfg, detector(ctx), batch)


def _request(pipe, pool, i: int, last: dict) -> dict:
    b = i % len(pool)
    timings: dict = {}
    t0 = time.perf_counter()
    try:
        handle = pipe.dispatch(pool[b], timings)
        dets = pipe.finish(handle)
        last[b], error = (handle, dets), None
    except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
        error = f"{type(e).__name__}: {e}"
    latency = time.perf_counter() - t0
    reply = {"ok": error is None, "timings_ms": {k: v * 1e3 for k, v in timings.items()}}
    return {"batch": b, "latency_s": latency, "reply": reply, "error": error, "traced": False}


def _window(ctx, pipe, pool):
    """The measured window: every request that ended inside it, in order,
    and the last result of each batch of the pool; with `--trace 1`,
    `trace_requests` of them profiled from a third of the window on."""
    from graspnet_tpu_torch.utils import tracing

    t = ctx.traffic
    start = time.perf_counter()
    deadline, trace_from = start + ctx.seconds, start + ctx.seconds / 3
    done: list = []
    last: dict = {}
    i = 0
    while time.perf_counter() < deadline:
        if ctx.trace and "trace" not in ctx.records and time.perf_counter() >= trace_from:
            n = int(t["trace_requests"])
            with tracing.recording() as rec, trace.Traced(ctx.tmp) as tr:
                rows = [_request(pipe, pool, i + k, last) for k in range(n)]
            for r in rows:
                r["traced"] = True
            ctx.records["trace"] = trace.summarize(tr.path)
            ctx.records["traced_requests"] = n
            ctx.records["span_counts"] = _counts(rec.drain())
            ctx.records["boxes_device_s"] = _kernel_seconds_under(tr.path, ("detect.boxes", "detect.nms"))
            os.remove(tr.path)
        else:
            rows = [_request(pipe, pool, i, last)]
        i += len(rows)
        done.extend(rows)
    return done, last


def _counts(spans) -> dict:
    """The `detect.boxes` and `detect.nms` spans' counts, summed by span."""
    out: dict = {}
    for s in spans:
        if s.name in ("detect.boxes", "detect.nms"):
            into = out.setdefault(s.name, {})
            for k, v in s.counts.items():
                into[k] = into.get(k, 0) + v
    return out


def _kernel_seconds_under(path: str, names) -> float:
    """Device seconds of the kernels launched inside the host annotations
    named `names` of a profiler's Chrome trace: each launch call in such
    an annotation's interval, on its thread, gives its correlation id, and
    the kernels with those ids their durations (copies left out)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in names and "dur" in e:
            spans.setdefault(e.get("tid"), []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    ids = set()
    for e in events:
        if e.get("name") in trace.LAUNCH_CALLS and "correlation" in e.get("args", {}):
            ts = float(e["ts"])
            if any(a <= ts <= b for a, b in spans.get(e.get("tid"), ())):
                ids.add(e["args"]["correlation"])
    return sum(float(e["dur"]) for e in events
               if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in ids) * 1e-6


def check(ctx) -> None:
    """The reference's proposals for each checked batch against what the
    program's last request of it returned in the window."""
    import torch

    from benchmark.reference import gn, judge, vn

    det = detector(ctx)
    ref = vn.VoteNet(harness.model_config(ctx.model_fields(), gn), det, ctx.records.pop("weights"), ctx.device)
    totals = {"head_gap": 0.0, "box_gap": 0.0, "selection_diff": 0}
    for b, (rows, head) in sorted(ctx.records["returned"].items()):
        x = torch.as_tensor(ctx.records["batches"][b], device=ctx.device)
        with judge.precision("float32"):
            out = ref.forward(x)
            res = vn.parse_predictions(out, x[..., :3], det, ref.mean_size)
        got = vn.compare(rows, head, out["head"].cpu().numpy(), res)
        for k, v in got.items():
            totals[k] = max(totals[k], v) if k.endswith("_gap") else totals[k] + v
    counts = ctx.records.get("span_counts")
    print(f"detect: checked batches {sorted(ctx.records['returned'])}"
          + (f", span counts over the traced stretch {counts}" if counts else ""), file=sys.stderr)
    if not ctx.records["returned"]:
        totals["selection_diff"] = float("inf")
    for name, value in totals.items():
        ctx.check(name, value)
    ctx.check("failed_requests", ctx.failed)
