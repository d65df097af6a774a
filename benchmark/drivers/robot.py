"""A robot in a closed loop on `GraspService.compute` (apps/service.py).

The robot hands the service a raw capture, waits for the reply and sends
the next, as a robot on the ROS trigger service does.  The captures are a
pool drawn from the seed (`inputs/tabletop.py`), cycled in pool order, so
every seed gives the same sizes.  Traffic parameters (the cell's file):

- `captures`, `points`: the pool and the raw points of a capture;
- `max_batch`: the service's micro-batching (1: one forward a request);
- `serving`: overrides of the configuration's serving settings, such as
  `collision_thresh` -1, the upstream "skip" of the filter;
- `warm_requests`: requests before the window, off the clock;
- `trace_requests`: requests of the profiled stretch of a `--trace 1` run,
  from a third of the window on;
- `check_captures`: captures whose last reply in the window the reference
  judges, drawn from the seed.

Each request is timed on the host clock from the hand-over of the capture
to the return of the reply.
"""

from __future__ import annotations

import gc
import os
import statistics
import time

import numpy as np

from benchmark import harness, roofline, trace
from benchmark.inputs.tabletop import capture_pool
from benchmark.weights import make_weights


def serving(ctx) -> dict:
    return {**ctx.config["serving"], **ctx.traffic.get("serving", {})}


def program_weights(ctx, cfg):
    """The benchmark's weights for `cfg`, and a checkpoint of them under
    the run's temporary directory for entry points that load one."""
    from graspnet_tpu_torch import checkpoint
    from graspnet_tpu_torch.models import GraspNet

    shapes = {k: tuple(v.shape) for k, v in GraspNet(cfg).state_dict().items()}
    weights = make_weights(shapes, ctx.weight_seed(), ctx.device)
    path = os.path.join(ctx.tmp, "weights.pt")
    checkpoint.save(path, {k: v.to("cpu") for k, v in weights.items()})
    ctx.records["weights"] = weights
    return path


def run(ctx) -> None:
    import torch
    from graspnet_tpu_torch import config as program_config
    from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig

    t = ctx.traffic
    s = serving(ctx)
    cfg = harness.model_config(ctx.model_fields(), program_config)
    pool = capture_pool(ctx.seed, int(t["captures"]), int(t["points"]))
    ctx.records["pool"] = pool
    path = program_weights(ctx, cfg)
    svc = GraspService(ServiceConfig(
        checkpoint_path=path, model_cfg=cfg, num_point=cfg.num_point, collision_thresh=s["collision_thresh"],
        voxel_size=s["voxel_size"], depth_min=s["depth_min"], depth_max=s["depth_max"],
        max_batch=int(t["max_batch"]), top_k=int(s["top_k"]), device=ctx.device))
    if ctx.fault is not None:
        ctx.fault(svc)
    try:
        for i in range(int(t["warm_requests"])):
            svc.compute(pool[i % len(pool)])
        if ctx.device != "cpu":
            torch.cuda.synchronize()
        ctx.setup_done()
        done = _window(ctx, svc, pool)
        ctx.read_memory_peak()
    finally:
        svc.close()
    del svc
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    lat = [r["latency_s"] * 1e3 for r in done]
    ctx.attempted = len(done)
    ctx.failed = sum(1 for r in done if r["error"])
    ctx.end_to_end["latency_p50_ms"] = (statistics.median(lat), "ms")
    ctx.end_to_end["latency_p95_ms"] = (statistics.quantiles(lat, n=20)[18], "ms")
    ctx.records["requests"] = done
    ctx.records["forward_flops"] = roofline.forward_flops(cfg, 1)
    ctx.records["fps_bound_s"] = roofline.fps_bound_s(cfg, 1)


def _request(svc, pool, i: int) -> dict:
    cloud = pool[i % len(pool)]
    t0 = time.perf_counter()
    try:
        reply, error = svc.compute(cloud), None
    except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
        reply, error = None, f"{type(e).__name__}: {e}"
    return {"capture": i % len(pool), "latency_s": time.perf_counter() - t0, "reply": reply, "error": error,
            "traced": False}


def _window(ctx, svc, pool) -> list:
    """The measured window: every request that ended inside it, in order;
    with `--trace 1`, `trace_requests` of them profiled from a third of
    the window on."""
    t = ctx.traffic
    start = time.perf_counter()
    deadline, trace_from = start + ctx.seconds, start + ctx.seconds / 3
    done: list = []
    i = 0
    while time.perf_counter() < deadline:
        if ctx.trace and "trace" not in ctx.records and time.perf_counter() >= trace_from:
            n = int(t["trace_requests"])
            with trace.Traced(ctx.tmp) as tr:
                rows = [_request(svc, pool, i + k) for k in range(n)]
            for r in rows:
                r["traced"] = True
            ctx.records["trace"] = trace.summarize(tr.path)
            ctx.records["traced_requests"] = n
            os.remove(tr.path)
        else:
            rows = [_request(svc, pool, i)]
        i += len(rows)
        done.extend(rows)
    return done


def check(ctx) -> None:
    """The reference's answer to each sampled capture against the program's
    last reply to it in the window."""
    from benchmark.reference import gn, judge

    s = serving(ctx)
    pool = ctx.records["pool"]
    last = {}
    for r in ctx.records["requests"]:
        if r["reply"] is not None:
            last[r["capture"]] = r["reply"]
    rng = np.random.default_rng([ctx.seed & 0xFFFFFFFF, ctx.seed >> 32 & 0xFFFFFFFF, 0xC4EC])
    k = min(int(ctx.traffic["check_captures"]), len(last))
    sample = sorted(rng.choice(sorted(last), k, replace=False).tolist())
    ref = judge.Reference(harness.model_config(ctx.model_fields(), gn), ctx.records.pop("weights"), ctx.device)
    gap, diff = 0.0, 0
    for c in sample:
        reply = last[c]
        got = np.asarray(reply["grasps"], np.float32).reshape(-1, 17) if reply.get("ok") else np.zeros((0, 17))
        ref_all, ref_sel = judge.service_reply(ref, pool[c], s)
        if ref_sel is None:
            ref_sel = np.zeros((0, 17), np.float32)
        g, d = judge.compare(got, ref_all, ref_sel)
        gap, diff = max(gap, g), diff + d
    ctx.check("rows_gap", gap)
    ctx.check("selection_diff", diff)
    ctx.check("failed_requests", ctx.failed)
