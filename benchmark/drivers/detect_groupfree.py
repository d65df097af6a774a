"""One ScanNet evaluation client in a closed loop on `DetectionPipeline`
(apps/detect.py) serving Group-Free-3D.

As `drivers/detect.py` (whose pool, request and trace helpers it uses):
the client hands the pipeline a batch of room scans, waits for each scan's
boxes on the host and sends the next; the scans are a pool drawn from the
seed, batched and cycled in pool order.  The traffic parameters are that
driver's: `scans`, `points`, `batch_size`, `warm_requests`,
`trace_requests`, `check_batches`.

Each request is timed on the host clock from the hand-over of the batch
to the return of its boxes.  A `--trace 1` run records the spans of its
profiled stretch, prints the counts of `detect.kps`, `detect.decoder`,
`detect.boxes` and `detect.nms` and the attention kernel's launches, and
keeps the device time of the kernels launched inside `detect.decoder`.
The reference (`reference/gf.py`) judges the last result of each of the
first `check_batches` batches in the window: `head_gap` (the last head's
raw channels), `box_gap` (every proposal's corners and scores) and
`selection_diff` (`reference/gf.py::compare`: the program's decisions
exactly, on its own numbers; the heads' size classes, which the reference
follows within the `head_gap` limit of its own maximum).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import statistics
import sys
import time

import numpy as np

from benchmark import harness, roofline_groupfree, trace
from benchmark.drivers.detect import _kernel_seconds_under, _request, batches
from benchmark.reference.gf import Detector
from benchmark.weights import make_weights

COUNTED_SPANS = ("detect.kps", "detect.decoder", "detect.boxes", "detect.nms")


def detector(ctx) -> Detector:
    return Detector.from_fields(ctx.overrides.get("detector", ctx.config["detector"]))


def program_config(ctx):
    """The configuration file's model and detector as the program's
    GroupFreeConfig (whose decoder and post-processing fields are
    `Detector`'s)."""
    from graspnet_tpu_torch import config as program_config

    g = harness.model_config(ctx.model_fields(), program_config)
    backbone = {f: getattr(g, f) for f in ("num_point", "input_feature_dim", "sa1", "sa2", "sa3", "sa4",
                                           "fp1_mlp", "fp2_mlp", "bn_eps")}
    return program_config.GroupFreeConfig(**backbone, **dataclasses.asdict(detector(ctx)))


def groupfree_weights(shapes, seed: int, device):
    """The cell's seeded weights: `weights.make_weights`'s scheme (Kaiming-
    normal kernels, zero biases, identity norms), then, as the published
    `GroupFreeDetector.init_weights` does, every decoder matrix (attention
    projections, feed-forward, the position embeddings' convolutions)
    redrawn Xavier-uniform, U(+-sqrt(6 / (fan_in + fan_out))), in one call
    of a generator on the device seeded `seed` + 1."""
    import torch

    out = make_weights(shapes, seed, device)
    names = [k for k in shapes if k.startswith("decoder.") and k.endswith("kernel")]
    sizes = [math.prod(shapes[k]) for k in names]
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed + 1)
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    for k, part in zip(names, torch.split(flat, sizes)):
        fan_in, fan_out = shapes[k]
        out[k] = ((part.reshape(shapes[k]) * 2 - 1) * math.sqrt(6.0 / (fan_in + fan_out))).contiguous()
    return out


def weights(ctx, cfg):
    from graspnet_tpu_torch.models.groupfree import GroupFree3D

    shapes = {k: tuple(v.shape) for k, v in GroupFree3D(cfg).state_dict().items()}
    return groupfree_weights(shapes, ctx.weight_seed(), ctx.device)


def run(ctx) -> None:
    import torch
    from graspnet_tpu_torch import checkpoint
    from graspnet_tpu_torch.apps.detect import DetectionPipeline

    t = ctx.traffic
    cfg = program_config(ctx)
    pool = batches(ctx)
    ctx.records["batches"] = pool
    w = weights(ctx, cfg)
    path = os.path.join(ctx.tmp, "weights.pt")
    checkpoint.save(path, {k: v.to("cpu") for k, v in w.items()})
    ctx.records["weights"] = w
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
    n_check = min(int(t["check_batches"]), len(pool))
    ctx.records["returned"] = {b: (np.stack([d.rows for d in dets]), handle.end_points["head"].cpu().numpy(),
                                   handle.end_points["size_cls_layers"].cpu().numpy())
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
    ctx.records["forward_flops"] = roofline_groupfree.forward_flops(cfg, detector(ctx), batch)
    ctx.records["attn_bound_s"] = roofline_groupfree.attention_bound_s(cfg, detector(ctx), batch)


def _attention_launches() -> int:
    from graspnet_tpu_torch.ops.cuda import launches

    return int(launches().get("attention", 0))


def _window(ctx, pipe, pool):
    """The measured window, as `drivers/detect.py`'s: every request that
    ended inside it and the last result of each batch of the pool; with
    `--trace 1`, `trace_requests` of them profiled from a third of the
    window on."""
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
            before = _attention_launches()
            with tracing.recording() as rec, trace.Traced(ctx.tmp) as tr:
                rows = [_request(pipe, pool, i + k, last) for k in range(n)]
            for r in rows:
                r["traced"] = True
            ctx.records["attention_launches"] = _attention_launches() - before
            ctx.records["trace"] = trace.summarize(tr.path)
            ctx.records["traced_requests"] = n
            ctx.records["span_counts"] = _counts(rec.drain())
            ctx.records["decoder_device_s"] = _kernel_seconds_under(tr.path, ("detect.decoder",))
            os.remove(tr.path)
        else:
            rows = [_request(pipe, pool, i, last)]
        i += len(rows)
        done.extend(rows)
    return done, last


def _counts(spans) -> dict:
    """The counted spans' counts, summed by span, and how many of each closed."""
    out: dict = {}
    for s in spans:
        if s.name in COUNTED_SPANS:
            into = out.setdefault(s.name, {"spans": 0})
            into["spans"] += 1
            for k, v in s.counts.items():
                into[k] = into.get(k, 0) + v
    return out


def check(ctx) -> None:
    """The reference's proposals for each checked batch against what the
    program's last request of it returned in the window."""
    import torch

    from benchmark.reference import gf, gn, judge

    det = detector(ctx)
    ref = gf.GroupFree(harness.model_config(ctx.model_fields(), gn), det, ctx.records.pop("weights"), ctx.device)
    totals = {"head_gap": 0.0, "box_gap": 0.0, "selection_diff": 0}
    for b, (rows, head, size_cls) in sorted(ctx.records["returned"].items()):
        x = torch.as_tensor(ctx.records["batches"][b], device=ctx.device)
        with judge.precision("float32"):
            out = ref.forward(x, follow=size_cls, tie=ctx.limits["head_gap"])
            res = gf.parse_predictions(out, x[..., :3], det, ref.mean_size)
        got = gf.compare(rows, head, out["head"].cpu().numpy(), res, x[..., :3], det)
        for k, v in got.items():
            totals[k] = max(totals[k], v) if k.endswith("_gap") else totals[k] + v
    counts = ctx.records.get("span_counts")
    print(f"detect_groupfree: checked batches {sorted(ctx.records['returned'])}"
          + (f", over the traced stretch span counts {counts}, attention launches "
             f"{ctx.records.get('attention_launches')}" if counts else ""), file=sys.stderr)
    if not ctx.records["returned"]:
        totals["selection_diff"] = float("inf")
    for name, value in totals.items():
        ctx.check(name, value)
    ctx.check("failed_requests", ctx.failed)
