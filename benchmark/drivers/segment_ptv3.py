"""One ScanNet semantic-segmentation client in a closed loop on
`SegmentationPipeline` (apps/segment.py) serving Point Transformer V3.

The client hands the pipeline a batch of grid-sampled room fragments,
waits for every point's logits and labels on the host and sends the next,
as a ScanNet evaluation sweep or an indoor mapping robot that labels its
room scans does.  The fragments are a pool drawn from the seed
(`inputs/rooms_seg.py`), batched and cycled in pool order, so every seed
gives the same shapes.  Traffic parameters (the cell's file):

- `fragments`, `points`, `scene_points`, `batch_size`: the pool, the
  most points a fragment (the crop), the range of the scene sizes drawn
  before the crop (stratified: a batch's fragments draw from its
  `batch_size` equal parts, one each), and the fragments of a request;
- `warm_requests`: requests before the window, off the clock;
- `trace_requests`: requests of the profiled stretch of a `--trace 1`
  run, from a third of the window on;
- `check_batches`: batches of the pool whose last result in the window the
  reference judges (the first ones).

Each request is timed on the host clock from the hand-over of the batch
to the labels' arrival on the host.  A reply carries the request's spans
by name in `timings_ms` (`segment.dispatch`, `segment.serialize`,
`segment.kmap`, `segment.fetch`).  A `--trace 1` run records the spans of
its profiled stretch, prints the counts of `segment.serialize` and
`segment.kmap` and the attention's and convolution's launches, and keeps
the device time of the kernels launched inside the serialize and kmap
spans.  The reference (`reference/ptv3.py`) judges the last result of each
of the first `check_batches` batches in the window: `logit_gap` (every
point's logits), `label_diff` (labels that score more than the
`logit_gap` limit below the reference's best) and `order_diff` (every
stage's orders, pooling clusters and neighbour maps, and the stem's map,
exactly).
"""

from __future__ import annotations

import gc
import os
import statistics
import sys
import time

import numpy as np

from benchmark import harness, roofline_ptv3, trace
from benchmark.drivers.detect import _kernel_seconds_under
from benchmark.inputs.rooms_seg import fragment_pool
from benchmark.weights import make_weights

COUNTED_SPANS = ("segment.serialize", "segment.kmap")


def program_config(ctx):
    """The configuration file's model as the program's PTv3Config, which
    pools by stride 2 between every two stages and has no field for it."""
    from graspnet_tpu_torch.config import PTv3Config

    fields = dict(ctx.model_fields())
    stride = fields.pop("stride")
    if any(s != 2 for s in stride):
        raise ValueError(f"the program pools by stride 2 only, not {stride}")
    return PTv3Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})


def reference_config(ctx):
    from benchmark.reference.ptv3 import Config

    return Config.from_fields(ctx.model_fields())


def batches(ctx) -> list:
    t = ctx.traffic
    b = int(t["batch_size"])
    pool = fragment_pool(ctx.seed, int(t["fragments"]), int(t["points"]), tuple(int(n) for n in t["scene_points"]), b)
    return [pool[i: i + b] for i in range(0, len(pool) - b + 1, b)]


def weights(ctx):
    """The seeded weights at the names and shapes the reference derives
    from the configuration; the program loads them strictly."""
    from benchmark.reference.ptv3 import state_shapes

    return make_weights(state_shapes(reference_config(ctx)), ctx.weight_seed(), ctx.device)


def stage_stats(handle) -> dict:
    """`roofline_ptv3`'s stats of a batch: each stage's points, attention
    sequences' lengths and map hits, and the stem map's hits."""
    stages = []
    for st in handle.stages:
        lengths = np.diff(st.patches.starts.cpu().numpy()).tolist()
        stages.append({"n": st.n, "lengths": lengths, "hits": int((st.kmap >= 0).sum())})
    return {"stages": stages, "stem_hits": int((handle.stem >= 0).sum())}


def returned(handle, segs) -> dict:
    """What the reference judges, on the host."""
    return {"logits": np.concatenate([s.logits for s in segs]), "labels": np.concatenate([s.labels for s in segs]),
            "stem": handle.stem.cpu().numpy(),
            "stages": [{"order": st.order.cpu().numpy(), "kmap": st.kmap.cpu().numpy(),
                        **({"cluster": st.cluster.cpu().numpy()} if st.cluster is not None else {})}
                       for st in handle.stages]}


def run(ctx) -> None:
    import torch
    from graspnet_tpu_torch import checkpoint
    from graspnet_tpu_torch.apps.segment import Fragment, SegmentationPipeline

    t = ctx.traffic
    cfg = program_config(ctx)
    pool = [[Fragment(*f) for f in b] for b in batches(ctx)]
    ctx.records["batches"] = pool
    w = weights(ctx)
    path = os.path.join(ctx.tmp, "weights.pt")
    checkpoint.save(path, {k: v.to("cpu") for k, v in w.items()})
    ctx.records["weights"] = w
    pipe = SegmentationPipeline(cfg, device=ctx.device, checkpoint_path=path)
    if ctx.fault is not None:
        ctx.fault(pipe)
    for i in range(int(t["warm_requests"])):
        pipe.segment(pool[i % len(pool)])
    if ctx.device != "cpu":
        torch.cuda.synchronize()
    ctx.setup_done()
    done, last = _window(ctx, pipe, pool)
    ctx.read_memory_peak()
    n_check = min(int(t["check_batches"]), len(pool))
    stats = {b: stage_stats(handle) for b, (handle, _) in last.items()}
    ctx.records["returned"] = {b: returned(handle, segs) for b, (handle, segs) in last.items() if b < n_check}
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
    # per request: the untraced requests cycle the pool evenly; the traced stretch takes its own batches
    if stats:
        ctx.records["forward_flops"] = statistics.fmean(roofline_ptv3.forward_flops(cfg, s) for s in stats.values())
    traced = [stats[b] for b in ctx.records.get("traced_batches", []) if b in stats]
    if traced:
        ctx.records["attn_bound_s"] = statistics.fmean(roofline_ptv3.attention_bound_s(cfg, s) for s in traced)
        ctx.records["spconv_bound_s"] = statistics.fmean(roofline_ptv3.spconv_bound_s(cfg, s) for s in traced)


def _request(pipe, pool, i: int, last: dict) -> dict:
    b = i % len(pool)
    timings: dict = {}
    t0 = time.perf_counter()
    try:
        handle = pipe.dispatch(pool[b], timings)
        segs = pipe.finish(handle)
        last[b], error = (handle, segs), None
    except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
        error = f"{type(e).__name__}: {e}"
    latency = time.perf_counter() - t0
    reply = {"ok": error is None, "timings_ms": {k: v * 1e3 for k, v in timings.items()}}
    return {"batch": b, "latency_s": latency, "reply": reply, "error": error, "traced": False}


def _launches() -> dict:
    from graspnet_tpu_torch.ops.cuda import launches

    got = launches()
    return {k: int(got.get(k, 0)) for k in ("attention_varlen", "subm_conv", "kernel_map")}


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
            before = _launches()
            with tracing.recording() as rec, trace.Traced(ctx.tmp) as tr:
                rows = [_request(pipe, pool, i + k, last) for k in range(n)]
            for r in rows:
                r["traced"] = True
            after = _launches()
            ctx.records["launch_counts"] = {k: after[k] - before[k] for k in after}
            ctx.records["trace"] = trace.summarize(tr.path)
            ctx.records["traced_requests"] = n
            ctx.records["traced_batches"] = [r["batch"] for r in rows]
            ctx.records["span_counts"] = _counts(rec.drain())
            ctx.records["serialize_device_s"] = _kernel_seconds_under(tr.path, COUNTED_SPANS)
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
    """The reference's logits, orders, clusters and maps for each checked
    batch against what the program's last request of it returned in the
    window."""
    import torch

    from benchmark.reference import judge, ptv3

    model = ptv3.PTv3(reference_config(ctx), ctx.records.pop("weights"), ctx.device)
    tie = ctx.limits["logit_gap"]
    totals = {"logit_gap": 0.0, "label_diff": 0, "order_diff": 0}
    for b, got in sorted(ctx.records["returned"].items()):
        frags = ctx.records["batches"][b]
        grid = torch.from_numpy(np.concatenate([f.grid_coord for f in frags])).long().to(ctx.device)
        batch = torch.repeat_interleave(torch.arange(len(frags), device=ctx.device),
                                        torch.tensor([len(f.grid_coord) for f in frags], device=ctx.device))
        feat = torch.from_numpy(np.concatenate([f.feat for f in frags])).to(ctx.device)
        with judge.precision("float32"):
            want = model.forward(grid, batch, feat)
        res = ptv3.compare(torch.from_numpy(got["logits"]).to(ctx.device), torch.from_numpy(got["labels"]).to(ctx.device),
                           want["logits"], tie)
        totals["logit_gap"] = max(totals["logit_gap"], res["logit_gap"])
        totals["label_diff"] += res["label_diff"]
        totals["order_diff"] += ptv3.order_diff(got, want)
        del want
    print(f"segment_ptv3: checked batches {sorted(ctx.records['returned'])}"
          + (f", over the traced stretch span counts {ctx.records['span_counts']}, launches "
             f"{ctx.records.get('launch_counts')}" if ctx.records.get("span_counts") else ""), file=sys.stderr)
    if not ctx.records["returned"]:
        totals["order_diff"] = float("inf")
    for name, value in totals.items():
        ctx.check(name, value)
    ctx.check("failed_requests", ctx.failed)
