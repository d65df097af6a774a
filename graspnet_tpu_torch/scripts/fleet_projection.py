"""Fleet-serving throughput model: requests/s against `data_devices`; the
counterpart of `scripts/fleet_projection.py`.

    python -m graspnet_tpu_torch.scripts.fleet_projection [--out FILE]

1. Measured on the card: the batched decode + NMS + top-K time at B in
   {1, 2, 4, 8} (`GraspPipeline._infer_topk`, `--k` calls queued, every
   result fetched), the per-dispatch overhead (a synchronous single frame
   against the drained per-frame time) and the host-to-card copy of one
   frame's cloud.
2. Measured on the host: the coalescing occupancy (mean batch fill over
   max_batch) of the real `GraspService` + `MicroBatcher` with
   `data_devices=8` under 16 concurrent clients, at `GraspNetConfig.tiny()`
   on the CPU repeated eight times: the batching logic a fleet would run,
   without its cards.
3. Projected, and marked so: a coalesced batch of B = D frames runs one
   frame a card, so t_batch(D) = t_frame + t_dispatch + D * t_copy_frame and
   requests/s(D) = occupancy * D / t_batch(D), from the numbers of 1 and 2
   only.  No constant of another device enters it; no multi-card run
   stands behind it.

Prints one JSON object; `gpu` names the card and its power limit.
`--device cpu --tiny` runs the measured half on the CPU for the tests, and
no number is then a device number.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import time
from typing import Optional, Sequence

import numpy as np

from graspnet_tpu_torch.apps.pipeline import GraspPipeline
from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.utils.timing import gpu_name_and_power

FLEET = (1, 2, 4, 8, 16)


def measure_device(cfg: GraspNetConfig, device: str, batches=(1, 2, 4, 8), k: int = 20) -> dict:
    pipe = GraspPipeline(cfg=cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    rows = {}
    for b in batches:
        x = pipe._cloud(rng.uniform(-0.5, 0.5, (b, cfg.num_point, 3)).astype(np.float32))
        pipe._infer_topk(x)[0].cpu()  # warm-up
        t0 = time.perf_counter()
        outs = [pipe._infer_topk(x) for _ in range(k)]
        got = [(r.cpu(), v.cpu()) for r, v in outs]
        assert len(got) == k
        per_batch = (time.perf_counter() - t0) / k
        rows[b] = {"ms_per_batch": per_batch * 1000, "ms_per_frame": per_batch / b * 1000}
    x1 = pipe._cloud(rng.uniform(-0.5, 0.5, (1, cfg.num_point, 3)).astype(np.float32))
    t0 = time.perf_counter()
    for _ in range(10):
        pipe._infer_topk(x1)[0].cpu()
    sync_ms = (time.perf_counter() - t0) / 10 * 1000
    frame = rng.uniform(-0.5, 0.5, (cfg.num_point, 3)).astype(np.float32)
    t0 = time.perf_counter()
    for _ in range(10):
        pipe._cloud(frame[None]).sum().item()
    copy_ms = (time.perf_counter() - t0) / 10 * 1000
    return {"rows": rows, "sync_single_frame_ms": sync_ms, "copy_frame_ms": copy_ms}


def measure_occupancy(requests: int = 64, clients: int = 16, max_batch: int = 8) -> dict:
    svc = GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), num_point=512, collision_thresh=-1.0,
                                     data_devices=max_batch, max_batch=max_batch, batch_wait_ms=3.0,
                                     device="cpu"))
    rng = np.random.default_rng(0)
    clouds = [rng.uniform(-0.3, 0.3, (2048, 3)).astype(np.float32) + np.float32([0, 0, 0.45])
              for _ in range(requests)]
    try:
        svc.compute(clouds[0])  # warm
        d0, f0 = svc.batcher.dispatches, svc.batcher.frames
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=clients) as pool:
            outs = list(pool.map(svc.compute, clouds))
        wall = time.perf_counter() - t0
        d, frames = svc.batcher.dispatches - d0, svc.batcher.frames - f0
    finally:
        svc.close()
    return {"requests": requests, "dispatches": d, "mean_batch_fill": frames / max(d, 1),
            "occupancy": frames / max(d, 1) / max_batch, "wall_s": wall,
            "errors": sum(1 for o in outs if "error" in o)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() for the measured half (tests)")
    ap.add_argument("--k", type=int, default=20, help="queued calls per batch size")
    args = ap.parse_args(argv)
    cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig()
    dev = measure_device(cfg, args.device, k=args.k)
    frame_ms = dev["rows"][1]["ms_per_frame"]
    dispatch_ms = max(dev["sync_single_frame_ms"] - frame_ms, 0.0)
    occ = measure_occupancy()
    curve = {d: occ["occupancy"] * d * 1000.0 / (frame_ms + dispatch_ms + d * dev["copy_frame_ms"])
             for d in FLEET}
    result = {
        "metric": "fleet serving projection: requests/s against data_devices",
        "measured_device_times": dev["rows"],
        "sync_single_frame_ms": dev["sync_single_frame_ms"],
        "dispatch_overhead_ms": dispatch_ms,
        "copy_frame_ms": dev["copy_frame_ms"],
        "occupancy_cpu_mesh": occ,
        "projection_requests_per_s": curve,
        "projection": True,
        "model": "t_batch(D) = t_frame (B=1 drained) + t_dispatch + D * t_copy_frame; requests/s = "
        "occupancy * D / t_batch(D); every term measured in this run, no multi-card run behind the curve",
        "backend": args.device,
        "gpu": gpu_name_and_power() if args.device != "cpu" else None,
        "source": "graspnet_tpu_torch/scripts/fleet_projection.py",
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
