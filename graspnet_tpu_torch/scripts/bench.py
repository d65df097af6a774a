"""Serving benchmark, the counterpart of `bench.py`: single-frame grasp
inference through `GraspPipeline` (network -> decode -> NMS -> top-50, only
the (50, 17) rows leave the card).

    python -m graspnet_tpu_torch.scripts.bench

Prints ONE JSON line with `bench.py`'s keys: sustained frames/s with every
frame's rows fetched (the median of `--repeats` blocks of `--frames`
frames, each run kept in `observed_spread`), p50 synchronous latency, the
last-only time of a burst, and the warm-up (kernel build) time.  The input
is a seeded random cloud (`image_demo.load_frame` is not ported yet).  It
sets no target: `vs_baseline` is null, and `gpu` names the card and its
power limit.  `--device cpu --tiny` runs it on the CPU at
`GraspNetConfig.tiny()`, for the tests; `backend` then says "cpu" and no
number in the line is a device number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional, Sequence

import numpy as np

from graspnet_tpu_torch.apps import GraspPipeline
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.utils.timing import gpu_name_and_power


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() instead of GraspNetConfig()")
    ap.add_argument("--frames", type=int, default=30, help="frames per sustained block")
    ap.add_argument("--repeats", type=int, default=5, help="sustained blocks")
    ap.add_argument("--sync-frames", type=int, default=10, help="frames of the p50 latency")
    args = ap.parse_args(argv)
    cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig()
    pipe = GraspPipeline(cfg=cfg, seed=0, device=args.device)
    compile_s = pipe.warmup()
    cloud = np.random.default_rng(0).uniform(-0.5, 0.5, (cfg.num_point, 3)).astype(np.float32)
    x = pipe._cloud(cloud[None])

    def one_frame():
        rows, vmask = pipe._infer_topk(x)
        return rows[0].cpu(), vmask[0].cpu()

    one_frame()
    times = []
    for _ in range(args.sync_frames):
        t0 = time.perf_counter()
        one_frame()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)

    def sustained_once():
        """Queue `frames` frames, then fetch every frame's rows."""
        t0 = time.perf_counter()
        outs = [pipe._infer_topk(x) for _ in range(args.frames)]
        results = [(rows.cpu().numpy(), vmask.cpu().numpy()) for rows, vmask in outs]
        if len(results) != args.frames or results[-1][0].shape[-1] != 17:
            raise RuntimeError("a sustained block lost frames")
        return (time.perf_counter() - t0) / args.frames

    runs = [sustained_once() for _ in range(args.repeats)]
    fps_runs = [1.0 / d for d in runs]
    drained = statistics.median(runs)

    t0 = time.perf_counter()
    outs = [pipe._infer_topk(x) for _ in range(10)]
    outs[-1][1].cpu()
    last_only = (time.perf_counter() - t0) / 10

    result = {
        "metric": f"frames/s sustained ({cfg.num_point}-pt cloud, decode + NMS + top-50 on "
        "device, every result fetched to the host)",
        "value": 1.0 / drained,
        "unit": "frames/s",
        "vs_baseline": None,
        "p50_sync_ms": p50 * 1000,
        "drained_ms": drained * 1000,
        "pipelined_last_only_ms": last_only * 1000,
        "observed_spread": {"frames_per_s_runs": fps_runs, "min": min(fps_runs), "max": max(fps_runs)},
        "compile_s": compile_s,
        "backend": pipe.device.type,
        "gpu": gpu_name_and_power() if pipe.device.type == "cuda" else None,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
