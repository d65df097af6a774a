"""Service throughput under concurrent load, micro-batching off and on; the
counterpart of `scripts/bench_service.py`.

    python -m graspnet_tpu_torch.scripts.bench_service [--requests 160] [--clients 16] [--out FILE]
    python -m graspnet_tpu_torch.scripts.bench_service --learnable DIR --checkpoint CKPT

Drives `GraspService.compute()` (the core the TCP and ROS wrappers call)
from `--clients` concurrent request threads over production-shape requests
(250k-point raw capture clouds: depth filter, sample, inference, collision
filter, sort and NMS per request) and reports sustained requests/s with
max_batch=1 (one forward per request) and max_batch=8 (the MicroBatcher
coalescing requests into batched forwards).  compute() is driven in-process
(the ROS consumer's call path) rather than over TCP, so the measurement is
the serving pipeline, not JSON encoding of 250k points.

`--learnable DIR` is the success-path mode: the tiny 1024-point config
(`scripts/learnability_gate.py::gate_config`), requests drawn from the
learnable test scene in DIR (generated when absent) and a learnability-gate
`--checkpoint`, so replies carry real grasps (extract, NMS and TF inside
the timed loop).  Under random weights every decoded grasp may collide, and
the "no valid grasp" reply still pays the full inference, collision and NMS
work.

Prints one JSON object with the JAX script's keys (`value` in requests/s
at max_batch=8, `speedup_vs_unbatched`, `modes[]` with `device_dispatches`)
and, per mode, each kernel's launches per dispatch; `gpu` names the card
and its power limit.  Runs on the card unless `--device cpu`; `--tiny`
runs `GraspNetConfig.tiny()` on small clouds, for the tests, and no number
is then a device number.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.ops import cuda as kernels
from graspnet_tpu_torch.utils.timing import gpu_name_and_power


def make_clouds(n_frames: int, n_points: int, seed: int = 0) -> list:
    """Table plane + object blobs in the service's depth window."""
    rng = np.random.default_rng(seed)
    clouds = []
    for _ in range(n_frames):
        table = rng.uniform(-0.3, 0.3, (n_points * 3 // 4, 3)).astype(np.float32)
        table[:, 2] = rng.uniform(0.55, 0.58, len(table))
        objs = rng.uniform(-0.1, 0.1, (n_points // 4, 3)).astype(np.float32)
        objs[:, 2] = rng.uniform(0.4, 0.5, len(objs))
        clouds.append(np.concatenate([table, objs]))
    return clouds


def make_learnable_clouds(n_frames: int, root: str, cfg: GraspNetConfig) -> list:
    """Request clouds drawn from the learnable test scene under `root`
    (generated when absent): paired with the learnability gate's checkpoint
    they make requests return grasps."""
    from graspnet_tpu_torch.data.dataset import GraspNetDataset
    from graspnet_tpu_torch.data.learnable import make_learnable_dataset

    if not os.path.isdir(os.path.join(root, "scenes")):
        make_learnable_dataset(root, cfg=cfg)
    ds = GraspNetDataset(root, camera="realsense", split="test_seen", num_points=cfg.num_point,
                         remove_outlier=True, load_label=False, cfg=cfg)
    return [ds.get_raw_cloud(i % len(ds)).copy() for i in range(n_frames)]


def run_mode(max_batch: int, clouds: list, clients: int, collision_thresh: float, checkpoint_path=None,
             model_cfg: Optional[GraspNetConfig] = None, num_point: int = 20000, device: str = "cuda") -> dict:
    """One service at `max_batch`: one warm-up request, then every cloud
    from `clients` threads; requests/s, ok replies, dispatches and each
    kernel's launches per dispatch over the timed requests."""
    svc = GraspService(ServiceConfig(collision_thresh=collision_thresh, max_batch=max_batch, batch_wait_ms=3.0,
                                     checkpoint_path=checkpoint_path, model_cfg=model_cfg, num_point=num_point,
                                     device=device))
    try:
        svc.compute(clouds[0])  # the first request's host and device work, off the clock
        d0 = svc.batcher.dispatches if svc.batcher else 0
        kernels.reset_launches()
        tic = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=clients) as pool:
            outs = list(pool.map(svc.compute, clouds))
        wall = time.perf_counter() - tic
        launches = kernels.launches()
        dispatches = svc.batcher.dispatches - d0 if svc.batcher else len(clouds)
    finally:
        svc.close()
    return {
        "max_batch": max_batch,
        "requests": len(clouds),
        "ok": sum(1 for o in outs if o.get("ok")),
        "wall_s": wall,
        "requests_per_s": len(clouds) / wall,
        "ms_per_request_sustained": wall / len(clouds) * 1000,
        "device_dispatches": dispatches,
        "launches_per_dispatch": {k: v / dispatches for k, v in launches.items()},
    }


def run(clouds: list, clients: int, collision_thresh: float, *, checkpoint_path=None,
        model_cfg: Optional[GraspNetConfig] = None, num_point: int = 20000, device: str = "cuda",
        learnable: bool = False) -> dict:
    """Both modes (max_batch 1, then 8) over the same clouds."""
    rows = [run_mode(mb, clouds, clients, collision_thresh, checkpoint_path=checkpoint_path, model_cfg=model_cfg,
                     num_point=num_point, device=device) for mb in (1, 8)]
    base, batched = rows
    if learnable:
        metric = (f"service success-path throughput, {clients} concurrent clients, learnable-scene requests + "
                  "trained checkpoint (every reply carries real grasps: extract + NMS + TF inside the timed loop)")
    else:
        metric = (f"service sustained throughput, {clients} concurrent clients, {len(clouds[0])}-pt requests, "
                  f"collision filter {'on' if collision_thresh > 0 else 'off'}")
    dev = torch.device(device)
    return {
        "metric": metric,
        "value": batched["requests_per_s"],
        "unit": "requests/s",
        "speedup_vs_unbatched": batched["requests_per_s"] / base["requests_per_s"],
        "modes": rows,
        "backend": dev.type,
        "gpu": gpu_name_and_power() if dev.type == "cuda" else None,
        "source": "graspnet_tpu_torch/scripts/bench_service.py",
        "note": "compute() driven in-process from concurrent threads (the ROS-consumer call path); max_batch=8 "
                "coalesces requests into batched forwards via apps/batching.MicroBatcher.",
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=160)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--points", type=int, default=250_000)
    ap.add_argument("--collision_thresh", type=float, default=0.01)
    ap.add_argument("--checkpoint", default=None, help="trained checkpoint so requests return grasps (ok > 0)")
    ap.add_argument("--learnable", default=None, metavar="DIR",
                    help="tiny-config success-path mode: request clouds from the learnable test scene in DIR "
                    "(generated if absent), paired with a learnability-gate --checkpoint")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() on small clouds (tests)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    model_cfg, num_point, points = None, 20000, args.points
    if args.learnable:
        from graspnet_tpu_torch.scripts.learnability_gate import gate_config

        model_cfg = gate_config()
        num_point = model_cfg.num_point
        clouds = make_learnable_clouds(args.requests, args.learnable, model_cfg)
    else:
        if args.tiny:
            model_cfg, points = GraspNetConfig.tiny(), min(points, 4000)
            num_point = model_cfg.num_point
        clouds = make_clouds(args.requests, points)
    result = run(clouds, args.clients, args.collision_thresh, checkpoint_path=args.checkpoint, model_cfg=model_cfg,
                 num_point=num_point, device=args.device, learnable=bool(args.learnable))
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return result


if __name__ == "__main__":
    main()
