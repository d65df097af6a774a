"""Frames/s against device count for the two inference strategies; the
counterpart of `scripts/bench_scaling.py`.

    python -m graspnet_tpu_torch.scripts.bench_scaling [--devices cuda:0,cuda:1,...]

For n = 1, 2, 4, ... up to the length of the device list: data-parallel
inference (`parallel.data_parallel_infer`, n scenes, one a device) and
candidate-sharded inference (`parallel.candidate_sharded_infer`, one
scene's seeds over n devices), each timed on the host clock over `--reps`
calls with every result fetched (median).  The default list is every card
of the host.  A list may repeat a device (`cuda:0,cuda:0,cuda:0,cuda:0` on
a one-card host): each line says how many distinct devices it ran on, and
where that is fewer than n the number is the time of the sharded code
path on one device, not a scaling measurement.  One JSON line per (mode, n),
then a summary; `gpu` names the card and its power limit.  `--device cpu
--tiny` runs it on the CPU for the tests, and no number is then a device
number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.device import resolve_device
from graspnet_tpu_torch.models import GraspNet, init_weights
from graspnet_tpu_torch.parallel import candidate_sharded_infer, data_parallel_infer, make_mesh
from graspnet_tpu_torch.utils.timing import gpu_name_and_power


def _timed(fn, x, reps: int) -> float:
    fn(x)[0].cpu()  # warm-up: builds the kernels on first CUDA use
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        grasps, valid = fn(x)
        grasps.cpu(), valid.cpu()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def run(devices: Sequence[str], cfg: GraspNetConfig, reps: int = 5, seed: int = 0) -> List[dict]:
    """The (mode, n) records for n = 1, 2, 4, ... <= len(devices)."""
    for d in set(devices):
        resolve_device(d, "bench_scaling")
    model = init_weights(GraspNet(cfg), seed).to(devices[0]).eval().requires_grad_(False)
    rng = np.random.default_rng(seed)
    records = []
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    for n in sizes:
        distinct = len({str(torch.device(d)) for d in devices[:n]})
        label = "scaling" if distinct == n else "one card, repeated device: code path, not scaling"
        clouds = torch.from_numpy(rng.uniform(-0.3, 0.3, (n, cfg.num_point, 3)).astype(np.float32)).to(devices[0])
        infer = data_parallel_infer(model, cfg, make_mesh(n, ("data",), devices=devices))
        dt = _timed(infer, clouds, reps)
        records.append({"mode": "data_parallel", "n_devices": n, "devices_distinct": distinct, "what": label,
                        "frames_per_s": n / dt, "ms_per_batch": dt * 1000})
        print(json.dumps(records[-1]), flush=True)
        if cfg.num_seed % n == 0:
            cinfer = candidate_sharded_infer(model, cfg, make_mesh(n, ("candidate",), devices=devices))
            dt = _timed(cinfer, clouds[:1], reps)
            records.append({"mode": "candidate_parallel", "n_devices": n, "devices_distinct": distinct,
                            "what": label, "ms_per_frame": dt * 1000})
            print(json.dumps(records[-1]), flush=True)
    return records


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", default=None, help="comma-separated device list (default: every card)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu: the default list's kind")
    p.add_argument("--num_point", type=int, default=20000)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() (tests)")
    args = p.parse_args(argv)
    if args.devices:
        devices = args.devices.split(",")
    elif args.device == "cpu":
        devices = ["cpu"]
    else:
        resolve_device("cuda", "bench_scaling")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig(num_point=args.num_point)
    records = run(devices, cfg, args.reps)
    dp = [r for r in records if r["mode"] == "data_parallel"]
    summary = {
        "mode": "summary",
        "max_devices": dp[-1]["n_devices"],
        "devices_distinct": dp[-1]["devices_distinct"],
        "scaling_efficiency": dp[-1]["frames_per_s"] / (dp[0]["frames_per_s"] * dp[-1]["n_devices"]),
        "what": dp[-1]["what"],
        "backend": torch.device(devices[0]).type,
        "gpu": gpu_name_and_power() if torch.device(devices[0]).type == "cuda" else None,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
