"""App-level eval throughput, the counterpart of `scripts/bench_test_app.py`.

    python -m graspnet_tpu_torch.scripts.bench_test_app [--frames 200] [--batch_sizes 1,4,8] [--out FILE]

Runs the `apps/test.py::inference` loop (frames read ahead on threads,
batched inference on the card, the collision filter and the dump on
postproc threads) over synthetic production-shape frames whose raw clouds
hold 250k points, so the voxel downsample and the collision filter cost
what a real capture makes them cost (reference test.py:92-96 filters
against the full-resolution cloud).  For each batch size it reports the
wall ms/frame over all `--frames` frames and the stage means (they overlap
across threads and do not sum to the wall time), each kernel's launches per
batch (the warm-up forward taken off), and, on the card, the device's busy
time over 3 batches (`profile_batches`) of the same loop under
torch.profiler (`--profile_dir`'s trace) and its idle share, over that
run's wall time (`device_idle_share`: the loop's start and the profiler
included) and over the unprofiled run's ms/batch
(`device_idle_share_sustained`).  Random weights from
`--weight_seed` (1: every seed point valid at `GraspNetConfig()`, so the
filter has 1024 grasps a frame to test).  `gpu` names the card and its
power limit.  `--device cpu --tiny` runs it on the CPU at
`GraspNetConfig.tiny()` with small clouds, for the tests; no number is then
a device number.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.apps import test as test_app
from graspnet_tpu_torch.data.synthetic import SyntheticGraspNetDataset
from graspnet_tpu_torch.models import GraspNet, init_weights
from graspnet_tpu_torch.ops import cuda as kernels
from graspnet_tpu_torch.utils.timing import cli, gpu_name_and_power
from graspnet_tpu_torch.utils.tracing import TRACE_FILE

DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")  # chrome-trace categories of device work


def loop_args(dump_dir: str, checkpoint_path: str, cfg, bs: int, frames: int, collision_thresh: float,
              device: torch.device, profile_dir: Optional[str] = None) -> argparse.Namespace:
    """`apps/test.py`'s arguments for the synthetic dataset."""
    return argparse.Namespace(
        dataset_root="<synthetic>", camera="kinect", split="train", checkpoint_path=checkpoint_path,
        dump_dir=dump_dir, num_point=cfg.num_point, collision_thresh=collision_thresh, voxel_size=0.01,
        batch_size=bs, max_frames=frames, profile_dir=profile_dir, device=str(device))


def device_busy_ms(trace_path: str) -> float:
    """Summed duration of the device's events in a chrome trace, in ms."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("dur", 0) for e in events if e.get("cat") in DEVICE_EVENTS) / 1e3


def make_dataset(cfg, frames: int, cloud_points: int = 250_000) -> SyntheticGraspNetDataset:
    """The synthetic frames: one tabletop scene of `cloud_points` raw
    points, sampled to cfg.num_point per frame; no label slabs."""
    return SyntheticGraspNetDataset(n_frames=frames, cloud_points=cloud_points, num_points=cfg.num_point, cfg=cfg,
                                    augment=False, with_labels=False)


def run(cfg, device: torch.device, work: str, *, frames: int = 200, batch_sizes=(1, 4, 8),
        collision_thresh: float = 0.01, cloud_points: int = 250_000, weight_seed: int = 1,
        profile_batches: int = 3) -> dict:
    """The loop at each batch size over one synthetic dataset; the weights
    (`work`/weights.pt) and each batch size's dump (`work`/dump_b<bs>)
    stay in `work`."""
    t0 = time.perf_counter()
    ds = make_dataset(cfg, frames, cloud_points)
    gen_s = time.perf_counter() - t0
    weights = os.path.join(work, "weights.pt")
    checkpoint.save(weights, init_weights(GraspNet(cfg), weight_seed).state_dict())

    rows = []
    for bs in batch_sizes:
        dump_dir = os.path.join(work, f"dump_b{bs}")
        kernels.reset_launches()
        stats = test_app.inference(loop_args(dump_dir, weights, cfg, bs, frames, collision_thresh, device), cfg,
                                   dataset=ds)
        forwards = math.ceil(frames / bs) + 1  # the batches and the warm-up
        launches = kernels.launches()
        dumped = sum(len(fs) for _, _, fs in os.walk(dump_dir))
        if dumped != frames:
            raise RuntimeError(f"batch {bs}: {dumped} frames dumped, expected {frames}")
        row = {
            "batch_size": bs,
            "ms_per_frame": stats["ms_per_frame"],
            "warmup_s": stats["compile_s"],
            "stages_ms": stats["stages_ms"],
            "launches": launches,
            "launches_per_batch": {k: v / forwards for k, v in launches.items()},
            "device_busy_ms_per_batch": "not measured",
            "profiled_wall_ms_per_batch": "not measured",
            "device_idle_share": "not measured",
            "device_idle_share_sustained": "not measured",
        }
        if device.type == "cuda":
            with tempfile.TemporaryDirectory(prefix="bench_test_app_trace_") as prof_dir:
                n = profile_batches * bs
                prof = test_app.inference(
                    loop_args(os.path.join(prof_dir, "dump"), weights, cfg, bs, n, collision_thresh, device,
                              profile_dir=prof_dir), cfg, dataset=ds)
                busy = device_busy_ms(os.path.join(prof_dir, TRACE_FILE))
            if busy > 0:
                row["device_busy_ms_per_batch"] = busy / profile_batches
                row["profiled_wall_ms_per_batch"] = prof["total_s"] * 1e3 / profile_batches
                row["device_idle_share"] = 1 - busy / (prof["total_s"] * 1e3)
                row["device_idle_share_sustained"] = 1 - row["device_busy_ms_per_batch"] / (stats["ms_per_frame"] * bs)
        rows.append(row)
    best = min(rows, key=lambda r: r["ms_per_frame"])
    return {
        "metric": "apps/test.py eval throughput (synthetic frames, collision filter and dump on)",
        "value": best["ms_per_frame"],
        "unit": "ms/frame",
        "best_batch_size": best["batch_size"],
        "per_batch_size": rows,
        "frames": frames,
        "cloud_points": cloud_points,
        "datagen_s": gen_s,
        "checkpoint_path": weights,
        "backend": device.type,
        "gpu": gpu_name_and_power() if device.type == "cuda" else None,
        "source": "graspnet_tpu_torch/scripts/bench_test_app.py",
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    def own(ap):
        ap.add_argument("--frames", type=int, default=200)
        ap.add_argument("--batch_sizes", default="1,4,8")
        ap.add_argument("--collision_thresh", type=float, default=0.01)
        ap.add_argument("--weight_seed", type=int, default=1)

    args, cfg, dev = cli(__doc__.splitlines()[0], argv, own)
    sizes = tuple(int(x) for x in args.batch_sizes.split(","))
    with tempfile.TemporaryDirectory(prefix="bench_test_app_") as work:
        result = run(cfg, dev, work, frames=args.frames, batch_sizes=sizes, collision_thresh=args.collision_thresh,
                     cloud_points=4000 if args.tiny else 250_000, weight_seed=args.weight_seed)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return result


if __name__ == "__main__":
    main()
