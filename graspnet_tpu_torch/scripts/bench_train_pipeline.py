"""Sustained pipelined training with the real loader, the counterpart of
`scripts/bench_train_pipeline.py`.

    python -m graspnet_tpu_torch.scripts.bench_train_pipeline [--steps 20] [--workers 4] [--out FILE]

Runs the training CLI's loop (`apps/train.py::train`: loader worker threads
-> `Trainer.prepare` / `step_prepared` double buffering, compact labels,
then the eval pass and the checkpoint) for one epoch over a production-shape
synthetic dataset (`data/synthetic.py` at its defaults: 8 objects of 1600
label points, ~35k-point clouds; the eval batch's objects have 300), and
reports the sustained ms/step over `--steps` steps after `--warmup` steps
beside its parts, under the JAX script's keys:

  device_step_ms          slope-timed train step on a finished device batch
  stage1_ms               slope-timed pre-pass (backbone + approach, no grad)
  host_prep_ms_per_scene  one `get_data_label` call (a loader worker's work)
  finalize_ms_per_batch   phase B, the matched labels (critical path)
  rpc_floor_ms            p50 of a tiny host -> card -> host round trip
  launches                each kernel's launches along the loop (the train
                          steps and the eval pass)

Between the warm-up and the timed steps the loop takes PROFILE_STEPS
steps, on the card under torch.profiler, and one step that absorbs the
profiler's stop; the script reports the device's busy time and idle share
over that window of the loop itself, loader threads running (they work
5 batches ahead, so only an epoch's last 5 steps find them done):
`device_busy_ms_per_step`, `profiled_wall_ms_per_step` (the window's step
time, profiler overhead included), `device_idle_share` (busy over that
wall) and `device_idle_share_sustained` (busy over the sustained ms/step of
the same loop's unprofiled steps: the profiler slows a host-bound loop, so
this one is nearer the loop's own); "not measured" on the CPU.

The slope windows are `utils/timing.py`'s (`--k-lo`, `--k-hi`).  `gpu` names
the card and its power limit.  `--device cpu --tiny` runs it on the CPU at
`GraspNetConfig.tiny()` with a small dataset, for the tests; `backend` then
says "cpu" and no number is a device number.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from graspnet_tpu_torch.apps import train as cli_train
from graspnet_tpu_torch.ops import cuda as kernels
from graspnet_tpu_torch.data.dataset import DataLoader
from graspnet_tpu_torch.data.synthetic import SyntheticGraspNetDataset
from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer
from graspnet_tpu_torch.utils.logging import MetricLogger
from graspnet_tpu_torch.utils.timing import cli, gpu_name_and_power, timeit

TINY_DATA = dict(n_objects=4, label_points=40, cloud_points=2000)
EVAL_LABEL_POINTS = 300  # label points an object of the eval batch, at most
PROFILE_STEPS = 3  # loop steps after the warm-up, profiled on the card


def run(cfg, device: torch.device, log_dir: str, *, steps: int = 20, warmup: int = 5, workers: int = 4,
        batch: int = 2, data: Optional[dict] = None):
    """One epoch of the CLI loop, logging and checkpointing into `log_dir`,
    then the component times.  Returns (the result dict, the trainer as the
    checkpoint left it, the checkpoint path).  `data`: shape arguments of
    SyntheticGraspNetDataset (its production defaults when None)."""
    if steps < 1 or warmup < 1:
        raise ValueError(f"need steps >= 1 and warmup >= 1, got {steps}, {warmup}")
    data = data or {}
    n_steps = warmup + PROFILE_STEPS + 1 + steps  # the 1: the step that takes the profiler's stop
    t0 = time.perf_counter()
    train_ds = SyntheticGraspNetDataset(n_frames=n_steps * batch, cfg=cfg, num_points=cfg.num_point, **data)
    # the eval pass's one batch, at fewer label points (the same code path)
    test_data = {**data, "label_points": min(data.get("label_points", EVAL_LABEL_POINTS), EVAL_LABEL_POINTS)}
    test_ds = SyntheticGraspNetDataset(n_frames=batch, cfg=cfg, num_points=cfg.num_point, augment=False,
                                       seed=1, **test_data)
    gen_s = time.perf_counter() - t0

    for _ in range(2):  # warm the stat cache and the host library
        train_ds.get_data_label(0)
    reps = 3
    t0 = time.perf_counter()
    for i in range(reps):
        train_ds.get_data_label(i)
    host_prep_ms = (time.perf_counter() - t0) / reps * 1e3

    tc = TrainConfig(batch_size=batch, max_epoch=1)
    trainer = Trainer(cfg=cfg, tc=tc, seed=0, device=device)
    logger = MetricLogger(log_dir)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if device.type == "cuda" else None
    done = [0]

    def at_step_end() -> bool:
        # train() asks after each step (its results read) whether to stop:
        # the profiled window is the PROFILE_STEPS steps after the warm-up
        done[0] += 1
        if prof is not None and done[0] == warmup:
            prof.start()
        elif prof is not None and done[0] == warmup + PROFILE_STEPS:
            prof.stop()
        return False

    kernels.reset_launches()
    t_loop = time.perf_counter()
    try:
        loop = cli_train.train(trainer, train_ds, test_ds, logger, log_dir, num_workers=workers,
                               log_every=n_steps, stop=at_step_end)
    finally:
        logger.close()
    loop_s = time.perf_counter() - t_loop
    launches = kernels.launches()
    ends = loop["step_end_s"]
    if len(ends) != n_steps:
        raise RuntimeError(f"the loop ran {len(ends)} steps, expected {n_steps}")
    timed_from = warmup + PROFILE_STEPS  # ends[timed_from]: the end of the step that took the stop
    sustained_ms = (ends[-1] - ends[timed_from]) / steps * 1e3
    window_ms = (ends[timed_from - 1] - ends[warmup - 1]) / PROFILE_STEPS * 1e3
    busy_ms = "not measured"
    if prof is not None:
        busy_us = sum(getattr(ev, "self_device_time_total", 0) or 0 for ev in prof.key_averages()
                      if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA)
        busy_ms = busy_us / PROFILE_STEPS / 1e3 if busy_us > 0 else "not measured"
    ckpt = os.path.join(log_dir, cli_train.CHECKPOINT)

    # component times on a copy of the trainer, so the one returned is the checkpoint's
    timer = Trainer(cfg=cfg, tc=tc, seed=0, device=device)
    timer.load_state_dict(trainer.state_dict())
    loader = DataLoader(train_ds, batch, shuffle=True, num_workers=1)
    loader.set_epoch(1)
    host_batch = next(iter(loader))
    handle = timer.prepare(host_batch)
    handle[2].cpu()  # the pre-pass is done: finalize alone below
    t0 = time.perf_counter()
    timer._finalize_batch(handle)
    finalize_ms = (time.perf_counter() - t0) * 1e3

    syncs = []
    for i in range(15):
        t0 = time.perf_counter()
        torch.full((8,), float(i)).to(device).cpu()
        syncs.append((time.perf_counter() - t0) * 1e3)
    rpc_floor_ms = float(np.percentile(syncs, 50))

    device_batch = timer._finalize_batch(timer.prepare(host_batch))
    device_step_ms = timeit("train step (device, compact labels)", timer._train_step, device_batch)
    small = handle[0]

    def stage1(point_clouds, sa_inds):
        with torch.no_grad():
            feats, _, _ = timer.model.backbone(point_clouds, True, sa_inds)
            return timer.model.approach(feats, True)["grasp_top_view_inds"]

    stage1_ms = timeit("stage1 pre-pass (backbone + approach)", stage1, small["point_clouds"], small["sa_inds"])

    ncores = len(os.sched_getaffinity(0))
    host_side = batch * host_prep_ms / min(ncores, workers)
    result = {
        "metric": f"sustained pipelined train step (batch {batch}, {cfg.num_point} pts, compact labels)",
        "value": sustained_ms,
        "unit": "ms/step",
        "device_step_ms": device_step_ms,
        "stage1_ms": stage1_ms,
        "host_prep_ms_per_scene": host_prep_ms,
        "finalize_ms_per_batch": finalize_ms,
        "rpc_floor_ms": rpc_floor_ms,
        "pipelined_floor_ms": max(device_step_ms + stage1_ms, host_side) + finalize_ms,
        "sustained_ex_rpc_ms": sustained_ms - rpc_floor_ms,
        "device_busy_ms_per_step": busy_ms,
        "profiled_wall_ms_per_step": window_ms,
        "device_idle_share": 1 - busy_ms / window_ms if busy_ms != "not measured" else "not measured",
        "device_idle_share_sustained": 1 - busy_ms / sustained_ms if busy_ms != "not measured" else "not measured",
        "host_cores": ncores,
        "workers": workers,
        "steps_timed": steps,
        "steps_profiled": PROFILE_STEPS,
        "train_steps": n_steps,
        "compile_s": ends[0] - t_loop,  # the first step: loader start, kernel builds
        "loop_s": loop_s,
        "datagen_s": gen_s,
        "label_points": train_ds.grasp_labels[1][0].shape[0],
        "launches": launches,
        "backend": device.type,
        "gpu": gpu_name_and_power() if device.type == "cuda" else None,
        "source": "graspnet_tpu_torch/scripts/bench_train_pipeline.py",
    }
    return result, trainer, ckpt


def main(argv: Optional[Sequence[str]] = None) -> dict:
    def own(ap):
        ap.add_argument("--steps", type=int, default=20, help="timed steps, after the warm-up")
        ap.add_argument("--warmup", type=int, default=5, help="steps before the timed ones")
        ap.add_argument("--workers", type=int, default=4, help="loader worker threads")
        ap.add_argument("--batch", type=int, default=2)

    args, cfg, dev = cli(__doc__.splitlines()[0], argv, own)
    with tempfile.TemporaryDirectory(prefix="bench_train_pipeline_") as log_dir:
        result, _, _ = run(cfg, dev, log_dir, steps=args.steps, warmup=args.warmup, workers=args.workers,
                           batch=args.batch, data=TINY_DATA if args.tiny else None)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return result


if __name__ == "__main__":
    main()
