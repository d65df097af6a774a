"""Training-step benchmark at the reference operating point, the counterpart
of `scripts/bench_train.py`: batch 2, 20000-point clouds, 1024 seeds x 300
views x 12 angles x 4 depths (reference train.py:31-40).

    python -m graspnet_tpu_torch.scripts.bench_train

Prints one JSON line under the JAX script's keys: the pipelined step time of
the compact two-phase label path (`Trainer.prepare` / `step_prepared` back
to back, host clock), the device step time (`Trainer`'s step on a finished
device batch, slope-timed between CUDA events, `utils/timing.py`), the host
label prep per scene (the FPS seed chain and phase A of the compact labels,
on the host label library) and the first step's time (kernel builds
included); `gpu` names the card and its power limit.  Eight synthetic
objects of 300 label points a scene with random scores, uniform random
clouds, random weights (seed 0).  `--device cpu --tiny` runs it on the CPU
at `GraspNetConfig.tiny()` for the tests; `backend` then says "cpu" and no
number in the line is a device number.
"""

from __future__ import annotations

import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from graspnet_tpu_torch.train import label_pipeline as lp
from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer
from graspnet_tpu_torch.utils.timing import cli, dump_records, gpu_name_and_power, timeit

B = 2


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_scene(rng: np.random.Generator, cfg, n_obj: int = 8, npc: int = 300):
    """One scene's labels as `scripts/bench_train.py` makes them."""
    v, a, d = cfg.num_view, cfg.num_angle, cfg.num_depth
    poses, pts, scores, widths, tols = [], [], [], [], []
    for _ in range(n_obj):
        poses.append(np.hstack([np.eye(3), rng.uniform(-0.2, 0.2, (3, 1))]).astype(np.float32))
        pts.append(rng.uniform(-0.05, 0.05, (npc, 3)).astype(np.float32))
        scores.append(rng.uniform(0, 1, (npc, v, a, d)).astype(np.float32))
        widths.append(rng.uniform(0, 0.1, (npc, v, a, d)).astype(np.float32))
        tols.append(rng.uniform(0, 0.05, (npc, v, a, d)).astype(np.float32))
    return poses, pts, scores, widths, tols


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args, cfg, dev = cli(__doc__.splitlines()[0], argv)
    rng = np.random.default_rng(0)
    clouds = [rng.uniform(-0.4, 0.4, (cfg.num_point, 3)).astype(np.float32) for _ in range(B)]
    scenes = [make_scene(rng, cfg) for _ in range(B)]  # data generation, not timed
    t0 = time.perf_counter()
    ctxs, chains = [], []
    for cloud, scene in zip(clouds, scenes):
        inds, seed_xyz = lp.seed_chain(cloud, cfg)
        chains.append(inds)
        ctxs.append(lp.prepare_scene_labels(seed_xyz, *scene, cfg, max_objects=8))
    host_prep_ms = (time.perf_counter() - t0) / B * 1e3
    batch = {
        "point_clouds": np.stack(clouds),
        "objectness_label": np.stack([rng.integers(0, 2, cfg.num_point).astype(np.int32) for _ in range(B)]),
        "sa_inds": {k: np.stack([c[k] for c in chains]) for k in ("sa1", "sa2", "sa3", "sa4")},
        "label_ctx": ctxs,
    }

    trainer = Trainer(cfg=cfg, tc=TrainConfig(), seed=0, device=dev)
    trainer.set_epoch(0)
    t0 = time.perf_counter()
    float(trainer.step_compact(batch)[0])
    compile_s = time.perf_counter() - t0
    for _ in range(4):  # past the first calls' allocations
        trainer.step_compact(batch)
    sync(dev)

    # pipelined, the apps/train.py pattern: the next prepare while a step runs
    handle = trainer.prepare(batch)
    k = 10
    t0 = time.perf_counter()
    for _ in range(k):
        loss, _ = trainer.step_prepared(handle)
        handle = trainer.prepare(batch)
    float(loss)
    step_ms = (time.perf_counter() - t0) / k * 1e3

    device_batch = trainer._finalize_batch(trainer.prepare(batch))
    device_step_ms = timeit("train step (device, compact labels)", trainer._train_step, device_batch)
    result = {
        "metric": "train step (batch 2, 20k pts, compact labels)",
        "value": step_ms,
        "unit": "ms/step",
        "device_step_ms": device_step_ms,
        "host_label_prep_ms_per_scene": host_prep_ms,
        "compile_s": compile_s,
        "backend": dev.type,
        "gpu": gpu_name_and_power() if dev.type == "cuda" else None,
    }
    print(json.dumps(result), flush=True)
    if args.out:
        dump_records(args.out, source="graspnet_tpu_torch/scripts/bench_train.py")
    return result


if __name__ == "__main__":
    main()
