"""End-to-end learnability gate, the counterpart of
`scripts/learnability_gate.py`: a model trained from scratch flows through
training -> pred_decode -> the `apps/test.py` dump -> the AP evaluator.

    python -m graspnet_tpu_torch.scripts.learnability_gate [--steps 600] [--bar 6] [--seed 0]
        [--device cuda|cpu] [--root DIR] [--out FILE] [--keep]

1. generate the learnable dataset (`data/learnable.py`): rendered scenes of
   spheres and thin plates whose labels are scored by the same
   force-closure physics the evaluator applies;
2. train from scratch through the dataset, its loader and the compact
   label step (`Trainer.step_compact`), the reference's 18-epoch lr and BN
   momentum schedule compressed onto the step budget;
3. checkpoint in the training CLI's layout (`apps/train.py::save_state`)
   and dump the test_seen split through `apps/test.py::inference`, its
   collision filter on, with those weights and with random ones;
4. evaluate scene_0100 with `eval/ap.py` and require
   AP(trained) >= --bar > AP(random).

A convention break between decode, dump and evaluator zeroes the trained
AP, so the gate's power is the trained-vs-0 contrast; the JAX gate reads
AP(trained) 24.7-26.9 at seed 0 and AP(random) 0.0.  Prints one JSON line
(AP, AP0.8, AP0.4 of both, train_s, dataset_gen_s, final_loss, the step
trajectory) and exits 1 when the gate fails.  Runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import torch

from graspnet_tpu_torch.apps import test as test_app
from graspnet_tpu_torch.apps import train as cli_train
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.data.dataset import DataLoader, GraspNetDataset, load_grasp_labels
from graspnet_tpu_torch.data.learnable import make_learnable_dataset
from graspnet_tpu_torch.device import resolve_device
from graspnet_tpu_torch.eval.ap import GraspNetEval, summarize
from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer
from graspnet_tpu_torch.utils.logging import MetricLogger


def gate_config() -> GraspNetConfig:
    """The tiny backbone at a 1024-point cloud: the rendered workspace
    holds ~1.1k points, and each labelled object needs >= 50 sampled
    points to clear the reference's per-object threshold."""
    return dataclasses.replace(GraspNetConfig.tiny(), num_point=1024)


def train_gate_model(root: str, cfg: GraspNetConfig, steps: int, seed: int, device: torch.device):
    """Train from scratch on the dataset under `root`; returns the trainer
    and the (step, loss, objectness accuracy) trajectory, one entry per
    pass over the loader."""
    n_obj = len(glob.glob(os.path.join(root, "grasp_label", "*_labels.npz")))
    valid, labels = load_grasp_labels(root, num_objects=n_obj)
    # augment: with a tiny model on a tiny dataset, the flips and rotations
    # are what generalizes from point patterns to the held-out test frames
    ds = GraspNetDataset(root, valid, labels, camera="realsense", split="train", num_points=cfg.num_point,
                         remove_outlier=True, load_label=True, cfg=cfg, augment=True, seed=seed)
    # batch 4 = the whole frame set a step.  bn_momentum_min 0.05 (the
    # reference's is 0.001): with 18 epochs of schedule on a few hundred
    # steps, the reference floor freezes the running stats on early
    # activations and the eval-mode forward sees stale statistics
    bs = min(4, len(ds))
    trainer = Trainer(cfg=cfg, tc=TrainConfig(batch_size=bs, bn_momentum_min=0.05), seed=seed, device=device)
    loader = DataLoader(ds, bs, shuffle=True, num_workers=2)
    step, hist = 0, []
    while step < steps:
        # the 18-epoch lr and BN-momentum schedule on the step budget: the
        # momentum must decay for the eval-mode forward to follow training
        trainer.set_epoch(min(17, step * 18 // max(steps, 1)))
        for batch in loader:
            loss, metrics = trainer.step_compact(batch)
            step += 1
            if step >= steps:
                break
        hist.append((step, round(float(loss), 3), round(float(metrics["stage1_objectness_acc"]), 3)))
    return trainer, hist


def dump_and_eval(root: str, work: str, tag: str, checkpoint_path: Optional[str], cfg: GraspNetConfig,
                  device: torch.device) -> dict:
    """Dump test_seen through `apps/test.py::inference` (collision filter
    at 0.01) and score scene_0100: {AP, AP0.8, AP0.4}."""
    dump_dir = os.path.join(work, f"dump_{tag}")
    shutil.rmtree(dump_dir, ignore_errors=True)
    args = argparse.Namespace(
        dataset_root=root, camera="realsense", split="test_seen", checkpoint_path=checkpoint_path,
        dump_dir=dump_dir, num_point=cfg.num_point, collision_thresh=0.01, voxel_size=0.01, batch_size=1,
        max_frames=None, profile_dir=None, device=str(device))
    test_app.inference(args, cfg)
    res = GraspNetEval(root, camera="realsense", split="test_seen").eval_scene("scene_0100", dump_dir)
    s = summarize(res)
    print(f"{tag}: AP {s['AP']:.2f} AP0.8 {s['AP0.8']:.2f} AP0.4 {s['AP0.4']:.2f}", flush=True)
    return s


def run(work: str, *, steps: int = 600, bar: float = 6.0, seed: int = 0,
        device: str | torch.device = "cuda") -> dict:
    """The gate in `work` (the dataset under work/data, made when absent;
    the checkpoint under work/log; the dumps beside them).  Returns the
    result dict; `passed` says whether AP(trained) >= bar > AP(random);
    `dataset_root` and `checkpoint_path` name the data and the trained
    weights, for callers that go on using them inside `work`."""
    device = resolve_device(device, "learnability_gate")
    cfg = gate_config()
    root = os.path.join(work, "data")
    t0 = time.perf_counter()
    if not os.path.isdir(os.path.join(root, "scenes")):
        make_learnable_dataset(root, cfg=cfg, seed=seed)
    gen_s = time.perf_counter() - t0
    print(f"dataset: {root} ({gen_s:.1f}s); device: {device}", flush=True)

    t0 = time.perf_counter()
    trainer, hist = train_gate_model(root, cfg, steps, seed, device)
    train_s = time.perf_counter() - t0
    print(f"trained {hist[-1][0]} steps in {train_s:.1f}s; tail: {hist[-3:]}", flush=True)

    log_dir = os.path.join(work, "log")
    logger = MetricLogger(log_dir)
    try:  # the training CLI's layout: the pipeline's train-state restore is on the path
        ckpt = cli_train.save_state(trainer, log_dir, 0, logger)
    finally:
        logger.close()
    del trainer

    trained = dump_and_eval(root, work, "trained", ckpt, cfg, device)
    random_init = dump_and_eval(root, work, "random", None, cfg, device)
    return {
        "metric": "learnability gate (train -> apps/test.py dump -> AP)",
        "ap_trained": trained["AP"], "ap_trained_08": trained["AP0.8"], "ap_trained_04": trained["AP0.4"],
        "ap_random": random_init["AP"], "ap_random_08": random_init["AP0.8"], "ap_random_04": random_init["AP0.4"],
        "bar": bar,
        "passed": trained["AP"] >= bar > random_init["AP"],
        "steps": hist[-1][0],
        "seed": seed,
        "train_s": train_s,
        "dataset_gen_s": gen_s,
        "final_loss": hist[-1][1],
        "trajectory": hist,
        "dataset_root": root,
        "checkpoint_path": ckpt,
        "backend": device.type,
        "source": "graspnet_tpu_torch/scripts/learnability_gate.py",
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="work directory (default: a temporary one)")
    ap.add_argument("--steps", type=int, default=600, help="train step budget")
    ap.add_argument("--bar", type=float, default=6.0, help="absolute AP bar")
    ap.add_argument("--seed", type=int, default=0, help="dataset and trainer seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    ap.add_argument("--keep", action="store_true", help="keep the temporary work directory")
    args = ap.parse_args(argv)
    work = args.root or tempfile.mkdtemp(prefix="graspnet_learn_")
    result = run(work, steps=args.steps, bar=args.bar, seed=args.seed, device=args.device)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    if not args.keep and args.root is None and result["passed"]:
        shutil.rmtree(work, ignore_errors=True)
    if not result["passed"]:
        print(f"FAIL: need AP(trained) >= {args.bar} > AP(random); got {result['ap_trained']:.2f} / "
              f"{result['ap_random']:.2f}; trajectory: {result['trajectory']}")
        return 1
    print("OK: learnability gate passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
