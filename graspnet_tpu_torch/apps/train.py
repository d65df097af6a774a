"""Training entry point (the reference's train.py), on one card.

Counterpart of `graspnet_tpu/apps/train.py`:

    python -m graspnet_tpu_torch.apps.train --dataset_root /data/graspnet \
        --camera realsense --log_dir logs/rs --batch_size 2 --max_epoch 18

Each epoch runs the loader's worker threads into the double-buffered
compact loop (`Trainer.prepare` of the next batch while the current
`step_prepared` runs; `--label_mode full` ships the whole label slabs with
`Trainer.put` / `step` instead), then the eval pass over `test_seen`, then
a checkpoint (`log_dir/checkpoint.pt`, `checkpoint.save`).
`--checkpoint_path` resumes from one: the model, Adam's state and the
epoch, bitwise.  SIGTERM or SIGINT sets a flag; the loop finishes the step
in flight, checkpoints at epoch - 1 (the epoch restarts on resume) and
returns.  `train()` is the loop alone, for callers that build their own
datasets (`scripts/bench_train_pipeline.py`, `chip_smoke.py`).

Runs on CUDA unless `--device cpu` is passed.  One card only: `--n_devices`
and `--candidate_devices` take 1 and raise otherwise, and there is no
multi-host branch; `--profile_dir` writes a torch.profiler trace of five
steps of the first epoch (`utils/tracing.py`); `--debug_nans` turns on
`torch.autograd.set_detect_anomaly`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.data.dataset import DataLoader, GraspNetDataset, load_grasp_labels
from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer
from graspnet_tpu_torch.utils.logging import MetricLogger
from graspnet_tpu_torch.utils.tracing import device_trace

CHECKPOINT = "checkpoint.pt"  # in log_dir
PROFILE_FIRST_STEP, PROFILE_STEPS = 10, 5  # --profile_dir's window: past the first steps' allocations


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--camera", default="kinect", choices=["kinect", "realsense"])
    p.add_argument("--checkpoint_path", default=None, help="resume from this checkpoint")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--num_point", type=int, default=20000)
    p.add_argument("--num_view", type=int, default=300)
    p.add_argument("--max_epoch", type=int, default=18)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--bn_decay_step", type=int, default=2)
    p.add_argument("--bn_decay_rate", type=float, default=0.5)
    p.add_argument("--lr_decay_steps", default="8,12,16")
    p.add_argument("--lr_decay_rates", default="0.1,0.1,0.1")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--n_devices", type=int, default=None, help="data-parallel width: 1 (one card)")
    p.add_argument("--candidate_devices", type=int, default=1, help="candidate-sharded width: 1 (one card)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--profile_dir", default=None, help="write a torch.profiler trace of 5 steps of the first epoch here")
    p.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() (tests)")
    p.add_argument("--num_objects", type=int, default=88, help="object label count (partial/mini datasets)")
    p.add_argument("--label_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="bfloat16 halves the label transfer of --label_mode full")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly: raise at the first op whose backward makes a NaN")
    p.add_argument("--label_mode", default="compact", choices=["compact", "full"],
                   help="compact: the two-phase step shipping only the matched label slabs (bitwise the "
                   "same step); full: ship the whole (Ns, V, A, D) slabs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    for flag in ("n_devices", "candidate_devices"):
        if getattr(args, flag) not in (None, 1):
            p.error(f"--{flag} {getattr(args, flag)}: the port trains on one card (parallel training is not ported)")
    return args


def resume(trainer: Trainer, path: Optional[str], logger: MetricLogger) -> int:
    """Load `path` into the trainer when it exists; returns the first epoch to run."""
    if not path or not os.path.exists(path):
        return 0
    state = checkpoint.restore(path)
    trainer.load_state_dict(state)
    start = int(state["epoch"]) + 1
    logger.log(f"resumed from {path} at epoch {start}")
    return start


def save_state(trainer: Trainer, log_dir: str, epoch_done: int, logger: MetricLogger) -> str:
    """Checkpoint the full training state; a resume starts at epoch_done + 1."""
    path = os.path.join(os.path.abspath(log_dir), CHECKPOINT)
    checkpoint.save(path, {**trainer.state_dict(), "epoch": epoch_done})
    logger.log(f"saved {CHECKPOINT} (resume epoch {epoch_done + 1})")
    return path


@contextlib.contextmanager
def preemption_flag():
    """Yields a function that says whether SIGTERM or SIGINT arrived.  The
    handler only sets the flag (logging in it could re-enter a logger write
    the signal interrupted); the previous handlers come back on exit.  Off
    the main thread no handler can be installed and the flag stays unset."""
    flag = {"set": False}

    def on_signal(signum, frame):
        flag["set"] = True

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, on_signal)
        except ValueError:  # not the main thread
            break
    try:
        yield lambda: flag["set"]
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def train(
    trainer: Trainer,
    train_ds,
    test_ds,
    logger: MetricLogger,
    log_dir: str,
    *,
    num_workers: int = 4,
    label_mode: str = "compact",
    log_every: int = 10,
    start_epoch: int = 0,
    stop: Callable[[], bool] = lambda: False,
    profile_dir: Optional[str] = None,
) -> Dict[str, object]:
    """The epoch loop of `graspnet_tpu/apps/train.py:256-334` on one card.

    `profile_dir`: trace PROFILE_STEPS steps of the first epoch, from step
    PROFILE_FIRST_STEP (earlier in a shorter epoch), into it.  Returns
    `step_end_s`, the host clock after each train step's metrics were read
    (the step is done then), and `epochs_done`."""
    tc = trainer.tc
    compact = label_mode == "compact"
    feed = trainer.prepare if compact else trainer.put
    train_loader = DataLoader(train_ds, tc.batch_size, shuffle=True, num_workers=num_workers)
    test_loader = DataLoader(test_ds, tc.batch_size, shuffle=False, num_workers=num_workers)
    step_end_s: List[float] = []
    epochs_done = 0
    with contextlib.ExitStack() as profile:  # an exception ends a trace too
        for epoch in range(start_epoch, tc.max_epoch):
            trainer.set_epoch(epoch)
            train_ds.set_epoch(epoch)  # fresh per-frame sampling and augmentation
            train_loader.set_epoch(epoch)  # the shuffle pinned to the epoch, across restarts
            logger.log(f"**** EPOCH {epoch:03d} ****  lr={trainer.opt.param_groups[0]['lr']}")
            t0 = time.time()
            # double buffering: enqueue the step, then prepare the NEXT batch
            # (its loader wait, pre-pass and static labels) while the card runs it
            it = iter(train_loader)
            pending = feed(next(it))
            step = 0
            first = min(PROFILE_FIRST_STEP, max(0, len(train_loader) - PROFILE_STEPS))
            traced = profile_dir is not None and epoch == start_epoch
            while pending is not None:
                if traced and step == first:
                    profile.enter_context(device_trace(profile_dir))
                elif traced and step == first + PROFILE_STEPS:
                    profile.close()
                    logger.log(f"trace of steps {first}-{step - 1} saved to {profile_dir}")
                _, metrics = trainer.step_prepared(pending) if compact else trainer.step(pending)
                try:
                    pending = feed(next(it))
                except StopIteration:
                    pending = None
                logger.accumulate(metrics)  # reads this step's results
                step_end_s.append(time.perf_counter())
                step += 1
                if step % log_every == 0:
                    logger.flush("train", epoch * len(train_loader) + step)
                if stop():
                    save_state(trainer, log_dir, epoch - 1, logger)
                    logger.log("preemption checkpoint written; exiting")
                    return {"step_end_s": step_end_s, "epochs_done": epochs_done}
            if traced and step < first + PROFILE_STEPS:  # the epoch ended inside the window
                profile.close()
                logger.log(f"trace of steps {first}-{step - 1} saved to {profile_dir}")
            if step % log_every != 0:  # the epoch's last window stays out of the eval record
                logger.flush("train", epoch * len(train_loader) + step)
            logger.log(f"epoch train time: {time.time() - t0:.1f}s")

            for batch in test_loader:
                _, metrics = trainer.eval_step_compact(batch) if compact else trainer.eval_step(batch)
                logger.accumulate(metrics)
            logger.flush("eval", (epoch + 1) * len(train_loader))
            save_state(trainer, log_dir, epoch, logger)
            epochs_done += 1
    return {"step_end_s": step_end_s, "epochs_done": epochs_done}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    os.makedirs(args.log_dir, exist_ok=True)
    logger = MetricLogger(args.log_dir)
    try:
        if args.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig(num_point=args.num_point,
                                                                     num_view=args.num_view)
        tc = TrainConfig(
            learning_rate=args.learning_rate,
            weight_decay=args.weight_decay,
            max_epoch=args.max_epoch,
            batch_size=args.batch_size,
            lr_decay_epochs=tuple(int(x) for x in args.lr_decay_steps.split(",")),
            lr_decay_rates=tuple(float(x) for x in args.lr_decay_rates.split(",")),
            bn_decay_step=args.bn_decay_step,
            bn_decay_rate=args.bn_decay_rate,
            label_dtype=args.label_dtype,
        )
        valid_objs, grasp_labels = load_grasp_labels(args.dataset_root, num_objects=args.num_objects)
        common = dict(camera=args.camera, num_points=cfg.num_point, remove_outlier=True, cfg=cfg,
                      label_mode=args.label_mode)
        train_ds = GraspNetDataset(args.dataset_root, valid_objs, grasp_labels, split="train",
                                   augment=True, **common)
        test_ds = GraspNetDataset(args.dataset_root, valid_objs, grasp_labels, split="test_seen",
                                  augment=False, **common)
        logger.log(f"train len: {len(train_ds)}, test len: {len(test_ds)}")
        trainer = Trainer(cfg=cfg, tc=tc, device=args.device)
        logger.log(f"device: {trainer.device}")
        start_epoch = resume(trainer, args.checkpoint_path, logger)
        with preemption_flag() as stop:
            train(trainer, train_ds, test_ds, logger, args.log_dir, num_workers=args.num_workers,
                  label_mode=args.label_mode, log_every=args.log_every, start_epoch=start_epoch,
                  stop=stop, profile_dir=args.profile_dir)
    finally:
        if args.debug_nans:
            torch.autograd.set_detect_anomaly(False)
        logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
