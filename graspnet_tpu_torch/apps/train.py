"""Training entry point (the reference's train.py).

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
datasets (the benchmark's training cell, `chip_smoke.py`).

Runs on CUDA unless `--device cpu` is passed.  Data-parallel training runs
one process a device in a torch.distributed group (`parallel/distributed.py`,
`Trainer(group=)`): `--n_devices N` on one command spawns N ranks on
cuda:0..N-1 (or N CPU ranks with `--device cpu`); a torchrun or
GRASPNET_COORDINATOR / NUM_PROCESSES / PROCESS_ID launch joins one group
with each rank on cuda:(local rank).  `--dist_backend` is NCCL on CUDA and
gloo on the CPU by default; ranks that share a card need gloo.  Each rank
loads its shard of every global batch of `--batch_size` scenes; rank 0
writes the main log and the checkpoint, rank i logs to `proc{i}/`; a
resume loads on every rank.  Hybrid data x candidate training:
`--n_devices D --candidate_devices C` spawns D x C ranks (rank r on
cuda:r); rank r loads data row r // C's shard of each batch and runs stage
2 on seed block r % C of it (`Trainer(candidate=)`).  Without
`--n_devices`, D is the largest data width that divides the batch with
D x C ranks on the host's cards (the JAX CLI's default; one row on the
CPU).  C must divide the model's seeds.
`--profile_dir` writes a torch.profiler trace of five steps of the first
epoch (`utils/tracing.py`), in which each step's spans label the host's
time (`train`'s docstring); `--debug_nans` turns on
`torch.autograd.set_detect_anomaly`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.data.dataset import DataLoader, GraspNetDataset, load_grasp_labels
from graspnet_tpu_torch.parallel import distributed
from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer
from graspnet_tpu_torch.utils.logging import MetricLogger
from graspnet_tpu_torch.utils.tracing import device_trace, span

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
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks to spawn, one a device (cuda:0..N-1, or the CPU)")
    p.add_argument("--candidate_devices", type=int, default=1,
                   help="seed blocks C a data row's stage 2 shards over (hybrid training: D x C ranks)")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend (default: nccl on CUDA, gloo on the CPU)")
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
    cand = args.candidate_devices
    if cand < 1:
        p.error(f"--candidate_devices {cand}: at least one")
    num_seed = model_config(args).num_seed
    if num_seed % cand:
        p.error(f"num_seed {num_seed} must divide by the candidate axis size {cand}")
    if args.n_devices is None and cand > 1:
        # the largest data width that divides the global batch (the JAX CLI's default)
        avail = torch.cuda.device_count() // cand if args.device != "cpu" else 1
        args.n_devices = max(d for d in range(1, max(min(avail, args.batch_size), 1) + 1)
                             if args.batch_size % d == 0)
    n = 1 if args.n_devices is None else args.n_devices
    if n < 1:
        p.error(f"--n_devices {n}: at least one")
    if args.batch_size % n:
        p.error(f"process count {n} must divide the global batch {args.batch_size}")
    ranks = n * cand
    if ranks > 1 and args.device != "cpu" and ranks > torch.cuda.device_count():
        p.error(f"--n_devices {n} x --candidate_devices {cand}: this host has {torch.cuda.device_count()} "
                "CUDA device(s)")
    return args


def model_config(args: argparse.Namespace) -> GraspNetConfig:
    return GraspNetConfig.tiny() if args.tiny else GraspNetConfig(num_point=args.num_point, num_view=args.num_view)


def resume(trainer: Trainer, path: Optional[str], logger: MetricLogger) -> int:
    """Load `path` into the trainer when it exists; returns the first epoch to run."""
    if not path or not os.path.exists(path):
        return 0
    state = checkpoint.restore(path)
    trainer.load_state_dict(state)
    start = int(state["epoch"]) + 1
    logger.log(f"resumed from {path} at epoch {start}")
    return start


def rank_of(trainer: Trainer) -> int:
    return 0 if trainer.group is None else dist.get_rank(trainer.group)


def save_state(trainer: Trainer, log_dir: str, epoch_done: int, logger: MetricLogger) -> Optional[str]:
    """Checkpoint the full training state (rank 0 alone in a group; the
    ranks hold equal states); a resume starts at epoch_done + 1."""
    if rank_of(trainer) != 0:
        return None
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
    """The epoch loop of `graspnet_tpu/apps/train.py:256-334`.

    `profile_dir`: trace PROFILE_STEPS steps of the first epoch, from step
    PROFILE_FIRST_STEP (earlier in a shorter epoch), into it.  In a
    trainer's process group each rank loads its data row's shard of every
    global batch (`graspnet_tpu/apps/train.py:199-208`), the ranks stop together
    when any of them is asked to, and rank 0 writes the checkpoints.
    Returns `step_end_s`, the host clock after each train step's metrics
    were read (the step is done then), and `epochs_done`.

    Each iteration of the train loop is a `train.step` span, whose trace
    id is the step's number (1 for the run's first), holding
    `train.enqueue` (the step's launches), `train.loader_wait` (the wait
    on the loader for the next batch), `train.prepare` (its preparation
    for the card) and `train.read_metrics` (the first host read of the
    step's results, where the host waits for the card)."""
    tc = trainer.tc
    compact = label_mode == "compact"
    feed = trainer.prepare if compact else trainer.put
    group = trainer.group
    rows = (1 if group is None else dist.get_world_size(group)) // trainer.candidate
    shards = dict(num_shards=rows, shard_index=distributed.hybrid_layout(rank_of(trainer), trainer.candidate)[0])
    train_loader = DataLoader(train_ds, tc.batch_size // rows, shuffle=True, num_workers=num_workers, **shards)
    test_loader = DataLoader(test_ds, tc.batch_size // rows, shuffle=False, num_workers=num_workers, **shards)
    if group is not None:
        asked = stop

        def stop() -> bool:  # one collective a step: every rank leaves at the same step
            flag = torch.tensor([float(asked())], device=trainer.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
            return bool(flag.item())
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
                with span("train.step", trace=epoch * len(train_loader) + step + 1):
                    with span("train.enqueue"):
                        _, metrics = trainer.step_prepared(pending) if compact else trainer.step(pending)
                    try:
                        with span("train.loader_wait"):
                            batch = next(it)
                        with span("train.prepare"):
                            pending = feed(batch)
                    except StopIteration:
                        pending = None
                    with span("train.read_metrics"):
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
    if (args.n_devices or 1) * args.candidate_devices > 1 and not _launched_in_a_group():
        return spawn_ranks(args)
    if distributed.initialize(backend=args.dist_backend, device=args.device):
        return run(args, dist.group.WORLD, distributed.local_device(args.device))
    return run(args, None, args.device)


def _launched_in_a_group() -> bool:
    return dist.is_initialized() or "GRASPNET_COORDINATOR" in os.environ or "WORLD_SIZE" in os.environ


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_of(args: argparse.Namespace) -> int:
    return (args.n_devices or 1) * args.candidate_devices


def spawn_ranks(args: argparse.Namespace) -> int:
    """Start `--n_devices` x `--candidate_devices` ranks of this CLI on this
    host (rank i on cuda:i or the CPU) and wait for them.  The libraries
    are built here first, so the ranks find them built."""
    from graspnet_tpu_torch.ops.cuda import build

    build.build_all(build.SOURCES if args.device != "cpu" else (build.HOST,))
    port = _free_port()
    torch.multiprocessing.spawn(_rank_main, args=(args, port), nprocs=world_of(args), join=True)
    return 0


def _rank_main(rank: int, args: argparse.Namespace, port: int) -> None:
    distributed.initialize(f"127.0.0.1:{port}", world_of(args), rank, backend=args.dist_backend, device=args.device)
    try:
        device = "cpu" if args.device == "cpu" else torch.device("cuda", rank)
        run(args, dist.group.WORLD, device)
    finally:
        dist.destroy_process_group()


def run(args: argparse.Namespace, group, device) -> int:
    """One rank's training (the only one without a group)."""
    rank = 0 if group is None else dist.get_rank(group)
    cand = args.candidate_devices
    if group is not None:
        world = dist.get_world_size(group)
        if world % cand:
            raise ValueError(f"{world} ranks do not form data rows of --candidate_devices {cand}")
        if args.batch_size % (world // cand):
            raise ValueError(f"data width {world // cand} must divide the global batch {args.batch_size}")
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(device)  # NCCL's own buffers go to the current device
    log_dir = args.log_dir if rank == 0 else os.path.join(args.log_dir, f"proc{rank}")
    os.makedirs(log_dir, exist_ok=True)
    logger = MetricLogger(log_dir)
    try:
        if args.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        cfg = model_config(args)
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
        trainer = Trainer(cfg=cfg, tc=tc, device=device, group=group, candidate=cand)
        logger.log(f"device: {trainer.device}")
        if group is not None and cand > 1:
            row, block = distributed.hybrid_layout(rank, cand)
            logger.log(f"hybrid rank {rank}/{world} ({dist.get_backend(group)}): data row {row} of {world // cand}, "
                       f"seed block {block} of {cand}; {tc.batch_size // (world // cand)} scenes/row/step")
        elif group is not None:
            logger.log(f"data-parallel rank {rank}/{world} ({dist.get_backend(group)}); "
                       f"{tc.batch_size // world} scenes/rank/step")
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
