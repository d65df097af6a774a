"""Test / inference entry point (the reference's test.py), on one card.

Counterpart of `graspnet_tpu/apps/test.py`.  Two phases, as in the
reference: (1) inference over a test split, dumping each frame's (M, 17)
grasp array, collision-filtered against the frame's raw cloud (reference
test.py:92-96); (2) AP evaluation of the dump directory (`eval/ap.py`,
which needs the dataset's object models).

    python -m graspnet_tpu_torch.apps.test --dataset_root /data/graspnet \
        --camera realsense --split test_seen --checkpoint_path ckpt \
        --dump_dir logs/dump --collision_thresh 0.01

Runs on CUDA unless `--device cpu` is passed.  One card: `--devices` takes
1 and is an argparse error otherwise.  `--profile_dir` writes a
torch.profiler trace of the inference loop (`utils/tracing.py`).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import time
from typing import Optional, Sequence

import numpy as np

from graspnet_tpu_torch import native
from graspnet_tpu_torch.apps.pipeline import GraspPipeline
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.data.dataset import SPLITS, GraspNetDataset
from graspnet_tpu_torch.eval.ap import GraspNetEval, summarize
from graspnet_tpu_torch.utils.tracing import StageTimer, device_trace


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--camera", default="kinect", choices=["kinect", "realsense"])
    p.add_argument("--split", default="test_seen")
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--dump_dir", required=True)
    p.add_argument("--num_point", type=int, default=20000)
    p.add_argument("--collision_thresh", type=float, default=0.01)
    p.add_argument("--voxel_size", type=float, default=0.01)
    p.add_argument("--num_workers", type=int, default=30, help="eval processes")
    p.add_argument("--batch_size", type=int, default=1, help="frames per device batch")
    p.add_argument("--devices", type=int, default=1, help="cards per batch: 1 (one card)")
    p.add_argument("--skip_eval", action="store_true")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--profile_dir", default=None, help="write a torch.profiler trace of the inference loop here")
    p.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() (tests)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.devices != 1:
        p.error(f"--devices {args.devices}: the port runs inference on one card "
                "(data-parallel inference is ROADMAP queue 1, item [21], parallel/ -> torch.distributed)")
    return args


def inference(args, cfg: GraspNetConfig, dataset=None) -> dict:
    """Dump grasps for a split; returns {total_s, ms_per_frame, frames,
    compile_s, stages_ms}.

    `dataset` lets `scripts/bench_test_app.py` run this loop over synthetic
    frames.  Frames are read ahead on a thread pool; each batch is enqueued
    on the device and handed to a postproc thread, which fetches its rows,
    filters them against the frames' raw clouds (downsampled on another
    pool while the batch runs) and dumps them, while this thread reads and
    enqueues the next batch.  At most 3 batches are in flight.
    """
    if dataset is None:
        dataset = GraspNetDataset(args.dataset_root, camera=args.camera, split=args.split,
                                  num_points=cfg.num_point, remove_outlier=True, load_label=False, cfg=cfg)
    pipe = GraspPipeline(cfg=cfg, checkpoint_path=args.checkpoint_path, device=getattr(args, "device", "cuda"))
    bs = max(args.batch_size, 1)
    compile_s = pipe.warmup(topk=False, batch_size=bs)  # the raw decode program at the loop's batch
    print(f"warm-up: {compile_s:.1f}s; frames: {len(dataset)}", flush=True)

    n = len(dataset) if args.max_frames is None else min(args.max_frames, len(dataset))
    if hasattr(dataset, "_frame_cache_cap"):
        # each frame is read twice (get_data, get_raw_cloud): the cache
        # must span the read-ahead (3 batches) and the postproc backlog (4)
        # unless the user bounded it
        want = 8 * bs
        if "GRASPNET_FRAME_CACHE" in os.environ:
            if dataset._frame_cache_cap < want:
                print(f"GRASPNET_FRAME_CACHE={dataset._frame_cache_cap} < {want} (8 x batch); "
                      "frames may be decoded twice")
        else:
            dataset._frame_cache_cap = max(dataset._frame_cache_cap, want)
    timer = StageTimer()
    collide = args.collision_thresh > 0

    def downsample_frame(i):
        with timer.stage("collision"):
            return native.voxel_downsample(dataset.get_raw_cloud(i), args.voxel_size)

    def postproc_batch(ids, handle, ds_futs):
        # the rows are fetched here, so this batch's device time and copy
        # overlap the main thread's work on the next batch
        with timer.stage("fetch"):
            ggs = pipe.finish_grasps_batch(handle)[: len(ids)]
        if collide:
            ds = [f.result() for f in ds_futs]
            with timer.stage("collision"):
                ggs = pipe.collision_filter_batch(ggs, ds, args.collision_thresh, args.voxel_size,
                                                  pre_downsampled=True)
        for i, gg in zip(ids, ggs):
            with timer.stage("dump"):
                scene, frame = dataset.frames[i]
                save_dir = os.path.join(args.dump_dir, scene, args.camera)
                os.makedirs(save_dir, exist_ok=True)
                gg.save_npy(os.path.join(save_dir, f"{frame:04d}.npy"))

    tic = time.time()
    with cf.ThreadPoolExecutor(max_workers=max(4, bs)) as pool, \
            cf.ThreadPoolExecutor(max_workers=4) as post_pool, \
            cf.ThreadPoolExecutor(max_workers=2) as batch_pool:
        futures = {i: pool.submit(dataset.get_data, i) for i in range(min(2 * bs, n))}
        post_futures = []
        try:
            with device_trace(getattr(args, "profile_dir", None)):
                for start in range(0, n, bs):
                    ids = list(range(start, min(start + bs, n)))
                    for j in range(start + 2 * bs, min(start + 3 * bs, n)):
                        if j not in futures:
                            futures[j] = pool.submit(dataset.get_data, j)
                    with timer.stage("data"):
                        samples = [futures.pop(i).result() for i in ids]
                    ds_futs = [post_pool.submit(downsample_frame, i) for i in ids] if collide else []
                    with timer.stage("net"):
                        clouds = np.stack([s["point_clouds"] for s in samples])
                        if len(ids) < bs:  # the tail batch, padded to the warmed-up shape
                            clouds = np.concatenate([clouds, np.repeat(clouds[-1:], bs - len(ids), axis=0)])
                        handle = pipe.dispatch_grasps_batch(clouds)
                    post_futures.append(batch_pool.submit(postproc_batch, ids, handle, ds_futs))
                    while len(post_futures) > 3:  # backpressure
                        post_futures.pop(0).result()
                    # a postproc failure surfaces now, not after the split
                    for fut in [f for f in post_futures if f.done()]:
                        post_futures.remove(fut)
                        fut.result()
                    done = ids[-1] + 1
                    if done % 100 < bs:
                        print(f"{done}/{n} frames, {(time.time() - tic) / done * 1000:.1f} ms/frame  "
                              f"[{timer.report()}]", flush=True)
                for fut in post_futures:
                    fut.result()  # every dump written
        finally:
            for fut in futures.values():
                fut.cancel()
    total_s = time.time() - tic
    print(f"inference done: {total_s:.1f}s total  [{timer.report()}]", flush=True)
    return {
        "total_s": total_s,
        "ms_per_frame": total_s / max(n, 1) * 1000,
        "frames": n,
        "compile_s": compile_s,
        "stages_ms": {k: v * 1000 for k, v in timer.summary().items()},
    }


def evaluate(args) -> np.ndarray:
    """AP evaluation and the README's table (AP | AP0.8 | AP0.4, with the
    seen / similar / novel rows for the full test split); returns the
    (scenes, frames, 50, 6) accuracy matrices, also saved in the dump."""
    ge = GraspNetEval(args.dataset_root, camera=args.camera, split=args.split)
    res, _ = ge.eval_all(args.dump_dir, proc=args.num_workers)
    np.save(os.path.join(args.dump_dir, f"ap_{args.camera}.npy"), res)

    def row(name, r):
        s = summarize(r)
        print(f"{name:<14s} AP {s['AP']:6.2f} | AP0.8 {s['AP0.8']:6.2f} | AP0.4 {s['AP0.4']:6.2f}")

    print(f"==== {args.camera} / {args.split} ====")
    row(args.split, res)
    if args.split == "test" and len(res):
        ids = np.asarray([int(s.split("_")[1]) for s in ge.evaluated_scenes])  # res's row order
        for sub in ("test_seen", "test_similar", "test_novel"):
            mask = np.isin(ids, list(SPLITS[sub]))
            if mask.any():
                row(sub, res[mask])
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig(num_point=args.num_point)
    inference(args, cfg)
    if not args.skip_eval:
        evaluate(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
