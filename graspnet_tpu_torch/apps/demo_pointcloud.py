"""Grasp demo over raw point-cloud files (equivalent of reference
demo_pointcloud.py): .npy/.npz/.ply input, optional z-range filter, network,
collision filter, NMS + top-K output.

Counterpart of `graspnet_tpu/apps/demo_pointcloud.py`; runs on the card
unless `--device cpu`, `--tiny` takes `GraspNetConfig.tiny()`.

    python -m graspnet_tpu_torch.apps.demo_pointcloud --cloud_path scene.ply --checkpoint_path CKPT
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from graspnet_tpu_torch.apps.pipeline import GraspPipeline
from graspnet_tpu_torch.config import GraspNetConfig


def load_cloud(path: str) -> np.ndarray:
    """Load (N, 3) float32 points from .npy / .npz / .ply."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        arr = np.load(path)
    elif ext == ".npz":
        data = np.load(path)
        key = "points" if "points" in data else list(data.keys())[0]
        arr = data[key]
    elif ext == ".ply":
        from graspnet_tpu_torch.eval.ap import load_ply_points

        arr = load_ply_points(path)
    else:
        raise ValueError(f"unsupported cloud format: {ext}")
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr.reshape(-1, arr.shape[-1])
    return arr[:, :3]


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cloud_path", required=True)
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--num_point", type=int, default=20000)
    p.add_argument("--collision_thresh", type=float, default=0.01)
    p.add_argument("--voxel_size", type=float, default=0.01)
    p.add_argument("--z_min", type=float, default=None)
    p.add_argument("--z_max", type=float, default=None)
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--save_ply", default=None, help="export top-K gripper meshes + scene to one PLY")
    p.add_argument("--dump", default=None)
    p.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() (tests)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cloud = load_cloud(args.cloud_path)
    if args.z_min is not None:
        cloud = cloud[cloud[:, 2] >= args.z_min]
    if args.z_max is not None:
        cloud = cloud[cloud[:, 2] <= args.z_max]
    print(f"cloud points after filter: {len(cloud)}")

    cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig(num_point=args.num_point)
    pipe = GraspPipeline(cfg=cfg, checkpoint_path=args.checkpoint_path, device=args.device)
    print(f"warm-up: {pipe.warmup(collision_thresh=args.collision_thresh, top_k=args.top_k):.1f}s")
    sampled = pipe.sample_cloud(cloud)
    timings = {}
    gg = pipe.run(sampled, scene_cloud=cloud, collision_thresh=args.collision_thresh,
                  voxel_size=args.voxel_size, top_k=args.top_k, timings=timings)
    print(f"grasps: {len(gg)} (infer {timings['infer'] * 1000:.1f}ms)")
    if len(gg):
        print("best grasp pose:\n", gg[0].to_matrix())
    if args.dump:
        gg.save_npy(args.dump)
    if args.save_ply:
        from graspnet_tpu_torch.postproc.gripper import save_grasps_scene_ply

        save_grasps_scene_ply(gg, cloud, args.save_ply)
        print("saved:", args.save_ply)


if __name__ == "__main__":
    main()
