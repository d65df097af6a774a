"""Single RGB-D frame grasp demo (equivalent of reference image_demo.py).

Counterpart of `graspnet_tpu/apps/image_demo.py`.  Loads color/depth/
meta(.mat) (+ optional workspace mask), back-projects to a cloud, samples
num_point points, runs the network, optionally collision-filters, and
prints/saves the best grasps.  Runs on the card unless `--device cpu`;
`--tiny` takes `GraspNetConfig.tiny()`; `--profile_dir` writes a
torch.profiler trace of the frame (`utils/tracing.py`).

    python -m graspnet_tpu_torch.apps.image_demo \
        --data_dir doc/example_data --checkpoint_path checkpoint-rs.tar --collision_thresh -1
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from graspnet_tpu_torch.apps.pipeline import GraspPipeline
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.data.camera import CameraInfo, create_point_cloud_from_depth_image


def load_frame(
    data_dir: str,
    use_workspace_mask: bool = True,
    depth_path: str | None = None,
    meta_path: str | None = None,
):
    """Load an RGB-D frame: the reference demo-data layout
    (color.png/depth.png/meta.mat + workspace_mask.png in `data_dir`) or
    explicit file paths (the zividtest.py calling convention)."""
    import scipy.io as scio
    from PIL import Image

    depth = np.array(Image.open(depth_path or os.path.join(data_dir, "depth.png")))
    meta = scio.loadmat(meta_path or os.path.join(data_dir, "meta.mat"))
    intrinsic = meta["intrinsic_matrix"]
    factor_depth = float(np.asarray(meta["factor_depth"]).reshape(-1)[0])
    camera = CameraInfo(depth.shape[1], depth.shape[0], intrinsic[0][0], intrinsic[1][1], intrinsic[0][2],
                        intrinsic[1][2], factor_depth)
    cloud = create_point_cloud_from_depth_image(depth, camera, organized=True)
    mask = depth > 0
    mask_path = os.path.join(data_dir, "workspace_mask.png")
    if use_workspace_mask and os.path.exists(mask_path):
        workspace = np.array(Image.open(mask_path)) > 0
        mask = mask & workspace
    return cloud[mask]


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--depth_path", default=None, help="explicit depth PNG")
    parser.add_argument("--meta_path", default=None, help="explicit meta.mat")
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--num_point", type=int, default=20000)
    parser.add_argument("--collision_thresh", type=float, default=-1.0)
    parser.add_argument("--voxel_size", type=float, default=0.01)
    parser.add_argument("--top_k", type=int, default=50)
    parser.add_argument("--save_ply", default=None, help="export top-K gripper meshes + scene to one PLY")
    parser.add_argument("--dump", default=None, help="save grasps to .npy")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", default=None, help="write a torch.profiler trace of the frame here")
    parser.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() (tests)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig(num_point=args.num_point)
    pipe = GraspPipeline(cfg=cfg, checkpoint_path=args.checkpoint_path, seed=args.seed, device=args.device)
    print(f"warm-up: {pipe.warmup(collision_thresh=args.collision_thresh, top_k=args.top_k):.1f}s")

    if not args.data_dir and not (args.depth_path and args.meta_path):
        raise SystemExit("need --data_dir or --depth_path + --meta_path")
    scene_cloud = load_frame(args.data_dir or "", depth_path=args.depth_path, meta_path=args.meta_path)
    print(f"scene points: {len(scene_cloud)}")
    sampled = pipe.sample_cloud(scene_cloud)
    from graspnet_tpu_torch.utils.tracing import device_trace

    timings = {"collision": 0.0}
    with device_trace(args.profile_dir):
        gg = pipe.run(sampled, scene_cloud=scene_cloud, collision_thresh=args.collision_thresh,
                      voxel_size=args.voxel_size, top_k=args.top_k, timings=timings)
    print(f"grasps: {len(gg)}  infer: {timings['infer'] * 1000:.1f}ms  "
          f"collision: {timings['collision'] * 1000:.1f}ms")
    for g in gg[:5].grasp_group_array:
        print(f"  score={g[0]:+.4f} width={g[1]:.3f} depth={g[3]:.3f} center=({g[13]:+.3f},{g[14]:+.3f},{g[15]:+.3f})")
    if len(gg):
        print("best grasp pose:\n", gg[0].to_matrix())
    if args.dump:
        gg.save_npy(args.dump)
        print("saved:", args.dump)
    if args.save_ply:
        from graspnet_tpu_torch.postproc.gripper import save_grasps_scene_ply

        save_grasps_scene_ply(gg, scene_cloud, args.save_ply)
        print("saved:", args.save_ply)


if __name__ == "__main__":
    main()
