"""Segmentation-guided grasp demo (equivalent of reference grasp_segmentation.py).

Counterpart of `graspnet_tpu/apps/segmentation_demo.py`.  Loads an RGB-D
frame + a segmentation mask PNG, deprojects the masked pixels to 3D, runs
the grasp pipeline on the full scene, and keeps only grasps whose center
lies within `seg_proximity_thresh` of the segmented object (reference
grasp_segmentation.py:61-75 deprojection, grasp proximity filter; the ROS
trigger-service wrapper lives in apps/service.py).  Runs on the card unless
`--device cpu`; `--tiny` takes `GraspNetConfig.tiny()`.

    python -m graspnet_tpu_torch.apps.segmentation_demo \
        --data_dir doc/example_data --mask masks/mask_1.png --checkpoint_path checkpoint-rs.tar
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from graspnet_tpu_torch.apps.pipeline import GraspPipeline
from graspnet_tpu_torch.apps.service import GraspService
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.data.camera import CameraInfo, create_point_cloud_from_depth_image, deproject_masked_points


def load_frame_with_mask(data_dir: str, mask_path: str):
    """Returns (scene_cloud (N,3), mask_points (K,3))."""
    import scipy.io as scio
    from PIL import Image

    depth = np.array(Image.open(os.path.join(data_dir, "depth.png")))
    meta = scio.loadmat(os.path.join(data_dir, "meta.mat"))
    intrinsic = meta["intrinsic_matrix"]
    factor_depth = float(np.asarray(meta["factor_depth"]).reshape(-1)[0])
    camera = CameraInfo(depth.shape[1], depth.shape[0], intrinsic[0][0], intrinsic[1][1], intrinsic[0][2],
                        intrinsic[1][2], factor_depth)
    cloud = create_point_cloud_from_depth_image(depth, camera, organized=True)
    scene = cloud[depth > 0]

    mask = np.array(Image.open(mask_path))
    if mask.ndim == 3:
        mask = mask[..., 0]
    if mask.shape != depth.shape:
        raise ValueError(f"mask shape {mask.shape} != depth shape {depth.shape}")
    mask_points = deproject_masked_points(mask > 0, depth, camera)
    return scene, mask_points


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--mask", required=True, help="segmentation mask PNG")
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--num_point", type=int, default=20000)
    parser.add_argument("--collision_thresh", type=float, default=0.01)
    parser.add_argument("--seg_proximity_thresh", type=float, default=0.02)
    parser.add_argument("--top_k", type=int, default=50)
    parser.add_argument("--save_ply", default=None, help="export top-K gripper meshes + scene to one PLY")
    parser.add_argument("--dump", default=None)
    parser.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() (tests)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    scene_cloud, mask_points = load_frame_with_mask(args.data_dir, args.mask)
    print(f"scene points: {len(scene_cloud)}, mask points: {len(mask_points)}")

    cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig(num_point=args.num_point)
    pipe = GraspPipeline(cfg=cfg, checkpoint_path=args.checkpoint_path, device=args.device)
    print(f"warm-up: {pipe.warmup(collision_thresh=args.collision_thresh, top_k=0):.1f}s")

    sampled = pipe.sample_cloud(scene_cloud)
    gg = pipe.run(sampled, scene_cloud=scene_cloud, collision_thresh=args.collision_thresh, top_k=0)
    n_before = len(gg)
    gg = GraspService.filter_by_mask_proximity(gg, mask_points, args.seg_proximity_thresh)
    gg = gg.sort_by_score()[: args.top_k]
    print(f"grasps: {n_before} -> {len(gg)} after segmentation filter")
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
