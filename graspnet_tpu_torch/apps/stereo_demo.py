"""Grasp pipeline over externally-produced stereo clouds (equivalent of
reference foundationstereo.py): .ply clouds from a stereo system, intrinsics
from a K txt file (4 or 9 numbers), optional mask-proximity segmentation
filter, best-grasp pose output.

Counterpart of `graspnet_tpu/apps/stereo_demo.py`; runs on the card unless
`--device cpu`, `--tiny` takes `GraspNetConfig.tiny()`.

    python -m graspnet_tpu_torch.apps.stereo_demo --cloud_path cloud.ply \
        --intrinsics K.txt --mask_path mask.png --depth_path depth.png
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from graspnet_tpu_torch.apps.demo_pointcloud import load_cloud
from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.sensors.cameras import load_intrinsics_txt


def deproject_masked_points(mask: np.ndarray, depth_m: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Back-project masked pixels to 3D (reference grasp_segmentation.py:61-75).

    K-matrix convenience wrapper over data.camera.deproject_masked_points;
    depth is in meters (scale=1).
    """
    from graspnet_tpu_torch.data.camera import CameraInfo
    from graspnet_tpu_torch.data.camera import deproject_masked_points as _deproject

    cam = CameraInfo(depth_m.shape[1], depth_m.shape[0], K[0, 0], K[1, 1], K[0, 2], K[1, 2], 1.0)
    return _deproject(mask, depth_m, cam)


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cloud_path", required=True, help=".ply from the stereo system")
    p.add_argument("--intrinsics", default=None, help="K txt (4 or 9 numbers)")
    p.add_argument("--mask_path", default=None, help="PNG mask for segmentation filter")
    p.add_argument("--depth_path", default=None, help="depth PNG (mm) for mask deprojection")
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--collision_thresh", type=float, default=0.01)
    p.add_argument("--seg_proximity_thresh", type=float, default=0.02)
    p.add_argument("--z_max", type=float, default=1.2)
    p.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() (tests)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cloud = load_cloud(args.cloud_path)
    cloud = cloud[(cloud[:, 2] > 0) & (cloud[:, 2] <= args.z_max)]

    mask_points = None
    if args.mask_path and args.depth_path and args.intrinsics:
        from PIL import Image

        K = load_intrinsics_txt(args.intrinsics)
        mask = np.asarray(Image.open(args.mask_path)) > 0
        depth = np.asarray(Image.open(args.depth_path)).astype(np.float32) / 1000.0
        mask_points = deproject_masked_points(mask, depth, K)
        print(f"mask points: {len(mask_points)}")

    service = GraspService(
        ServiceConfig(
            checkpoint_path=args.checkpoint_path,
            model_cfg=GraspNetConfig.tiny() if args.tiny else None,
            collision_thresh=args.collision_thresh,
            seg_proximity_thresh=args.seg_proximity_thresh,
            depth_min=0.0,
            depth_max=args.z_max,
            device=args.device,
        )
    )
    out = service.compute(cloud, mask_points=mask_points)
    if out["ok"]:
        print(f"grasps: {out['num_grasps']}  best score: {out['best_score']:.4f}")
        print("best grasp pose:\n", np.asarray(out["best_pose"]))
    else:
        print("FAILED:", out["error"])
    return out


if __name__ == "__main__":
    main()
