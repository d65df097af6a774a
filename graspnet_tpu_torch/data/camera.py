"""Camera geometry and scene-cloud host utilities.

A copy of `graspnet_tpu/data/camera.py` (reference utils/data_utils.py:
pinhole depth -> cloud, workspace AABB mask, visible-grasp-point
filtering); numpy, run in the host input pipeline ahead of the device
batch.  The visibility test is the host library's (`native.visible_mask`);
`visible_mask_plain` is its numpy plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from graspnet_tpu_torch import native


@dataclasses.dataclass
class CameraInfo:
    """Pinhole intrinsics (reference data_utils.py:7-16)."""

    width: float
    height: float
    fx: float
    fy: float
    cx: float
    cy: float
    scale: float  # depth units per meter (factor_depth)


def create_point_cloud_from_depth_image(
    depth: np.ndarray, camera: CameraInfo, organized: bool = True
) -> np.ndarray:
    """Back-project a depth image to a cloud (reference data_utils.py:18-43)."""
    assert depth.shape[0] == camera.height and depth.shape[1] == camera.width
    xmap, ymap = np.meshgrid(np.arange(camera.width), np.arange(camera.height))
    z = depth / camera.scale
    x = (xmap - camera.cx) * z / camera.fx
    y = (ymap - camera.cy) * z / camera.fy
    cloud = np.stack([x, y, z], axis=-1).astype(np.float32)
    return cloud if organized else cloud.reshape(-1, 3)


def deproject_masked_points(
    mask: np.ndarray, depth: np.ndarray, camera: CameraInfo
) -> np.ndarray:
    """Back-project only the pixels selected by a boolean/label mask.

    Vectorized equivalent of the reference's per-pixel
    rs2_deproject_pixel_to_point loop (grasp_segmentation.py:61-75): pixels
    with zero depth are dropped; returns (K, 3) float32 points in meters.
    """
    if mask is None or depth is None:
        return np.zeros((0, 3), np.float32)
    assert mask.shape == depth.shape, (mask.shape, depth.shape)
    ys, xs = np.nonzero(mask)
    z = depth[ys, xs] / camera.scale
    valid = z > 0
    xs, ys, z = xs[valid], ys[valid], z[valid]
    x = (xs - camera.cx) * z / camera.fx
    y = (ys - camera.cy) * z / camera.fy
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def transform_point_cloud_np(cloud: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """(N,3) x (3,3)|(3,4)|(4,4) -> (N,3)."""
    if transform.shape == (3, 3):
        return (transform @ cloud.T).T
    rot, trans = transform[:3, :3], transform[:3, 3]
    return (rot @ cloud.T).T + trans


def compute_point_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise Euclidean distances (N, M)."""
    return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)


def visible_mask_plain(cloud: np.ndarray, pts: np.ndarray, th: float) -> np.ndarray:
    """(N, 3) scene cloud, (M, 3) points -> (M,) bool: the nearest scene
    point lies closer than `th` (numpy, chunked to bound the (M, N)
    distance matrix); the plain version of `native.visible_mask`."""
    out = np.empty(len(pts), dtype=bool)
    step = 4096
    for i in range(0, len(pts), step):
        d = compute_point_dists(pts[i : i + step], cloud)
        out[i : i + step] = d.min(axis=1) < th
    return out


def remove_invisible_grasp_points(
    cloud: np.ndarray, grasp_points: np.ndarray, pose: np.ndarray, th: float = 0.01
) -> np.ndarray:
    """Visibility mask for object grasp points vs the scene cloud
    (reference data_utils.py:91-112): keep label points whose nearest scene
    point is closer than `th` after transforming into the scene frame."""
    trans = transform_point_cloud_np(grasp_points, pose)
    return native.visible_mask(cloud, trans, th)


def get_workspace_mask(
    cloud: np.ndarray,
    seg: np.ndarray,
    trans: np.ndarray | None = None,
    organized: bool = True,
    outlier: float = 0.0,
) -> np.ndarray:
    """AABB-of-foreground workspace mask (reference data_utils.py:114-148)."""
    shape = cloud.shape[:2] if organized else None
    pts = cloud.reshape(-1, 3)
    seg_flat = seg.reshape(-1)
    if trans is not None:
        pts = transform_point_cloud_np(pts, trans)
    fg = pts[seg_flat > 0]
    mins = fg.min(axis=0) - outlier
    maxs = fg.max(axis=0) + outlier
    mask = np.all((pts > mins) & (pts < maxs), axis=1)
    return mask.reshape(shape) if organized else mask
