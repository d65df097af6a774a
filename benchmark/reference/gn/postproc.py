"""Plain post-processing of the reference: the voxel downsample, the
model-free collision detector, the greedy pose NMS and the score sort.

A frozen copy of the port's plain versions (`postproc/voxel.py`, the
blocked scan of `postproc/collision.py`, `postproc/nms.py::grasp_nms_plain`
and `GraspGroup.sort_by_score`), with the host library's voxel downsample
and fused NMS replaced by these numpy versions.  A grasp row is 17 floats:
[score, width, height, depth, 9 x rotation (row-major), 3 x centre,
object id].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

ROTATION_THRESH = 30.0 / 180.0 * np.pi

FINGER_WIDTH = 0.01
FINGER_LENGTH = 0.06
BLOCK = 8192  # scene points a block of the blocked scan


def _dot3(a0, a1, a2, b0, b1, b2):
    return (a0 * b0 + a1 * b1) + a2 * b2


def _volumes(heights, widths, approach_dist: float, voxel_size: float):
    """(lr, bottom, shift, total) analytic voxel volumes per grasp."""
    v3 = torch.tensor(voxel_size**3, dtype=heights.dtype, device=heights.device)
    lr_vol = (heights * FINGER_LENGTH * FINGER_WIDTH) / v3
    bottom_vol = (heights * (widths + 2 * FINGER_WIDTH) * FINGER_WIDTH) / v3
    shift_vol = (heights * (widths + 2 * FINGER_WIDTH) * approach_dist) / v3
    return lr_vol, bottom_vol, shift_vol, lr_vol * 2 + bottom_vol + shift_vol


def _part_masks(tx, ty, tz, h, d, w, approach_dist: float):
    """(left, right, bottom, shifting, inner) boolean volumes, the masks of
    `graspnet_tpu/postproc/collision.py:62-86` in the same comparisons."""
    mask1 = (tz > -h / 2) & (tz < h / 2)
    mask2 = (tx > d - FINGER_LENGTH) & (tx < d)
    mask3 = ty > -(w / 2 + FINGER_WIDTH)
    mask4 = ty < -w / 2
    mask5 = ty < (w / 2 + FINGER_WIDTH)
    mask6 = ty > w / 2
    mask7 = (tx <= d - FINGER_LENGTH) & (tx > d - FINGER_LENGTH - FINGER_WIDTH)
    mask8 = (tx <= d - FINGER_LENGTH - FINGER_WIDTH) & (tx > d - FINGER_LENGTH - FINGER_WIDTH - approach_dist)
    left = mask1 & mask2 & mask3 & mask4
    right = mask1 & mask2 & mask5 & mask6
    bottom = mask1 & mask3 & mask5 & mask7
    shifting = mask1 & mask3 & mask5 & mask8
    inner = mask1 & mask2 & (~mask4) & (~mask6)
    return left, right, bottom, shifting, inner


def _ious(counts, heights, widths, approach_dist: float, voxel_size: float):
    """(..., 5, M) integer counts -> global IoU (..., M), part IoUs
    (..., M, 4), inner count (..., M) int32."""
    left_c, right_c, bottom_c, shift_c, inner_c = counts.unbind(-2)
    lr_vol, bottom_vol, shift_vol, volume = _volumes(heights, widths, approach_dist, voxel_size)
    global_iou = (left_c + right_c + bottom_c + shift_c) / (volume + 1e-6)
    part_ious = torch.stack(
        [left_c / (lr_vol + 1e-6), right_c / (lr_vol + 1e-6), bottom_c / (bottom_vol + 1e-6),
         shift_c / (shift_vol + 1e-6)], dim=-1)
    return global_iou, part_ious, inner_c.to(torch.int32)


@torch.no_grad()
def collision_counts_blocked(
    scene_points: torch.Tensor,
    translations: torch.Tensor,
    rotations: torch.Tensor,
    heights: torch.Tensor,
    depths: torch.Tensor,
    widths: torch.Tensor,
    *,
    approach_dist: float = 0.03,
    voxel_size: float = 0.005,
    block: int = BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`collision_ious` over blocks of `block` scene points, holding only
    (..., block, M) coordinates and the running counts.

    scene_points (..., N, 3), translations (..., M, 3), rotations
    (..., M, 3, 3), heights / depths / widths (..., M), one leading batch
    shape for all.  tx[n, m] = <s_n, R_m[:, 0]> - <t_m, R_m[:, 0]>, and ty,
    tz alike.  A NaN point fails every volume test (each includes the
    height slab), so callers pad ragged frames with NaN rows.  The last
    block may be short.
    """
    approach_dist = max(approach_dist, FINGER_WIDTH)
    rc = [[rotations[..., j, k] for j in range(3)] for k in range(3)]  # rc[k][j]: (..., M)
    proj = [_dot3(translations[..., 0], translations[..., 1], translations[..., 2], *rc[k]) for k in range(3)]
    h, d, w = heights[..., None, :], depths[..., None, :], widths[..., None, :]
    counts = torch.zeros((*translations.shape[:-2], 5, translations.shape[-2]), dtype=torch.int64,
                         device=translations.device)
    for s0 in range(0, scene_points.shape[-2], block):
        sb = scene_points[..., s0: s0 + block, :]
        s = [sb[..., j, None] for j in range(3)]  # (..., nb, 1)
        tx, ty, tz = (_dot3(*s, *(r[..., None, :] for r in rc[k])) - proj[k][..., None, :] for k in range(3))
        masks = _part_masks(tx, ty, tz, h, d, w, approach_dist)
        counts += torch.stack([m.sum(dim=-2) for m in masks], dim=-2)
    return _ious(counts, heights, widths, approach_dist, voxel_size)


def voxel_down_sample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """(N, 3) -> (K, 3) centroid per occupied voxel."""
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) == 0:
        return pts.astype(np.float32)
    min_bound = pts.min(axis=0) - voxel_size * 0.5
    coords = np.floor((pts - min_bound) / voxel_size).astype(np.int64)
    # unique voxel ids via lexicographic packing
    dims = coords.max(axis=0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    uniq, inverse = np.unique(key, return_inverse=True)
    sums = np.zeros((len(uniq), 3), dtype=np.float64)
    np.add.at(sums, inverse, pts)
    counts = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
    return (sums / counts[:, None]).astype(np.float32)


def grasp_nms_plain(
    grasp_array: np.ndarray,
    translation_thresh: float = 0.03,
    rotation_thresh: float = ROTATION_THRESH,
) -> np.ndarray:
    """`grasp_nms` in numpy: the pairwise predicate as two small matmuls
    and a greedy pass, in the manner of
    `graspnet_tpu/postproc/nms.py:56-64`."""
    m = len(grasp_array)
    if m == 0:
        return np.zeros((0,), dtype=np.int64)
    order = np.argsort(-grasp_array[:, 0], kind="stable")
    t = np.ascontiguousarray(grasp_array[:, 13:16])
    rf = np.ascontiguousarray(grasp_array[:, 4:13])  # row-major 3x3 flat
    cos = np.clip((rf @ rf.T - 1.0) * 0.5, -1.0, 1.0)  # trace(R_a^T R_b)
    tn = np.sum(t * t, axis=1)
    d2 = tn[:, None] + tn[None, :] - 2.0 * (t @ t.T)
    close = (d2 < translation_thresh * translation_thresh) & (cos > np.cos(rotation_thresh))
    suppressed = np.zeros(m, dtype=bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= close[i]
    return np.asarray(keep, dtype=np.int64)



def sort_by_score(rows: np.ndarray) -> np.ndarray:
    """Rows descending by score, ties in row order."""
    return rows[np.argsort(-rows[:, 0], kind="stable")]


def nms(rows: np.ndarray) -> np.ndarray:
    """The rows the greedy pose NMS keeps, descending by score."""
    return rows[grasp_nms_plain(rows)]


@torch.no_grad()
def collision_mask(scene_cloud: np.ndarray, rows: np.ndarray, voxel_size: float, approach_dist: float,
                   collision_thresh: float, device) -> np.ndarray:
    """(M,) bool: the rows whose gripper collides with the raw scene cloud,
    voxel-downsampled first (the reference detector's
    `ModelFreeCollisionDetector(cloud, voxel_size).detect(...)`)."""
    if len(rows) == 0:
        return np.zeros((0,), bool)
    pts = torch.from_numpy(voxel_down_sample(scene_cloud, voxel_size)).to(device)
    r = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(device)
    global_iou, _, _ = collision_counts_blocked(
        pts, r[:, 13:16], r[:, 4:13].reshape(-1, 3, 3), r[:, 2], r[:, 3], r[:, 1],
        approach_dist=max(approach_dist, FINGER_WIDTH), voxel_size=voxel_size)
    return global_iou.cpu().numpy() > collision_thresh
