"""Model-free collision detection for grasp candidates.

Counterpart of `graspnet_tpu/postproc/collision.py` (the reference's
utils/collision_detector.py).  Scene points are moved into each gripper
frame, then boolean volumes are tested for the left and right fingers, the
bottom plate and the approach corridor; a grasp collides when its inside
count over the analytic voxel volume exceeds the threshold.  finger_width
0.01 and finger_length 0.06 are fixed, as in the reference.

The JAX package runs this as XLA (jit + `lax.scan`), with no Pallas kernel,
so here it is plain torch on the caller's device, scanning blocks of scene
points as `graspnet_tpu/postproc/collision.py:134-167` does, under its own
no-grad scope (`apps/test.py` calls it from worker threads, and grad mode is
thread-local).  Each function keeps its JAX counterpart's arithmetic: the
dense form rotates the differences, (s - t) @ R; the blocked form projects,
s @ R[:, :, k]^T - t @ R[:, :, k].  They round differently, and a point on a
face flips a mask.  The three-term dot products are written out as single
float32 products and sums in index order, so the card and the CPU compute
the same bits; divisions by a constant divide by a tensor, since a CUDA
division by a host scalar multiplies by its reciprocal.  The IoUs and the
threshold test are numpy on the host, as in the JAX package.

The raw scene's voxel downsample follows the device: on the card it is the
`csrc/voxel.cu` kernel (`ops/voxel.py`), the capture crossing the bus in
one copy (none when it is handed over as a tensor on the card, as the
service's card route does) and the downsampled scene staying there for the
scan; on the CPU it is the host library's (`native.voxel_downsample`).
Both give the same rows, in another order, and the counts do not depend
on the order.  Clouds
a caller hands over already downsampled (the eval loop's and the
`MicroBatcher`'s, spread over host threads) stay numpy and are packed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from graspnet_tpu_torch import native
from graspnet_tpu_torch.device import resolve_device
from graspnet_tpu_torch.ops.voxel import voxel_downsample
from graspnet_tpu_torch.utils.tracing import span

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
def collision_ious(
    scene_points: torch.Tensor,
    translations: torch.Tensor,
    rotations: torch.Tensor,
    heights: torch.Tensor,
    depths: torch.Tensor,
    widths: torch.Tensor,
    *,
    approach_dist: float = 0.03,
    voxel_size: float = 0.005,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-grasp collision IoUs against an (already downsampled) scene, with
    the (M, N) gripper-frame coordinates materialized.

    Args:
      scene_points: (N, 3); translations: (M, 3); rotations: (M, 3, 3);
      heights / depths / widths: (M,).

    Returns global_iou (M,), part_ious (M, 4) [left, right, bottom,
    shifting] and inner_count (M,) int32, the points inside the gripper.
    """
    approach_dist = max(approach_dist, FINGER_WIDTH)
    # (M, N) differences, then their gripper-frame coordinates (s - t) @ R
    diff = [scene_points[None, :, j] - translations[:, j, None] for j in range(3)]
    tx, ty, tz = (_dot3(*diff, rotations[:, 0, k, None], rotations[:, 1, k, None], rotations[:, 2, k, None])
                  for k in range(3))
    masks = _part_masks(tx, ty, tz, heights[:, None], depths[:, None], widths[:, None], approach_dist)
    counts = torch.stack([m.sum(dim=1) for m in masks], dim=0)
    return _ious(counts, heights, widths, approach_dist, voxel_size)


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


def _collision_counts_rows_batch(pts: torch.Tensor, rows: torch.Tensor, *, approach_dist: float,
                                 voxel_size: float, block: int = BLOCK):
    """Batched collision IoUs from packed (17-float) grasp rows: (B, N, 3)
    NaN-padded points, (B, M, 17) rows padded with identity rotations.
    One transfer each way for a whole eval batch; the rows are unpacked on
    the device."""
    b, m = rows.shape[:2]
    return collision_counts_blocked(
        pts, rows[..., 13:16], rows[..., 4:13].reshape(b, m, 3, 3), rows[..., 2], rows[..., 3], rows[..., 1],
        approach_dist=approach_dist, voxel_size=voxel_size, block=block)


def _downsample(cloud, voxel_size: float, device: torch.device):
    """A raw (N, 3) cloud's voxel downsample: the kernel for the card, whose
    (K, 3) result stays there; the host library's numpy rows for the CPU.
    A numpy cloud crosses to the card in one copy, a tensor already there
    goes straight to the kernel."""
    if isinstance(cloud, torch.Tensor):
        if device.type == "cuda":
            return voxel_downsample(cloud.to(device, torch.float32), voxel_size)
        cloud = cloud.cpu().numpy()
    cloud = np.ascontiguousarray(cloud, dtype=np.float32)
    if device.type == "cuda":
        return voxel_downsample(torch.from_numpy(cloud).to(device), voxel_size)
    return native.voxel_downsample(cloud, voxel_size)


def _pack(clouds, arrays, device: torch.device):
    """Per-frame (Ni, 3) clouds and (Mi, 17) rows -> (B, max N, 3) points
    padded with NaN and (B, max M, 17) rows padded with identity rotations,
    on `device`.  Clouds already on the device are padded there (one frame
    needs none); numpy clouds go over in one copy.  No bucketing: the JAX
    package rounds the shapes up to multiples of 8192 and 256 for XLA's
    compile cache only; the masks are integer counts and do not depend on
    the padding."""
    b = len(arrays)
    rows = np.zeros((b, max(len(a) for a in arrays), 17), np.float32)
    rows[:, :, 4:13] = np.eye(3, dtype=np.float32).reshape(9)
    for i, a in enumerate(arrays):
        rows[i, : len(a)] = a
    rows = torch.from_numpy(rows).to(device)
    n = max(len(c) for c in clouds)
    if isinstance(clouds[0], torch.Tensor):
        if b == 1:
            return clouds[0][None], rows
        pts = torch.full((b, n, 3), float("nan"), dtype=torch.float32, device=device)
        for i, c in enumerate(clouds):
            pts[i, : len(c)] = c
        return pts, rows
    pts = np.full((b, n, 3), np.nan, np.float32)
    for i, c in enumerate(clouds):
        pts[i, : len(c)] = c
    return torch.from_numpy(pts).to(device), rows


def detect_batch(
    scene_clouds,
    grasp_groups,
    *,
    voxel_size: float = 0.005,
    approach_dist: float = 0.03,
    collision_thresh: float = 0.05,
    pre_downsampled: bool = False,
    device: str | torch.device = "cuda",
    timings: Optional[dict] = None,
):
    """Per-frame collision masks for a whole batch in one device round trip,
    mask-identical to `ModelFreeCollisionDetector(cloud).detect(gg)` per
    frame.

    Args:
      scene_clouds: list of (Ni, 3) raw clouds, voxel-downsampled here
        frame by frame on `device` (the kernel on the card, the host
        library on the CPU), or numpy clouds already downsampled when
        pre_downsampled=True.
      grasp_groups: list of GraspGroup, one per cloud.
      device: where the downsample and the counts run (the card unless
        "cpu").
      timings: a dict that gets the seconds of the `collision.downsample`
        span (which counts the raw `points` and the `voxels` kept) and the
        `collision.detect` span.

    Returns a list of (mi,) bool collision masks, one per frame.
    """
    if len(scene_clouds) != len(grasp_groups):
        raise ValueError(f"{len(scene_clouds)} clouds for {len(grasp_groups)} grasp groups")
    device = resolve_device(device, "detect_batch")
    b = len(grasp_groups)
    if b == 0:
        return []
    arrays = [g.grasp_group_array for g in grasp_groups]
    ms = [len(a) for a in arrays]
    if max(ms) == 0:
        return [np.zeros((0,), bool) for _ in range(b)]
    if pre_downsampled:
        ds = [np.asarray(c, np.float32) for c in scene_clouds]
    else:
        with span("collision.downsample", into=timings) as s:
            ds = [_downsample(c, voxel_size, device) for c in scene_clouds]
            s.count(points=sum(len(c) for c in scene_clouds), voxels=sum(len(d) for d in ds))
    with span("collision.detect", into=timings):
        pts, rows = _pack(ds, arrays, device)
        global_iou, _, _ = _collision_counts_rows_batch(pts, rows, approach_dist=max(approach_dist, FINGER_WIDTH),
                                                        voxel_size=voxel_size)
        global_iou = global_iou.cpu().numpy()
    return [global_iou[i, : ms[i]] > collision_thresh for i in range(b)]


class ModelFreeCollisionDetector:
    """The reference detector (collision_detector.py:10): the scene, numpy
    or a tensor, is voxel-downsampled once on `device` (the card unless
    "cpu"), then `detect` counts each grasp group's collisions there with
    the blocked scan.  On the card the downsample is the `csrc/voxel.cu` kernel and
    `scene_points` is the (K, 3) tensor it leaves on the card; on the CPU
    it is the host library's, and `scene_points` a numpy array.  A
    `timings` dict, given to the constructor or to `detect`, gets the
    seconds of the `collision.downsample` span (which counts the raw
    `points` and the `voxels` kept) and the `collision.detect` span."""

    def __init__(self, scene_points, voxel_size: float = 0.005, device: str | torch.device = "cuda",
                 timings: Optional[dict] = None):
        self.voxel_size = voxel_size
        self.finger_width = FINGER_WIDTH
        self.finger_length = FINGER_LENGTH
        self.device = resolve_device(device, "ModelFreeCollisionDetector")
        with span("collision.downsample", into=timings) as s:
            self.scene_points = _downsample(scene_points, voxel_size, self.device)
            s.count(points=len(scene_points), voxels=len(self.scene_points))

    def detect(
        self,
        grasp_group,
        approach_dist: float = 0.03,
        collision_thresh: float = 0.05,
        return_empty_grasp: bool = False,
        empty_thresh: float = 0.01,
        return_ious: bool = False,
        timings: Optional[dict] = None,
    ):
        """The collision mask; with return_empty_grasp also the mask of
        grasps with too few points between the jaws, with return_ious also
        [global, left, right, bottom, shifting] IoUs."""
        g = grasp_group.grasp_group_array
        m = len(g)
        if m == 0:
            empty = np.zeros((0,), bool)
            if not (return_empty_grasp or return_ious):
                return empty
            ret = [empty]
            if return_empty_grasp:
                ret.append(np.zeros((0,), bool))
            if return_ious:
                ret.append([np.zeros((0,)) for _ in range(5)])
            return ret
        with span("collision.detect", into=timings):
            pts, rows = _pack([self.scene_points], [g], self.device)
            out = _collision_counts_rows_batch(pts, rows, approach_dist=max(approach_dist, FINGER_WIDTH),
                                               voxel_size=float(self.voxel_size))
            global_iou, part_ious, inner_count = (x[0].cpu().numpy() for x in out)
        collision_mask = global_iou > collision_thresh
        if not (return_empty_grasp or return_ious):
            return collision_mask
        ret = [collision_mask]
        if return_empty_grasp:
            heights, widths = g[:, 2], g[:, 1]
            inner_vol = heights * self.finger_length * widths / (self.voxel_size**3)
            ret.append(inner_count / inner_vol < empty_thresh)
        if return_ious:
            ret.append([global_iou, part_ious[:, 0], part_ious[:, 1], part_ious[:, 2], part_ious[:, 3]])
        return ret
