"""The grasp-label pipeline of the full label path: the host half in numpy
(seed chain, view re-indexing, nearest label point, the per-seed label
slabs) on the plain versions of the port's host library (`fps_numpy`,
`nearest`, `label_view_stats`), and the device half in torch (the log
rescale, the per-view reduction, the slice at the predicted top view).
A frozen copy of the port's `train/label_pipeline.py` without its compact
path, which the port holds bitwise equal to the full one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .config import GraspNetConfig
from . import geometry

# ----------------------------------------------------------------- device --


def process_grasp_labels(
    end_points: Dict[str, Any], labels: Dict[str, torch.Tensor], cfg: GraspNetConfig
) -> Dict[str, torch.Tensor]:
    """Device half of the full path (`label_pipeline.py:42-76`): log
    rescale with the batch-global max and the per-view max over (A, D).
    A `label_u_max` in `labels` (the max over every data-parallel rank's
    scenes) takes the place of this batch's own max."""
    raw = labels["grasp_labels"].float()
    widths = labels["grasp_widths"].float()
    mask = (raw > 0) & (widths <= cfg.grasp_max_width)
    u_max = labels["label_u_max"] if "label_u_max" in labels else torch.max(raw)  # batch-global max
    rescaled = torch.where(mask, torch.log(u_max / torch.where(mask, raw, 1.0)), 0.0)
    b, ns, v, a, d = rescaled.shape
    view_label = torch.amax(rescaled.reshape(b, ns, v, a * d), dim=-1)
    # per-seed view rotations: the seed's object slot
    bidx = torch.arange(b, device=raw.device)[:, None]
    view_rot = labels["obj_view_rot"][bidx, labels["seed_obj"]]  # (B, Ns, V, 3, 3)
    return {
        "batch_grasp_point": labels["grasp_points"],
        "batch_grasp_view_rot": view_rot,
        "batch_grasp_label": rescaled,
        "batch_grasp_width": widths,
        "batch_grasp_tolerance": labels["grasp_tolerance"].float(),
        "batch_grasp_view_label": view_label,
    }


def match_grasp_view_and_label(end_points: Dict[str, Any], cfg: GraspNetConfig) -> Dict[str, torch.Tensor]:
    """The (A, D) slabs and the rotation of the predicted top view per seed
    (`label_pipeline.py:79-101`)."""
    top = end_points["grasp_top_view_inds"]  # (B, Ns)

    def at_top(x):
        idx = top.reshape(*top.shape, 1, *([1] * (x.dim() - 3)))
        return torch.gather(x, 2, idx.expand(*top.shape, 1, *x.shape[3:]))[:, :, 0]

    return {
        "batch_grasp_view_rot": at_top(end_points["batch_grasp_view_rot"]),
        "batch_grasp_label": at_top(end_points["batch_grasp_label"]),
        "batch_grasp_width": at_top(end_points["batch_grasp_width"]),
        "batch_grasp_tolerance": at_top(end_points["batch_grasp_tolerance"]),
    }


def process_matched_labels(labels: Dict[str, torch.Tensor], cfg: GraspNetConfig) -> Dict[str, torch.Tensor]:
    """Device rescale for the compact path (`label_pipeline.py:592-616`);
    `label_u_max` is the batch-global raw max from the host."""
    u_max = labels["label_u_max"].float()
    raw = labels["matched_label_raw"].float()
    width = labels["batch_grasp_width"].float()
    mask = (raw > 0) & (width <= cfg.grasp_max_width)
    label = torch.where(mask, torch.log(u_max / torch.where(mask, raw, 1.0)), 0.0)
    lmin = labels["view_lmin"].float()
    view_label = torch.where(labels["view_has"], torch.log(u_max / lmin), 0.0)
    return {
        "batch_grasp_point": labels["batch_grasp_point"],
        "batch_grasp_view_rot": labels["batch_grasp_view_rot"],
        "batch_grasp_label": label,
        "batch_grasp_width": width,
        "batch_grasp_tolerance": labels["batch_grasp_tolerance"].float(),
        "batch_grasp_view_label": view_label,
    }


# ------------------------------------------------------------------- host --


def fps_numpy(xyz: np.ndarray, npoint: int) -> np.ndarray:
    """Host FPS with the device semantics (`label_pipeline.py:107-122`): the
    plain version of `native.fps`."""
    n = xyz.shape[0]
    mag = np.sum(xyz.astype(np.float32) ** 2, axis=1)
    valid = mag > 1e-3
    temp = np.full(n, 1e10, dtype=np.float32)
    idxs = np.zeros(npoint, dtype=np.int32)
    old = 0
    for j in range(1, npoint):
        diff = (xyz - xyz[old]).astype(np.float32)
        d = np.sum(diff * diff, axis=1)
        np.minimum(d, temp, out=temp, where=valid)
        score = np.where(valid, temp, -1.0)
        old = int(np.argmax(score))
        idxs[j] = old
    return idxs


def nearest(query: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """(Nq, 3), (Nr, 3) -> (Nq,) int32 nearest-ref index per query: the
    difference-form squared distance, blocked over ref, strictly-less
    updates (first-occurrence argmin), `native/__init__.py:121-143`; the
    plain version of `native.nearest`."""
    query = np.ascontiguousarray(query, dtype=np.float32)
    ref = np.ascontiguousarray(ref, dtype=np.float32)
    out = np.zeros(len(query), dtype=np.int32)
    best = np.full(len(query), np.inf, dtype=np.float32)
    step = 8192
    for s in range(0, len(ref), step):
        d2 = np.sum((query[:, None] - ref[None, s : s + step]) ** 2, axis=-1)
        arg = d2.argmin(axis=1)
        dmin = d2[np.arange(len(query)), arg]
        upd = dmin < best
        best[upd] = dmin[upd]
        out[upd] = (arg[upd] + s).astype(np.int32)
    return out


def label_view_stats(scores: np.ndarray, widths: np.ndarray, max_width: float):
    """(Np, V, A, D) scores/widths -> lmin (Np, V) f32 (the masked minimum
    score, mask = score > 0 and width <= max_width), has (Np, V) bool, vmax
    (Np, V) f32 (the raw maximum), `native/__init__.py:149-167`; the plain
    version of `native.label_view_stats`."""
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    widths = np.ascontiguousarray(widths, dtype=np.float32)
    npo, v = scores.shape[0], scores.shape[1]
    ad = int(np.prod(scores.shape[2:], dtype=np.int64)) if scores.ndim > 2 else 1
    mask = (scores > 0) & (widths <= max_width)
    lmin = np.where(mask, scores, np.inf).reshape(npo, v, ad).min(axis=-1, initial=np.inf)
    has = mask.reshape(npo, v, ad).any(axis=-1)
    vmax = scores.reshape(npo, v, ad).max(axis=-1, initial=-np.inf)
    return lmin.astype(np.float32), has, vmax.astype(np.float32)


def seed_chain(cloud: np.ndarray, cfg: GraspNetConfig, fps=fps_numpy):
    """The backbone's FPS chain on the host (`label_pipeline.py:125-142`):
    per-stage int32 indices, each into the previous stage's points, and the
    sa2-level seed coordinates.  `fps` is the host library's; the tests
    pass `fps_numpy`."""
    cloud = np.ascontiguousarray(cloud, dtype=np.float32)
    sa1 = fps(cloud, cfg.sa1.npoint)
    xyz1 = np.ascontiguousarray(cloud[sa1])
    sa2 = fps(xyz1, cfg.sa2.npoint)
    xyz2 = np.ascontiguousarray(xyz1[sa2])
    sa3 = fps(xyz2, cfg.sa3.npoint)
    xyz3 = np.ascontiguousarray(xyz2[sa3])
    sa4 = fps(xyz3, cfg.sa4.npoint)
    return {"sa1": sa1, "sa2": sa2, "sa3": sa3, "sa4": sa4}, xyz2


def assign_views(pose_rot: np.ndarray, num_view: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-object view re-indexing (label_generation.py:48-67): for each
    canonical view, the object-frame view whose rotated direction lands
    nearest, and the pose-rotated template rotations so re-indexed."""
    views = geometry.generate_grasp_views_np(num_view)  # (V, 3)
    views_trans = views @ pose_rot.T
    view_inds = nearest(views.astype(np.float32), views_trans.astype(np.float32)).astype(np.int32)
    rots = geometry.canonical_view_rotations_np(num_view)  # (V, 3, 3)
    rot_trans = np.einsum("ij,vjk->vik", pose_rot, rots)  # pose @ rot
    return view_inds, rot_trans[view_inds]


def _merge_objects(object_poses, grasp_points_list, num_view: int, max_objects: int):
    """Label points of every object in the scene frame, their object slot
    and local index, and each object's view re-indexing and rotations."""
    points_merged: List[np.ndarray] = []
    point_obj: List[np.ndarray] = []
    point_local: List[np.ndarray] = []
    view_inds_per_obj: List[np.ndarray] = []
    obj_view_rot = np.zeros((max_objects, num_view, 3, 3), dtype=np.float32)
    for o, pose in enumerate(object_poses):
        pose = np.asarray(pose, dtype=np.float32)
        pts = grasp_points_list[o].astype(np.float32)
        points_merged.append(pts @ pose[:3, :3].T + pose[:3, 3])
        point_obj.append(np.full(len(pts), o, dtype=np.int32))
        point_local.append(np.arange(len(pts), dtype=np.int32))
        view_inds, rot_trans = assign_views(pose[:3, :3], num_view)
        view_inds_per_obj.append(view_inds)
        obj_view_rot[o] = rot_trans
    return (np.concatenate(points_merged, axis=0), np.concatenate(point_obj),
            np.concatenate(point_local), view_inds_per_obj, obj_view_rot)


def build_scene_labels(
    cloud: np.ndarray,
    seed_xyz: np.ndarray,
    object_poses: Sequence[np.ndarray],  # list of (3, 4)
    grasp_points_list: Sequence[np.ndarray],  # (Np_o, 3) object frame
    grasp_scores_list: Sequence[np.ndarray],  # (Np_o, V, A, D) collision-zeroed
    grasp_widths_list: Sequence[np.ndarray],  # (Np_o, V, A, D)
    grasp_tolerance_list: Sequence[np.ndarray],  # (Np_o, V, A, D)
    cfg: GraspNetConfig,
    max_objects: int = 16,
) -> Dict[str, np.ndarray]:
    """Host half of the full path (`label_pipeline.py:170-244`): merge the
    objects, assign each seed its nearest label point, gather per-seed
    (V, A, D) slabs with the object's view re-indexing."""
    ns = seed_xyz.shape[0]
    v, a, d = cfg.num_view, cfg.num_angle, cfg.num_depth
    n_obj = len(object_poses)
    assert 1 <= n_obj <= max_objects, "a scene holds 1..max_objects labelled objects"
    points_merged, point_obj, point_local, view_inds_per_obj, obj_view_rot = _merge_objects(
        object_poses, grasp_points_list, v, max_objects)

    nn = nearest(seed_xyz.astype(np.float32), points_merged)  # (Ns,)
    seed_obj = point_obj[nn]
    seed_local = point_local[nn]

    labels = np.zeros((ns, v, a, d), dtype=np.float32)
    widths = np.zeros((ns, v, a, d), dtype=np.float32)
    tolerance = np.zeros((ns, v, a, d), dtype=np.float32)
    for o in range(n_obj):
        sel = np.nonzero(seed_obj == o)[0]
        if len(sel) == 0:
            continue
        ix = (seed_local[sel][:, None], view_inds_per_obj[o][None, :])
        labels[sel] = grasp_scores_list[o][ix]
        widths[sel] = grasp_widths_list[o][ix]
        tolerance[sel] = grasp_tolerance_list[o][ix]

    return {
        "grasp_points": points_merged[nn].astype(np.float32),  # (Ns, 3)
        "seed_obj": seed_obj.astype(np.int32),
        "obj_view_rot": obj_view_rot,
        "grasp_labels": labels,
        "grasp_widths": widths,
        "grasp_tolerance": tolerance,
    }
