"""Grasp-label pipeline: the host half in numpy, the device half in torch.

Counterpart of `graspnet_tpu/train/label_pipeline.py` (the reference builds
its labels inside the forward, utils/label_generation.py:18-151).

HOST (numpy, parameter-independent): the FPS seed chain, per-object view
re-indexing, label-point transforms, seed -> nearest label point, and the
per-seed (Ns, V, A, D) label slabs (`build_scene_labels`, the full path);
or, for the compact two-phase path, the per-object (point, view) stats
(`prepare_scene_labels`) and, once the pre-pass has picked the top views,
the matched (Ns, A, D) slabs (`static_scene_labels`,
`matched_scene_labels`); the dataset's indexed form of it keeps row indices
into the full per-object label arrays instead of per-frame copies
(`prepare_scene_labels_indexed`).  Line-for-line copies of the JAX
package's host functions, so host labels are bitwise the same.  The FPS
chain, the nearest-point assignment and the per-view statistics run in the
C++ host library (`native.py`), as the JAX package's do; `fps_numpy`,
`nearest` and `label_view_stats` below are their numpy plain versions.

DEVICE (torch, inside the step): the log rescale with the batch-global max
and the per-view reduction (`process_grasp_labels`,
`process_matched_labels`), and the slice at the predicted top view
(`match_grasp_view_and_label`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from graspnet_tpu_torch import native
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import geometry

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


def seed_chain(cloud: np.ndarray, cfg: GraspNetConfig, fps=native.fps):
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
    view_inds = native.nearest(views.astype(np.float32), views_trans.astype(np.float32)).astype(np.int32)
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

    nn = native.nearest(seed_xyz.astype(np.float32), points_merged)  # (Ns,)
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


# ------------------------------------------------- compact two-phase path --
#
# The full path ships three (B, Ns, V, A, D) slabs (~118 MB each at B=2 and
# the production config) for the step to keep one view of each per seed.
# The compact path keeps per-object (point, view) stats on the host, lets a
# stage-1 pre-pass pick the top views, then ships only the matched
# (Ns, A, D) slabs.  Bitwise equal to the full path: log(u_max / x) is
# decreasing in x, so the max over (A, D) of the rescaled slab is the
# rescale of the masked minimum, the same float op on the same element.


class SceneLabelContext:
    """Host-side per-scene label state between the two phases."""

    __slots__ = (
        "grasp_points", "seed_obj", "seed_local", "obj_view_rot",
        "view_inds_per_obj", "scores_list", "widths_list", "tol_list",
        "lmin_per_obj", "has_per_obj", "scene_umax", "ns",
    )

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def prepare_scene_labels(
    seed_xyz: np.ndarray,
    object_poses: Sequence[np.ndarray],
    grasp_points_list: Sequence[np.ndarray],
    grasp_scores_list: Sequence[np.ndarray],
    grasp_widths_list: Sequence[np.ndarray],
    grasp_tolerance_list: Sequence[np.ndarray],
    cfg: GraspNetConfig,
    max_objects: int = 16,
) -> SceneLabelContext:
    """Phase A (`label_pipeline.py:280-356`): `build_scene_labels`'
    transforms and assignment, plus each object's (Np, V) masked score
    minimum, its any-mask, and the scene's raw max over the gathered views
    (the reference's u_max contribution)."""
    v = cfg.num_view
    n_obj = len(object_poses)
    assert 1 <= n_obj <= max_objects
    points_merged, point_obj, point_local, view_inds_per_obj, obj_view_rot = _merge_objects(
        object_poses, grasp_points_list, v, max_objects)

    nn = native.nearest(seed_xyz.astype(np.float32), points_merged)  # (Ns,)
    seed_obj = point_obj[nn]
    seed_local = point_local[nn]

    lmin_per_obj, has_per_obj = [], []
    scene_umax = np.float32(-np.inf)
    for o in range(n_obj):
        s = grasp_scores_list[o].astype(np.float32, copy=False)
        w = grasp_widths_list[o].astype(np.float32, copy=False)
        lmin, has, vmax = native.label_view_stats(s, w, cfg.grasp_max_width)
        lmin_per_obj.append(lmin)
        has_per_obj.append(has)
        sel = np.unique(seed_local[seed_obj == o])
        if len(sel):
            # raw max incl. unmasked elements -> the reference u_max
            scene_umax = max(scene_umax, vmax[np.ix_(sel, view_inds_per_obj[o])].max())

    return SceneLabelContext(
        grasp_points=points_merged[nn].astype(np.float32),
        seed_obj=seed_obj.astype(np.int32),
        seed_local=seed_local.astype(np.int32),
        obj_view_rot=obj_view_rot,
        view_inds_per_obj=view_inds_per_obj,
        scores_list=[np.asarray(x, np.float32) for x in grasp_scores_list],
        widths_list=[np.asarray(x, np.float32) for x in grasp_widths_list],
        tol_list=[np.asarray(x, np.float32) for x in grasp_tolerance_list],
        lmin_per_obj=lmin_per_obj,
        has_per_obj=has_per_obj,
        scene_umax=np.float32(scene_umax),
        ns=seed_xyz.shape[0],
    )


def static_scene_labels(
    ctx: "SceneLabelContext | IndexedSceneLabelContext", cfg: GraspNetConfig
) -> Dict[str, np.ndarray]:
    """The top-view-independent half of phase B (`label_pipeline.py:359-389`):
    grasp points and the per-(seed, view) masked minima, from either kind
    of context."""
    ns, v = ctx.ns, cfg.num_view
    view_lmin = np.zeros((ns, v), np.float32)
    view_has = np.zeros((ns, v), np.bool_)
    indexed = isinstance(ctx, IndexedSceneLabelContext)
    lmins = ctx.lmin_rows if indexed else ctx.lmin_per_obj
    hass = ctx.has_rows if indexed else ctx.has_per_obj
    for o in range(len(lmins)):
        sel = np.nonzero(ctx.seed_obj == o)[0]
        if len(sel) == 0:
            continue
        ix = np.ix_(ctx.seed_local[sel], ctx.view_inds_per_obj[o])
        view_lmin[sel] = lmins[o][ix]
        view_has[sel] = hass[o][ix]
    return {
        "batch_grasp_point": ctx.grasp_points,
        "view_lmin": np.where(view_has, view_lmin, 1.0).astype(np.float32),
        "view_has": view_has,
    }


def matched_scene_labels(
    ctx: "SceneLabelContext | IndexedSceneLabelContext", top_view: np.ndarray, cfg: GraspNetConfig
) -> Dict[str, np.ndarray]:
    """The top-view-dependent half of phase B (`label_pipeline.py:392-423`):
    raw (un-rescaled) slabs and rotations at each seed's predicted view."""
    if isinstance(ctx, IndexedSceneLabelContext):
        return _matched_indexed(ctx, top_view, cfg)
    ns, a, d = ctx.ns, cfg.num_angle, cfg.num_depth
    top_view = np.asarray(top_view, np.int64)
    label = np.zeros((ns, a, d), np.float32)
    width = np.zeros((ns, a, d), np.float32)
    tol = np.zeros((ns, a, d), np.float32)
    for o in range(len(ctx.scores_list)):
        sel = np.nonzero(ctx.seed_obj == o)[0]
        if len(sel) == 0:
            continue
        lp = ctx.seed_local[sel]
        ov = ctx.view_inds_per_obj[o][top_view[sel]]  # object-frame view of the top view
        label[sel] = ctx.scores_list[o][lp, ov]
        width[sel] = ctx.widths_list[o][lp, ov]
        tol[sel] = ctx.tol_list[o][lp, ov]
    rot = ctx.obj_view_rot[ctx.seed_obj, top_view]  # (Ns, 3, 3)
    return {
        "batch_grasp_view_rot": rot.astype(np.float32),
        "matched_label_raw": label,
        "batch_grasp_width": width,
        "batch_grasp_tolerance": tol,
    }


def finalize_scene_labels(
    ctx: SceneLabelContext, top_view: np.ndarray, cfg: GraspNetConfig
) -> Dict[str, np.ndarray]:
    """Phase B whole: `static_scene_labels` + `matched_scene_labels`."""
    out = static_scene_labels(ctx, cfg)
    out.update(matched_scene_labels(ctx, top_view, cfg))
    return out


# ------------------------------------------- indexed compact path --
#
# The dataset's form of the compact path (`label_pipeline.py:426-589`): the
# per-frame state is the subsampled row indices into each object's FULL
# label arrays (shared across frames and epochs), and the per-(point, view)
# stats of the collision-zeroed full arrays come from a per-(scene,
# object) cache (`GraspNetDataset._object_stats`).  Phase B gathers the
# matched slabs straight from the full arrays and zeroes collisions as it
# gathers: every element is the float32 the copy path would produce, so
# the step is bitwise the same.


class IndexedSceneLabelContext:
    """Compact-path per-scene state: row indices and full-array references."""

    __slots__ = (
        "grasp_points", "seed_obj", "seed_local", "obj_view_rot",
        "view_inds_per_obj", "rows_per_obj", "scores_full", "widths_full",
        "tol_full", "coll_full", "lmin_rows", "has_rows", "scene_umax", "ns",
    )

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def prepare_scene_labels_indexed(
    seed_xyz: np.ndarray,
    object_poses: Sequence[np.ndarray],
    objects: Sequence[Dict[str, np.ndarray]],
    cfg: GraspNetConfig,
    max_objects: int = 16,
) -> IndexedSceneLabelContext:
    """Phase A of the indexed path (`label_pipeline.py:465-549`).

    `objects[o]` holds 'rows' (subsampled row indices into the full label
    arrays, visibility applied), the full arrays 'points' / 'scores' /
    'widths' (may be the strided offsets[..., 2] view) / 'tol' / 'coll',
    and the cached collision-zeroed stats 'lmin' / 'has' / 'vmax' over the
    full rows ((Np, V) each, object-frame views)."""
    v = cfg.num_view
    n_obj = len(objects)
    assert 1 <= n_obj <= max_objects, "a scene holds 1..max_objects labelled objects"
    points_merged, point_obj, point_local, view_inds_per_obj, obj_view_rot = _merge_objects(
        object_poses, [ob["points"][ob["rows"]] for ob in objects], v, max_objects)

    nn = native.nearest(seed_xyz.astype(np.float32), points_merged)  # (Ns,)
    seed_obj = point_obj[nn]
    seed_local = point_local[nn]

    lmin_rows, has_rows = [], []
    scene_umax = np.float32(-np.inf)
    for o, ob in enumerate(objects):
        rows = ob["rows"]
        # row gather only; the canonical-view re-index happens in phase B
        lmin_rows.append(np.take(ob["lmin"], rows, axis=0))  # (k, V) object-frame views
        has_rows.append(np.take(ob["has"], rows, axis=0))
        sel = np.unique(seed_local[seed_obj == o])
        if len(sel):
            vm = ob["vmax"][rows[sel]][:, view_inds_per_obj[o]]
            scene_umax = max(scene_umax, vm.max())

    return IndexedSceneLabelContext(
        grasp_points=points_merged[nn].astype(np.float32),
        seed_obj=seed_obj.astype(np.int32),
        seed_local=seed_local.astype(np.int32),
        obj_view_rot=obj_view_rot,
        view_inds_per_obj=view_inds_per_obj,
        rows_per_obj=[np.asarray(ob["rows"], np.int64) for ob in objects],
        scores_full=[ob["scores"] for ob in objects],
        widths_full=[ob["widths"] for ob in objects],
        tol_full=[ob["tol"] for ob in objects],
        coll_full=[ob["coll"] for ob in objects],
        lmin_rows=lmin_rows,
        has_rows=has_rows,
        scene_umax=np.float32(scene_umax),
        ns=seed_xyz.shape[0],
    )


def _matched_indexed(
    ctx: IndexedSceneLabelContext, top_view: np.ndarray, cfg: GraspNetConfig
) -> Dict[str, np.ndarray]:
    """Matched half of the indexed path (`label_pipeline.py:552-589`):
    slabs gathered from the full arrays, scores and tolerances zeroed where
    the collision label is set (reference graspnet_dataset.py:227-232;
    widths are not zeroed, as in the reference)."""
    ns, a, d = ctx.ns, cfg.num_angle, cfg.num_depth
    top_view = np.asarray(top_view, np.int64)
    label = np.zeros((ns, a, d), np.float32)
    width = np.zeros((ns, a, d), np.float32)
    tol = np.zeros((ns, a, d), np.float32)
    for o in range(len(ctx.rows_per_obj)):
        sel = np.nonzero(ctx.seed_obj == o)[0]
        if len(sel) == 0:
            continue
        r = ctx.rows_per_obj[o][ctx.seed_local[sel]]
        ov = ctx.view_inds_per_obj[o][top_view[sel]]
        c = ctx.coll_full[o][r, ov]  # (nsel, A, D) bool
        label[sel] = np.where(c, 0.0, ctx.scores_full[o][r, ov])
        width[sel] = ctx.widths_full[o][r, ov]
        tol[sel] = np.where(c, 0.0, ctx.tol_full[o][r, ov])
    rot = ctx.obj_view_rot[ctx.seed_obj, top_view]
    return {
        "batch_grasp_view_rot": rot.astype(np.float32),
        "matched_label_raw": label,
        "batch_grasp_width": width,
        "batch_grasp_tolerance": tol,
    }
