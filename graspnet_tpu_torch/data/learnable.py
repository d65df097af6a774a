"""Physics-grounded learnable mini dataset (GraspNet-1B on-disk layout).

A copy of `graspnet_tpu/data/learnable.py` on the port's config, numpy
geometry (`models/geometry.py`) and evaluator (`eval/`); for one seed it
writes the same bytes.

Renders scenes of spheres into real depth/label PNGs + meta.mat and scores
every grasp-label candidate with the SAME gripper-volume + force-closure
physics the AP evaluator applies (`eval/ap.py` / `eval/force_closure.py`) —
mirroring how the real GraspNet-1Billion labels were produced (antipodal
force-closure analysis over dense candidate grids; the reference consumes
the resulting (points, offsets, scores) slabs in
dataset/graspnet_dataset.py:176-233).

Purpose: the end-to-end learnability gate (`graspnet_tpu_torch/scripts/learnability_gate.py`).
A model trained from scratch on these labels through the real
dataset/loader/trainer path, dumped through the real apps/test.py path and
scored by the in-house AP evaluator must beat an absolute AP bar that a
random-init model demonstrably fails — closing the train -> pred_decode ->
dump -> evaluator convention seam that no single-stage parity test covers
(reference train.py -> test.py:65-114 is the same quality loop).

Label semantics written here, matching the real dataset files:
  - ``grasp_label/{i:03d}_labels.npz``: points (Np,3) object frame;
    offsets (Np,V,A,D,3) = (in-plane angle grid, depth grid, width);
    scores (Np,V,A,D) = minimal force-closure friction mu in [0.2,1.2],
    0 where the candidate never closes (the loader's log(u_max/mu)
    rescale then maps lower mu -> higher training score).
  - ``tolerance/{i:03d}_tolerance.npy``: GRASP_MAX_TOLERANCE where
    feasible (decode rescales score by tolerance/0.05), else 0.
  - ``collision_label/<scene>/collision_labels.npz``: candidate collides
    with the composed scene (other objects) — the loader zeroes those.
  - ``models/{i:03d}/cloud.npz``: dense model cloud for the evaluator.

The V axis uses the SAME Fibonacci template views as the model
(models/geometry.py), so the label pipeline's pose-transform + kNN
re-index (train/label_pipeline.py::assign_views) is exercised unchanged.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.eval.force_closure import FRICTIONS
from graspnet_tpu_torch.models import geometry

# evaluator gripper constants (eval/ap.py — the geometry being learned)
DEPTH_BASE = 0.02
FINGER_WIDTH = 0.01
GRASP_HEIGHT = 0.02
EMPTY_THRESH = 10
TUBE_RADIUS = 0.005

H, W = 60, 80
FX = FY = 200.0
CX, CY = 40.0, 30.0
FACTOR_DEPTH = 1000.0
BG_DEPTH = 0.7
INTRINSIC = np.array(
    [[FX, 0.0, CX], [0.0, FY, CY], [0.0, 0.0, 1.0]], np.float64
)


def sphere_surface(n: int, radius: float) -> np.ndarray:
    """(n, 3) ~uniform points on a sphere surface (Fibonacci lattice)."""
    return geometry.generate_grasp_views_np(n) * np.float32(radius)


def box_surface(
    n: int, half: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """(n, 3) area-weighted uniform points on an axis-aligned box surface.

    Thin plates are the ANGLE-discriminating object family: force closure
    only succeeds with the closing axis through the two parallel thin
    faces, so the in-plane-angle convention chain (label grid ->
    angle_cls training -> decode -> evaluator rotation) must be
    end-to-end consistent for plate grasps to score — spheres alone
    forgive any angle.
    """
    hx, hy, hz = [float(h) for h in half]
    areas = np.array([hy * hz, hy * hz, hx * hz, hx * hz, hx * hy, hx * hy])
    face = rng.choice(6, n, p=areas / areas.sum())
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    pts = np.empty((n, 3), np.float32)
    for f in range(6):
        m = face == f
        axis, sign = f // 2, 1.0 if f % 2 == 0 else -1.0
        a, b = [i for i in range(3) if i != axis]
        pts[m, axis] = sign * (hx, hy, hz)[axis]
        pts[m, a] = u[m] * (hx, hy, hz)[a]
        pts[m, b] = v[m] * (hx, hy, hz)[b]
    return pts


def _ray_box_z(dirs: np.ndarray, center: np.ndarray, half: np.ndarray):
    """Per-pixel nearest-hit z for an axis-aligned box (slab method).

    Rays start at the origin with direction `dirs` (dir_z == 1, so the
    ray parameter IS the camera z).  Returns (H, W) z, +inf where missed.
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (center - half) / dirs
        t2 = (center + half) / dirs
    tmin = np.minimum(t1, t2).max(axis=-1)
    tmax = np.maximum(t1, t2).min(axis=-1)
    hit = (tmax >= tmin) & (tmin > 0)
    return np.where(hit, tmin, np.inf)


def render_sphere_scene(
    centers: np.ndarray,
    radius: float,
    seg_ids: Optional[np.ndarray] = None,
    radii: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast spheres into a (depth_m, seg) image pair.

    Pinhole rays through each pixel; per sphere the nearest quadratic root;
    per pixel the nearest sphere wins, else the background plane at
    BG_DEPTH.  Back-projecting the depth map with the same intrinsics
    (data/camera.py) reproduces the visible sphere surface exactly (up to
    the uint16-mm depth quantization the real dataset has too).

    `seg_ids` (default 1..n) lets distractor spheres render with seg id 0
    — real depth, background label, like unlabeled clutter in a real
    scene.  `radii` overrides the shared radius per sphere.
    """
    shapes = [
        ("sphere", c, radius if radii is None else float(radii[i]))
        for i, c in enumerate(centers)
    ]
    return render_scene(shapes, seg_ids=seg_ids)


def render_scene(
    shapes, seg_ids: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast a shape list: ("sphere", center, radius) or
    ("box", center, half_extents).  Nearest hit per pixel wins, else the
    BG_DEPTH plane; seg id 0 renders real depth with background label."""
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    dirs = np.stack(
        [(u - CX) / FX, (v - CY) / FY, np.ones_like(u, np.float64)], axis=-1
    )  # (H, W, 3)
    d2 = np.einsum("hwc,hwc->hw", dirs, dirs)
    depth = np.full((H, W), BG_DEPTH, np.float64)
    seg = np.zeros((H, W), np.uint8)
    if seg_ids is None:
        seg_ids = np.arange(1, len(shapes) + 1)
    for i, (kind, c, param) in enumerate(shapes):
        c = np.asarray(c, np.float64)
        if kind == "sphere":
            r = float(param)
            dc = dirs @ c  # (H, W)
            disc = dc * dc - d2 * (float(c @ c) - r * r)
            hit = disc > 0
            z = np.where(
                hit, (dc - np.sqrt(np.maximum(disc, 0.0))) / d2, np.inf
            )  # dir_z == 1: the ray parameter IS the camera z
        elif kind == "box":
            z = _ray_box_z(dirs, c, np.asarray(param, np.float64))
        else:
            raise ValueError(f"unknown shape kind {kind!r}")
        closer = (z > 0) & (z < depth)
        depth = np.where(closer, z, depth)
        seg = np.where(closer, np.uint8(seg_ids[i]), seg)
    return depth, seg


def _rot_grid(cfg: GraspNetConfig) -> np.ndarray:
    """(V, A, 3, 3) decode-convention rotations R(-view, angle) — exactly
    what pred_decode builds for (top view, argmax angle)."""
    views = geometry.generate_grasp_views_np(cfg.num_view)  # (V, 3)
    angles = (
        np.arange(cfg.num_angle, dtype=np.float32) / cfg.num_angle * np.pi
    )
    towards = np.repeat(-views, cfg.num_angle, axis=0)  # (V*A, 3)
    ang = np.tile(angles, cfg.num_view)
    rots = geometry.batch_viewpoint_params_to_matrix_np(towards, ang)
    return rots.reshape(cfg.num_view, cfg.num_angle, 3, 3)


def score_candidates(
    centers: np.ndarray,  # (C, 3) grasp translations, scene/camera frame
    rots: np.ndarray,  # (C, 3, 3)
    widths: np.ndarray,  # (C,) DECODED jaw widths
    depths: np.ndarray,  # (C,) finger depths
    own_pts: np.ndarray,  # (n, 3) this object's posed model cloud
    own_normals: np.ndarray,  # (n, 3)
    scene_pts: np.ndarray,  # (S, 3) composed scene (all posed objects)
    chunk: int = 4096,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized evaluator-physics sweep over candidate grasps.

    Returns:
      mu (C,): minimal force-closure friction from FRICTIONS against the
        OWN object (intrinsic label score), 0 when the candidate is empty
        / self-colliding / never closes — the GraspNet label convention.
      scene_collision (C,): gripper volume hits ANY scene point (incl.
        other objects) — the per-scene collision label.

    Same volumes as eval/ap.py::collision_and_empty and the same contact
    tube + cone test as force_closure.min_friction, vectorized over
    candidates (the per-grasp loop there is fine for 50 grasps/frame, not
    for the ~10^5 candidates of a label grid).
    """
    c_total = len(centers)
    mu_out = np.zeros(c_total, np.float32)
    coll_out = np.zeros(c_total, bool)
    cos_thresh = 1.0 / np.sqrt(1.0 + FRICTIONS.astype(np.float64) ** 2)

    def volumes(pts, p, r, w, d):
        # (c, S, 3) gripper-frame coordinates
        target = np.einsum("csj,cjk->csk", pts[None] - p[:, None], r)
        m1 = (np.abs(target[..., 2]) < GRASP_HEIGHT / 2)
        m2 = (target[..., 0] > -DEPTH_BASE) & (
            target[..., 0] < d[:, None]
        )
        half = w[:, None] / 2
        y = target[..., 1]
        inside_jaw = (y > -half) & (y < half)
        finger = (
            (np.abs(y) > half) & (np.abs(y) < half + FINGER_WIDTH)
        )
        bottom = (
            (target[..., 0] <= -DEPTH_BASE)
            & (target[..., 0] > -(DEPTH_BASE + FINGER_WIDTH))
            & (np.abs(y) < half + FINGER_WIDTH)
        )
        collision = np.any(m1 & ((m2 & finger) | bottom), axis=1)
        inner = m1 & m2 & inside_jaw
        return target, collision, inner

    for s0 in range(0, c_total, chunk):
        sl = slice(s0, min(s0 + chunk, c_total))
        p, r = centers[sl], rots[sl]
        w, d = widths[sl], depths[sl]
        c = len(p)

        # scene collision label (other objects included)
        _, coll_scene, _ = volumes(scene_pts, p, r, w, d)
        coll_out[sl] = coll_scene

        # intrinsic feasibility against the own object only
        target, coll_own, inner = volumes(own_pts, p, r, w, d)
        n_inner = inner.sum(axis=1)
        feas = (~coll_own) & (n_inner >= EMPTY_THRESH)
        if not np.any(feas):
            continue
        # dexnet grasp center = centroid of the between-jaw points
        # (gripper frame), mapped back to the scene frame
        wsum = np.where(inner[..., None], target, 0.0).sum(axis=1)
        centroid = wsum / np.maximum(n_inner, 1)[:, None]
        center_fc = p + np.einsum("cjk,ck->cj", r, centroid)
        axis = r[:, :, 1]  # closing direction

        rel = own_pts[None] - center_fc[:, None]  # (c, n, 3)
        s = np.einsum("cnj,cj->cn", rel, axis)
        radial2 = np.einsum("cnj,cnj->cn", rel, rel) - s * s
        half = (w / 2)[:, None]
        cand = (radial2 <= TUBE_RADIUS * TUBE_RADIUS) & (np.abs(s) <= half)
        has = cand.any(axis=1)
        s_lo = np.where(cand, s, np.inf)
        s_hi = np.where(cand, s, -np.inf)
        i_minus = np.argmin(s_lo, axis=1)
        i_plus = np.argmax(s_hi, axis=1)
        ok = feas & has & (i_minus != i_plus)
        if not np.any(ok):
            continue
        p1 = own_pts[i_minus]
        p2 = own_pts[i_plus]
        n1 = own_normals[i_minus]
        n2 = own_normals[i_plus]
        diff = p2 - p1
        norm = np.linalg.norm(diff, axis=1)
        nz = norm > 1e-9
        c1 = np.abs(np.einsum("cj,cj->c", n1, diff)) / np.maximum(
            norm * np.linalg.norm(n1, axis=1), 1e-12
        )
        c2 = np.abs(np.einsum("cj,cj->c", n2, diff)) / np.maximum(
            norm * np.linalg.norm(n2, axis=1), 1e-12
        )
        cmin = np.minimum(c1, c2)[:, None]  # (c, 1)
        passes = cmin >= cos_thresh[None, :]  # (c, n_frictions)
        any_pass = passes.any(axis=1)
        first = np.argmax(passes, axis=1)
        mu = np.where(ok & nz & any_pass, FRICTIONS[first], 0.0)
        mu_out[sl] = mu.astype(np.float32)
    return mu_out, coll_out


def _score_object(
    obj_i: int,
    centers: np.ndarray,
    label_pts: np.ndarray,
    model_clouds: List[np.ndarray],
    model_normals: List[np.ndarray],
    cfg: GraspNetConfig,
    width_label: float,
    extra_scene_pts: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(Np,V,A,D) intrinsic mu scores + scene-collision flags for object i.

    `model_clouds`/`model_normals` should be the 0.008-voxel clouds the
    evaluator itself scores against (eval/ap.py MODEL_VOXEL) so label
    feasibility and eval feasibility see the same surface sampling.
    `extra_scene_pts` adds unlabeled scene geometry (distractors) to the
    collision scene only.
    """
    np_l = len(label_pts)
    v, a, d = cfg.num_view, cfg.num_angle, cfg.num_depth
    rot_grid = _rot_grid(cfg)  # (V, A, 3, 3)
    depth_grid = (np.arange(d, dtype=np.float32) + 1.0) * cfg.depth_unit
    w_dec = np.float32(
        np.clip(cfg.width_scale * width_label, 0.0, cfg.grasp_max_width)
    )

    posed = [m + c for m, c in zip(model_clouds, centers)]
    if extra_scene_pts is not None:
        posed = posed + [extra_scene_pts]
    scene_pts = np.concatenate(posed, axis=0).astype(np.float32)
    own_pts = (model_clouds[obj_i] + centers[obj_i]).astype(np.float32)
    own_normals = model_normals[obj_i]

    cnt = np_l * v * a * d
    # candidate index layout: ((p * V + vi) * A + ai) * D + di
    ctr = np.repeat(
        label_pts + centers[obj_i], v * a * d, axis=0
    ).astype(np.float32)
    rots = np.tile(
        np.repeat(rot_grid.reshape(v * a, 3, 3), d, axis=0),
        (np_l, 1, 1),
    )
    widths = np.full(cnt, w_dec, np.float32)
    depths = np.tile(depth_grid, np_l * v * a)
    mu, coll = score_candidates(
        ctr, rots, widths, depths, own_pts, own_normals, scene_pts
    )
    return (
        mu.reshape(np_l, v, a, d),
        coll.reshape(np_l, v, a, d),
    )


def make_learnable_dataset(
    root: str,
    cfg: Optional[GraspNetConfig] = None,
    n_objects: int = 5,
    n_train_frames: int = 12,
    n_test_frames: int = 2,
    num_label_points: int = 48,
    model_points: int = 1200,
    radius: float = 0.015,
    width_label: float = 0.04,
    camera: str = "realsense",
    seed: int = 0,
    object_kinds: Optional[List[str]] = None,
) -> str:
    """Write the full on-disk layout under `root`; returns `root`.

    Scenes: scene_0000 (train split, jittered object centers per frame)
    and scene_0100 (test_seen split, nominal centers).

    `object_kinds`: per-object "sphere" | "plate" (default two spheres +
    one thin plate).  The plate is seen edge-on (thin axis = camera x);
    force closure only succeeds with the closing axis through its two
    parallel faces, so the in-plane ANGLE convention chain must be
    end-to-end consistent for plate grasps to score — the sphere family
    alone is angle-invariant.
    """
    import scipy.io as scio
    from PIL import Image

    from graspnet_tpu_torch.eval.ap import MODEL_VOXEL
    from graspnet_tpu_torch.eval.force_closure import estimate_normals
    from graspnet_tpu_torch.postproc.voxel import voxel_down_sample

    cfg = cfg or GraspNetConfig.tiny()
    rng = np.random.default_rng(seed)
    # sphere radius 0.015 gives a clean per-depth feasibility gradient
    # (mu* ~ 1.0 / 0.6 / 0.4 / 0.2 from the shallowest to the deepest
    # depth bin at a radial approach), so EVERY decode depth channel
    # receives score supervision — the loss only trains cells whose
    # best-angle label clears THRESH_BAD (reference loss.py:92-95), and
    # unsupervised channels would otherwise win pred_decode's argmax with
    # their init values
    # pentagon layout: the eval NMS (translation 0.03 m) collapses each
    # small object to ~1-3 grasp sites, so the AP ceiling scales with the
    # number of spatially separated objects — five sites keep the
    # accuracy-matrix denominators from diluting a healthy model's score
    ang = np.pi / 2 + 2 * np.pi * np.arange(5) / 5
    nominal = np.stack(
        [0.052 * np.cos(ang), 0.052 * np.sin(ang), np.full(5, 0.5)], axis=1
    ).astype(np.float32)[:n_objects]
    # unlabeled clutter inside the workspace AABB: renders with seg 0
    # (objectness negatives survive the workspace crop), enters the label
    # collision scene, but is NOT an evaluator model
    distractor_center = np.array([0.0, 0.0, 0.53], np.float32)
    distractor_radius = 0.012

    os.makedirs(os.path.join(root, "grasp_label"), exist_ok=True)
    os.makedirs(os.path.join(root, "tolerance"), exist_ok=True)

    kinds = (
        object_kinds
        or ["sphere", "plate", "sphere", "plate", "sphere"]
    )[:n_objects]
    kinds += ["sphere"] * (n_objects - len(kinds))
    # thin in x, but no thinner than ~3 voxels (MODEL_VOXEL 0.008): the
    # evaluator's k-NN PCA normals on the 8 mm-voxel model cloud mix BOTH
    # faces of anything thinner and the cone test sees garbage normals —
    # found live when 12 mm plate grasps with correctly aligned closing
    # axes still failed closure
    plate_half = np.array([0.012, 0.028, 0.025], np.float32)

    model_clouds = []  # dense, written to models/ for the evaluator
    score_clouds = []  # MODEL_VOXEL-downsampled, the evaluator's view
    score_normals = []
    label_pts_all = []
    for i in range(n_objects):
        if kinds[i] == "plate":
            cloud = box_surface(model_points, plate_half, rng)
            pts = box_surface(num_label_points, plate_half, rng)
        else:
            cloud = sphere_surface(model_points, radius)
            pts = sphere_surface(num_label_points, radius)
        model_clouds.append(cloud)
        vox = voxel_down_sample(cloud, MODEL_VOXEL)
        score_clouds.append(vox)
        score_normals.append(estimate_normals(vox))
        if kinds[i] == "sphere":
            # label points are a coarser lattice, rotated per object so the
            # label grids of different objects are not identical (plates
            # keep their axis alignment — rotating one would rotate its
            # graspable thin axis out of the rendered pose)
            theta = rng.uniform(0, 2 * np.pi)
            cz, sz = np.cos(theta), np.sin(theta)
            rz = np.array(
                [[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32
            )
            pts = pts @ rz.T
        label_pts_all.append(pts)
        mdir = os.path.join(root, "models", f"{i:03d}")
        os.makedirs(mdir, exist_ok=True)
        np.savez(os.path.join(mdir, "cloud.npz"), points=cloud)

    v, a, d = cfg.num_view, cfg.num_angle, cfg.num_depth
    angles = (
        np.arange(a, dtype=np.float32) / a * np.pi
    )
    depth_grid = (np.arange(d, dtype=np.float32) + 1.0) * cfg.depth_unit
    distractor_pts = (
        sphere_surface(200, distractor_radius) + distractor_center
    )
    coll_by_obj = {}
    for i in range(n_objects):
        mu, coll = _score_object(
            i, nominal, label_pts_all[i], score_clouds, score_normals,
            cfg, width_label, extra_scene_pts=distractor_pts,
        )
        np_l = len(label_pts_all[i])
        offsets = np.zeros((np_l, v, a, d, 3), np.float32)
        offsets[..., 0] = angles[None, None, :, None]
        offsets[..., 1] = depth_grid[None, None, None, :]
        offsets[..., 2] = width_label
        np.savez(
            os.path.join(root, "grasp_label", f"{i:03d}_labels.npz"),
            points=label_pts_all[i].astype(np.float32),
            offsets=offsets,
            scores=mu.astype(np.float32),
        )
        np.save(
            os.path.join(root, "tolerance", f"{i:03d}_tolerance.npy"),
            (cfg.grasp_max_tolerance * (mu > 0)).astype(np.float32),
        )
        coll_by_obj[i] = coll

    def write_scene(scene: str, n_frames: int, jitter: float):
        base = os.path.join(root, "scenes", scene, camera)
        for sub in ("depth", "label", "meta"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        frng = np.random.default_rng(seed + int(scene.split("_")[1]))
        for f in range(n_frames):
            centers = nominal + frng.uniform(
                -jitter, jitter, nominal.shape
            ).astype(np.float32)
            shapes = [
                ("box", centers[i], plate_half)
                if kinds[i] == "plate"
                else ("sphere", centers[i], radius)
                for i in range(n_objects)
            ] + [("sphere", distractor_center, distractor_radius)]
            depth_m, seg = render_scene(
                shapes,
                seg_ids=np.concatenate(
                    [np.arange(1, n_objects + 1), [0]]
                ),
            )
            depth_u16 = np.round(depth_m * FACTOR_DEPTH).astype(np.uint16)
            Image.fromarray(depth_u16).save(
                os.path.join(base, "depth", f"{f:04d}.png")
            )
            Image.fromarray(seg).save(
                os.path.join(base, "label", f"{f:04d}.png")
            )
            poses = np.zeros((3, 4, n_objects), np.float64)
            for i in range(n_objects):
                poses[:, :3, i] = np.eye(3)
                poses[:, 3, i] = centers[i]
            scio.savemat(
                os.path.join(base, "meta", f"{f:04d}.mat"),
                {
                    "intrinsic_matrix": INTRINSIC,
                    "factor_depth": np.array([[FACTOR_DEPTH]]),
                    "cls_indexes": np.array(
                        [np.arange(1, n_objects + 1)], np.int32
                    ),
                    "poses": poses,
                },
            )
        eye = np.tile(np.eye(4, dtype=np.float64), (256, 1, 1))
        np.save(os.path.join(base, "camera_poses.npy"), eye)
        np.save(os.path.join(base, "cam0_wrt_table.npy"), np.eye(4))
        cdir = os.path.join(root, "collision_label", scene)
        os.makedirs(cdir, exist_ok=True)
        np.savez(
            os.path.join(cdir, "collision_labels.npz"),
            **{f"arr_{i}": coll_by_obj[i] for i in range(n_objects)},
        )

    # train frames jitter the sphere centers (each frame a distinct
    # arrangement, poses updated in meta) so the model generalizes over
    # placement instead of memorizing 4 static point patterns — the test
    # scene's nominal centers then sit INSIDE the training manifold.
    # Round-5 gate finding: with 4 static train frames the tiny model
    # overfits to exact point positions and eval-mode margins invert
    # (-8) on the un-jittered test frames.
    write_scene("scene_0000", n_train_frames, jitter=0.008)
    write_scene("scene_0100", n_test_frames, jitter=0.0)
    return root
