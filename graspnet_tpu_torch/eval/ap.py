"""GraspNet AP evaluation over dumped per-frame grasp arrays.

A copy of `graspnet_tpu/eval/ap.py` (numpy and the host library) on the
port's `native`, `data.dataset.SPLITS`, `postproc.voxel` and
`postproc.nms.grasp_nms`; its process-pool workers never touch the card.

Faithful re-derivation of the published GraspNet-1Billion protocol — the
surface the reference consumes via graspnetAPI.GraspNetEval
(reference test.py:110-114).  Per frame (graspnetAPI eval_grasp /
GraspNetEval.eval_scene):

  1. grasp NMS, translation 0.03 m / rotation 30 deg;
  2. assign each grasp to the object whose composed model cloud contains
     the scene point nearest to the grasp center;
  3. keep the top 10 grasps per object (by dump confidence), then apply the
     global top-50 cut as a minimum-score threshold (the 50th best score
     over the kept grasps);
  4. binary gripper-volume collision check against the composed scene
     (all posed models + the table slab): any point inside the left/right
     finger or bottom volume -> collision, score -1; fewer than 10 scene
     points between the jaws -> 'empty' grasp, score -1;
  5. surviving grasps are scored in the OBJECT frame by the dexnet-style
     force-closure metric (eval/force_closure.py): score = minimal passing
     friction mu*, or -1;
  6. accuracy matrix acc[k, f] = #(0 < score <= mu_f among the k+1 highest-
     confidence grasps) / (k+1) for k = 0..49 and the 6 friction levels —
     when fewer than k+1 grasps exist the full list is used with the same
     k+1 denominator (missing grasps count against precision).

AP = mean over everything; AP0.8 / AP0.4 are the friction-0.8 / 0.4 column
means (the README table layout, reference README.md:94-109).

Object models load from root/models/{id:03d}/ as nontextured.ply or
cloud.npz, voxel-sampled at 0.008; normals are PCA-estimated once per
object and cached.  The table slab (1 m x 1 m x 0.05 m grid at 0.008,
below z=0 in the table frame) enters the collision scene when the scene
directory provides camera_poses.npy + cam0_wrt_table.npy.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

from typing import Dict, List, Optional, Tuple

import numpy as np

from graspnet_tpu_torch import native
from graspnet_tpu_torch.data.dataset import SPLITS
from graspnet_tpu_torch.eval.force_closure import FRICTIONS, estimate_normals, min_friction
from graspnet_tpu_torch.postproc.nms import grasp_nms
from graspnet_tpu_torch.postproc.voxel import voxel_down_sample

TOP_K = 50
PER_OBJECT_TOP = 10  # graspnetAPI eval_grasp keeps 10 per object pre-cut
EMPTY_THRESH = 10  # min scene points between the jaws
DEPTH_BASE = 0.02  # gripper base extends this far behind the origin
FINGER_WIDTH = 0.01
MODEL_VOXEL = 0.008
NMS_TRANSLATION = 0.03
NMS_ROTATION = 30.0 / 180.0 * np.pi


# --------------------------------------------------------------- models ----


def load_ply_points(path: str) -> np.ndarray:
    """Minimal PLY vertex reader (ascii + binary_little_endian)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vertex = int(next(l.split()[-1] for l in header if l.startswith("element vertex")))
        props = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                in_vertex = l.startswith("element vertex")
            elif l.startswith("property") and in_vertex:
                props.append(tuple(l.split()[1:3]))  # (type, name)
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=n_vertex, dtype=np.float64)
            names = [name for _, name in props]
            ix = [names.index(c) for c in ("x", "y", "z")]
            return rows[:, ix].astype(np.float32)
        np_types = {
            "float": "<f4", "float32": "<f4", "double": "<f8",
            "uchar": "u1", "uint8": "u1", "int": "<i4",
            "int32": "<i4", "uint": "<u4", "ushort": "<u2", "short": "<i2",
        }
        dt = np.dtype([(name, np_types[t]) for t, name in props])
        arr = np.frombuffer(f.read(n_vertex * dt.itemsize), dtype=dt, count=n_vertex)
        return np.stack(
            [arr["x"], arr["y"], arr["z"]], axis=1
        ).astype(np.float32)


def load_model_cloud(root: str, obj_id: int, voxel_size: float = MODEL_VOXEL) -> np.ndarray:
    """Load + downsample an object model cloud."""
    base = os.path.join(root, "models", f"{obj_id:03d}")
    npz = os.path.join(base, "cloud.npz")
    if os.path.exists(npz):
        pts = np.load(npz)["points"].astype(np.float32)
    else:
        ply = os.path.join(base, "nontextured.ply")
        pts = load_ply_points(ply)
    return voxel_down_sample(pts, voxel_size)


def create_table_points(
    lx: float = 1.0,
    ly: float = 1.0,
    lz: float = 0.05,
    dx: float = -0.5,
    dy: float = -0.5,
    dz: float = -0.05,
    grid_size: float = MODEL_VOXEL,
) -> np.ndarray:
    """Table slab grid in the table frame (graspnetAPI create_table_points)."""
    xs = np.arange(0, lx, grid_size) + dx
    ys = np.arange(0, ly, grid_size) + dy
    zs = np.arange(0, lz, grid_size) + dz
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)


# ------------------------------------------------------------- protocol ----


class _SceneGrid:
    """Uniform-grid index over a point set for exact pruned volume checks.

    Same design as the native gn_visible / gn_fps_grid kernels in the data
    pipeline: the grid only PRUNES (cell-level bounding-sphere coverage);
    every surviving candidate goes through the unchanged per-point mask
    math, and candidates are returned in ascending original index order so
    masked reductions (any/sum/mean) see exactly the arrays the unpruned
    code saw — results are bit-identical by construction.
    """

    def __init__(self, points: np.ndarray, cell: float = 0.08):
        self.points = points
        self.cell = float(cell)
        self.n = len(points)
        if self.n == 0:
            return
        built = native.grid_build(points, self.cell)
        if built is not None:
            # two O(N) C++ passes; same float64 quantization + packing as
            # the numpy construction below (byte-parity test in
            # tests/test_native.py), ~6x at eval scene sizes
            self.order, self.uniq, st, self.minb, self.dims = built
            self.starts = st[:-1]
            self.ends = st[1:]
            return
        p64 = points.astype(np.float64)
        self.minb = p64.min(axis=0)
        coords = np.floor((p64 - self.minb) / self.cell).astype(np.int64)
        self.dims = coords.max(axis=0) + 1
        keys = (
            coords[:, 0] * self.dims[1] + coords[:, 1]
        ) * self.dims[2] + coords[:, 2]
        self.order = np.argsort(keys, kind="stable")
        sk = keys[self.order]
        self.uniq, self.starts = np.unique(sk, return_index=True)
        self.ends = np.append(self.starts[1:], self.n)

    def ball_candidates(self, center: np.ndarray, radius: float) -> np.ndarray:
        """Indices of every point possibly within `radius` of `center`
        (cell-cover superset), ascending."""
        if self.n == 0:
            return np.empty(0, np.int64)
        c = np.asarray(center, np.float64)
        lo = np.floor((c - radius - self.minb) / self.cell).astype(np.int64)
        hi = np.floor((c + radius - self.minb) / self.cell).astype(np.int64)
        lo = np.clip(lo, 0, self.dims - 1)
        hi = np.clip(hi, 0, self.dims - 1)
        xs = np.arange(lo[0], hi[0] + 1)
        ys = np.arange(lo[1], hi[1] + 1)
        zs = np.arange(lo[2], hi[2] + 1)
        keys = (
            (xs[:, None, None] * self.dims[1] + ys[None, :, None])
            * self.dims[2]
            + zs[None, None, :]
        ).ravel()
        pos = np.searchsorted(self.uniq, keys)
        in_range = pos < len(self.uniq)
        # exact positional match only: an absent key must not alias to a
        # present neighbour (that would duplicate a cell's points and
        # corrupt the inner-point counts/centroids)
        pos = pos[in_range][self.uniq[pos[in_range]] == keys[in_range]]
        if len(pos) == 0:
            return np.empty(0, np.int64)
        idx = np.concatenate(
            [self.order[self.starts[p] : self.ends[p]] for p in pos]
        )
        idx.sort()
        return idx


def _gripper_bound_radius(width: float, height: float, depth: float) -> float:
    """Bounding-sphere radius (gripper frame, centered at the grasp
    translation) of every volume collision_and_empty tests.  The gripper
    frame is an isometry of the camera frame, so |target| == |p - t| up to
    the f32 rotation's ~1e-6 non-orthonormality — the 1e-3 m margin
    dwarfs it."""
    x = max(DEPTH_BASE + FINGER_WIDTH, abs(float(depth)))
    y = abs(float(width)) / 2 + FINGER_WIDTH
    z = abs(float(height)) / 2
    return float(np.sqrt(x * x + y * y + z * z)) + 1e-3


def collision_and_empty(
    grasps: np.ndarray,
    scene_points: np.ndarray,
    grid: Optional[_SceneGrid] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary gripper-volume collision + empty-jaw check per grasp.

    Transcription of graspnetAPI eval_utils.collision_detection: in the
    gripper frame the fingers span x in (-DEPTH_BASE, depth), the jaw gap
    is width, fingers are FINGER_WIDTH thick, the slab |z| < height/2;
    the bottom plate sits behind x = -DEPTH_BASE.  A grasp collides when
    ANY scene point falls inside a finger/bottom volume (binary — unlike
    the IoU-scored ModelFreeCollisionDetector used at dump time).

    Returns (collision (M,), empty (M,), inner_centroid (M, 3)); the
    centroid of the between-jaws points (gripper frame) seeds the dexnet
    grasp center for scoring, as graspnetAPI does.

    `grid`: optional _SceneGrid built over THESE scene_points — prunes each
    grasp's sweep to the points near its gripper volume (bit-identical
    results; ~10x on full-scene+table point sets).
    """
    m = len(grasps)
    collision = np.zeros(m, dtype=bool)
    empty = np.zeros(m, dtype=bool)
    centroid = np.zeros((m, 3), dtype=np.float32)
    for gi in range(m):
        g = grasps[gi]
        width, height, depth = g[1], g[2], g[3]
        rot = g[4:13].reshape(3, 3)
        t = g[13:16]
        pts = scene_points
        if grid is not None:
            cand = grid.ball_candidates(
                t, _gripper_bound_radius(width, height, depth)
            )
            pts = scene_points[cand]
        target = (pts - t) @ rot  # gripper frame
        mask1 = (target[:, 2] > -height / 2) & (target[:, 2] < height / 2)
        mask2 = (target[:, 0] > -DEPTH_BASE) & (target[:, 0] < depth)
        mask3 = target[:, 1] > -(width / 2 + FINGER_WIDTH)
        mask4 = target[:, 1] < -width / 2
        mask5 = target[:, 1] < (width / 2 + FINGER_WIDTH)
        mask6 = target[:, 1] > width / 2
        mask7 = (target[:, 0] <= -DEPTH_BASE) & (
            target[:, 0] > -(DEPTH_BASE + FINGER_WIDTH)
        )
        left = mask1 & mask2 & mask3 & mask4
        right = mask1 & mask2 & mask5 & mask6
        bottom = mask1 & mask3 & mask5 & mask7
        inner = mask1 & mask2 & ~mask4 & ~mask6
        collision[gi] = bool(np.any(left | right | bottom))
        n_inner = int(np.sum(inner))
        empty[gi] = n_inner < EMPTY_THRESH
        if n_inner:
            centroid[gi] = target[inner].mean(axis=0)
    return collision, empty, centroid


def accuracy_matrix(
    score_list: np.ndarray, frictions: np.ndarray = FRICTIONS, top_k: int = TOP_K
) -> np.ndarray:
    """acc[k, f] = #(0 < score <= mu_f in the first k+1) / (k+1).

    score_list must already be sorted by dump confidence descending; when
    it is shorter than k+1 the whole list is used with the k+1 denominator
    (graspnetAPI GraspNetEval.eval_scene's exact branch).
    """
    acc = np.zeros((top_k, len(frictions)), dtype=np.float32)
    n = len(score_list)
    for fi, fric in enumerate(frictions):
        hit = (score_list <= fric) & (score_list > 0)
        cum = np.cumsum(hit.astype(np.int64))
        for k in range(top_k):
            acc[k, fi] = (cum[-1] if k + 1 > n else cum[k]) / (k + 1) if n else 0.0
    return acc


def eval_frame(
    grasps: np.ndarray,
    model_clouds: List[np.ndarray],
    model_normals: List[np.ndarray],
    poses: List[np.ndarray],
    table: Optional[np.ndarray] = None,
    apply_nms: bool = True,
) -> np.ndarray:
    """(TOP_K, len(FRICTIONS)) accuracy matrix for one frame.

    grasps: (M, 17) dumped array (camera frame); poses: per-object (3, 4)
    model->camera transforms; table: optional (T, 3) table points already
    in the camera frame.
    """
    zeros = np.zeros((TOP_K, len(FRICTIONS)), dtype=np.float32)
    if len(grasps) == 0 or len(model_clouds) == 0:
        return zeros
    if apply_nms:
        grasps = grasps[
            grasp_nms(grasps, NMS_TRANSLATION, NMS_ROTATION)
        ]  # returns desc-score order

    # ---- stage 2: assign each grasp to the object owning the nearest
    # scene point (graspnetAPI: compute_closest_points vs the seg-masked
    # composed scene) ----
    posed = [pts @ p[:3, :3].T + p[:3, 3] for pts, p in zip(model_clouds, poses)]
    seg = np.concatenate(
        [np.full(len(p), i, dtype=np.int32) for i, p in enumerate(posed)]
    )
    scene = np.concatenate(posed, axis=0)
    centers = grasps[:, 13:16]
    # first-occurrence argmin over squared distances (native.nearest, C++
    # with numpy fallback) — same selection as the former blocked-norm
    # sweep up to sqrt rounding collapsing ~1e-7-relative near-ties, and
    # ~100x less host time on full composed scenes.  native.nearest casts
    # to float32 internally; convert here explicitly so the documented
    # ~1e-7 tolerance is stated at float32 — a float64 caller would
    # otherwise be silently downcast with a larger selection delta.
    nearest = native.nearest(
        np.ascontiguousarray(centers, np.float32),
        np.ascontiguousarray(scene, np.float32),
    ).astype(np.int64)
    model_to_grasp = seg[nearest]

    # ---- stage 3: top-10 per object, then global top-50 min-score cut ----
    pre_per_obj: List[np.ndarray] = []
    for oi in range(len(posed)):
        gi = grasps[model_to_grasp == oi]
        gi = gi[np.argsort(-gi[:, 0], kind="stable")][:PER_OBJECT_TOP]
        pre_per_obj.append(gi)
    all_kept = np.concatenate(pre_per_obj, axis=0)
    if len(all_kept) == 0:
        return zeros
    order = np.argsort(-all_kept[:, 0], kind="stable")
    min_score = all_kept[order[min(TOP_K - 1, len(order) - 1)], 0]
    kept_per_obj = [g[g[:, 0] >= min_score] for g in pre_per_obj]

    # ---- stages 4+5: collision/empty then force-closure scoring ----
    coll_scene = scene if table is None else np.concatenate([scene, table], axis=0)
    coll_grid = _SceneGrid(coll_scene)
    rows, scores = [], []
    for oi, g in enumerate(kept_per_obj):
        if len(g) == 0:
            continue
        coll, empty, inner_c = collision_and_empty(g, coll_scene, grid=coll_grid)
        p_rot, p_t = poses[oi][:3, :3], poses[oi][:3, 3]
        for gi in range(len(g)):
            rows.append(g[gi])
            if coll[gi] or empty[gi]:
                scores.append(-1.0)
                continue
            rot = g[gi, 4:13].reshape(3, 3)
            # dexnet grasp in the OBJECT frame: center = inner-point
            # centroid, closing axis = gripper y column
            center_cam = g[gi, 13:16] + rot @ inner_c[gi]
            center_obj = (center_cam - p_t) @ p_rot
            axis_obj = p_rot.T @ rot[:, 1]
            scores.append(
                min_friction(
                    model_clouds[oi], model_normals[oi],
                    center_obj.astype(np.float32), axis_obj.astype(np.float32),
                    float(g[gi, 1]),
                )
            )
    if not rows:
        return zeros
    rows = np.stack(rows)
    scores = np.asarray(scores, dtype=np.float32)

    # ---- stage 6: sort by dump confidence, accuracy matrix ----
    order = np.argsort(-rows[:, 0], kind="stable")
    return accuracy_matrix(scores[order])


def summarize(res: np.ndarray) -> Dict[str, float]:
    """AP / AP0.8 / AP0.4 from stacked (..., TOP_K, 6) accuracy matrices."""
    if res.size == 0:
        return {"AP": 0.0, "AP0.8": 0.0, "AP0.4": 0.0}
    f08 = int(np.argmin(np.abs(FRICTIONS - 0.8)))
    f04 = int(np.argmin(np.abs(FRICTIONS - 0.4)))
    return {
        "AP": float(res.mean()) * 100.0,
        "AP0.8": float(res[..., f08].mean()) * 100.0,
        "AP0.4": float(res[..., f04].mean()) * 100.0,
    }


def _eval_worker_init():
    """Hide the card from spawned eval workers before anything could
    initialise CUDA (torch does so lazily, at the first CUDA call): the
    evaluator is host code, and a worker that touched the card would hold a
    context on the parent's device.  Unconditional, not setdefault."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


class GraspNetEval:
    """Evaluate a dump directory over a split (graspnetAPI surface)."""

    def __init__(self, root: str, camera: str = "kinect", split: str = "test_seen"):
        self.root = root
        self.camera = camera
        self.split = split
        self.scene_ids = [f"scene_{i:04d}" for i in SPLITS[split]]
        self._model_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _model(self, obj_id: int) -> Tuple[np.ndarray, np.ndarray]:
        if obj_id not in self._model_cache:
            pts = load_model_cloud(self.root, obj_id)
            self._model_cache[obj_id] = (pts, estimate_normals(pts))
        return self._model_cache[obj_id]

    def _tables(self, base: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(camera_poses (F,4,4), cam0_wrt_table (4,4)) when available."""
        cp = os.path.join(base, "camera_poses.npy")
        al = os.path.join(base, "cam0_wrt_table.npy")
        if os.path.exists(cp) and os.path.exists(al):
            return np.load(cp), np.load(al)
        return None

    def eval_scene(self, scene: str, dump_dir: str) -> np.ndarray:
        """(frames, TOP_K, 6) accuracy matrices for one scene."""
        import scipy.io as scio

        base = os.path.join(self.root, "scenes", scene, self.camera)
        frame_files = sorted(os.listdir(os.path.join(dump_dir, scene, self.camera)))
        table_base = create_table_points()
        pose_info = self._tables(base)
        out = []
        for ff in frame_files:
            frame = int(os.path.splitext(ff)[0])
            grasps = np.load(os.path.join(dump_dir, scene, self.camera, ff))
            meta = scio.loadmat(os.path.join(base, "meta", f"{frame:04d}.mat"))
            obj_idxs = meta["cls_indexes"].flatten().astype(np.int32)
            poses = [meta["poses"][:, :, i] for i in range(len(obj_idxs))]
            clouds, normals = [], []
            for o in obj_idxs:
                pts, nrm = self._model(int(o) - 1)  # label ids are 1-based
                clouds.append(pts)
                normals.append(nrm)
            table = None
            if pose_info is not None:
                cam_poses, align = pose_info
                t_cam = np.linalg.inv(align @ cam_poses[frame])
                table = table_base @ t_cam[:3, :3].T + t_cam[:3, 3]
            out.append(eval_frame(grasps, clouds, normals, poses, table=table))
        return (
            np.stack(out)
            if out
            else np.zeros((0, TOP_K, len(FRICTIONS)), np.float32)
        )

    def eval_all(self, dump_dir: str, proc: int = 8):
        """Returns (res (scenes, frames, TOP_K, 6), AP in [0, 1])."""
        scenes = [
            s
            for s in self.scene_ids
            if os.path.isdir(os.path.join(dump_dir, s, self.camera))
        ]
        self.evaluated_scenes = scenes  # row order of the returned res
        if proc <= 1 or len(scenes) <= 1:
            results = [self.eval_scene(s, dump_dir) for s in scenes]
        else:
            # spawn (never fork): the caller typically just ran inference, so
            # the parent holds a CUDA context and threads, which a forked
            # child cannot use safely.  Fresh spawned workers hide the card
            # before anything in them could initialise CUDA.
            import multiprocessing as mp

            ctx = mp.get_context("spawn")
            with cf.ProcessPoolExecutor(
                min(proc, len(scenes)),
                mp_context=ctx,
                initializer=_eval_worker_init,
            ) as pool:
                results = list(
                    pool.map(self.eval_scene, scenes, [dump_dir] * len(scenes))
                )
        res = (
            np.stack(results)
            if results
            else np.zeros((0, 0, TOP_K, len(FRICTIONS)))
        )
        ap = float(res.mean()) if res.size else 0.0
        return res, ap
