"""GraspNet-1Billion dataset: scene loading, augmentation, padded batching.

A copy of `graspnet_tpu/data/dataset.py` on the port's label pipeline and
host library (numpy only; `scipy.io` and PIL are imported where a frame is
read from disk).  Equivalent surface to reference
dataset/graspnet_dataset.py with one redesign: instead of the ragged
`*_list` collation (graspnet_dataset.py:264-272 — python lists of
per-object tensors that force per-scene device loops), every sample is
reduced on the host to fixed-shape padded arrays
(`train/label_pipeline.py::build_scene_labels`) or, in the compact label
mode, to an indexed label context, so batches stack into one dict of
arrays for `Trainer.put` / `Trainer.prepare`.

Scene layout on disk (same as the reference dataset):
  root/scenes/scene_XXXX/{camera}/rgb|depth|label/NNNN.png, meta/NNNN.mat,
  camera_poses.npy, cam0_wrt_table.npy
  root/collision_label/scene_XXXX/collision_labels.npz
  root/grasp_label/XXX_labels.npz    (points, offsets, scores)
  tolerance/XXX_tolerance.npy
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from graspnet_tpu_torch import native
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.data.camera import (
    CameraInfo,
    create_point_cloud_from_depth_image,
    get_workspace_mask,
    remove_invisible_grasp_points,
    transform_point_cloud_np,
)
from graspnet_tpu_torch.train import label_pipeline as lp

SPLITS = {
    "train": range(0, 100),
    "test": range(100, 190),
    "test_seen": range(100, 130),
    "test_similar": range(130, 160),
    "test_novel": range(160, 190),
}
FRAMES_PER_SCENE = 256
SKIPPED_OBJECT = 18  # reference graspnet_dataset.py:255-256


def load_grasp_labels(root: str, num_objects: int = 88) -> Tuple[List[int], Dict[int, tuple]]:
    """Load per-object grasp labels; object 18 is skipped (reference :250-262).

    Returns (valid_obj_idxs [1-based, aligned with label PNG ids], labels dict
    keyed by 1-based id -> (points, offsets, scores, tolerance)).
    """
    valid, labels = [], {}
    for i in range(num_objects):
        if i == SKIPPED_OBJECT:
            continue
        label = np.load(os.path.join(root, "grasp_label", f"{i:03d}_labels.npz"))
        tol_path = os.path.join(root, "tolerance", f"{i:03d}_tolerance.npy")
        if not os.path.exists(tol_path):
            # fail fast with the remedy — a None here would surface much
            # later as a TypeError deep inside get_data_label
            raise FileNotFoundError(
                f"missing tolerance labels for object {i:03d}: {tol_path}. "
                "Generate them first with the JAX package's generator: python -m "
                f"graspnet_tpu.apps.generate_tolerance --dataset_root {root}"
            )
        tolerance = np.load(tol_path)
        valid.append(i + 1)
        labels[i + 1] = (
            label["points"].astype(np.float32),
            label["offsets"].astype(np.float32),
            label["scores"].astype(np.float32),
            tolerance,
        )
    return valid, labels


def augment_flip_rotate(
    cloud: np.ndarray, poses: List[np.ndarray], rng: np.random.Generator
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Random YZ flip + uniform ±30° rotation about camera X
    (reference graspnet_dataset.py:76-96)."""
    if rng.random() > 0.5:
        flip = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
        cloud = transform_point_cloud_np(cloud, flip)
        poses = [(flip @ p).astype(np.float32) for p in poses]
    ang = rng.random() * np.pi / 3 - np.pi / 6
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)
    cloud = transform_point_cloud_np(cloud, rot)
    poses = [(rot @ p).astype(np.float32) for p in poses]
    return cloud, poses


class GraspNetDataset:
    """Frame-level dataset over GraspNet-1B scenes."""

    def __init__(
        self,
        root: str,
        valid_obj_idxs: Optional[List[int]] = None,
        grasp_labels: Optional[Dict[int, tuple]] = None,
        camera: str = "kinect",
        split: str = "train",
        num_points: int = 20000,
        remove_outlier: bool = False,
        remove_invisible: bool = True,
        augment: bool = False,
        load_label: bool = True,
        cfg: GraspNetConfig = GraspNetConfig(),
        max_objects: int = 16,
        seed: int = 0,
        label_mode: str = "compact",
    ):
        assert num_points <= 50000
        assert label_mode in ("full", "compact")
        self.label_mode = label_mode
        self.root = root
        self.camera = camera
        self.num_points = num_points
        self.remove_outlier = remove_outlier
        self.remove_invisible = remove_invisible
        self.augment = augment
        self.load_label = load_label
        self.valid_obj_idxs = valid_obj_idxs or []
        self.grasp_labels = grasp_labels or {}
        self.cfg = cfg
        self.max_objects = max_objects
        self.seed = seed
        self.epoch = 0

        # per-(scene, annotation) collision-zeroed label-view stats, shared
        # across frames AND epochs (they depend only on the object's full
        # label slabs + the scene's collision labels) — the compact path
        # gathers subsampled rows out of these instead of re-reducing
        # ~35 MB/object of score/width slabs every frame
        import threading

        self._stat_cache: Dict[Tuple[str, int], tuple] = {}
        self._stat_lock = threading.Lock()
        self._stat_bytes = 0
        self._stat_budget = (
            int(os.environ.get("GRASPNET_STAT_CACHE_MB", "4096")) * 1024 * 1024
        )

        # decoded-frame LRU: apps/test.py reads every eval frame TWICE —
        # get_data() for the sampled net input, then get_raw_cloud() for
        # the full-resolution collision filter — and each _load_frame is
        # ~100 ms of PNG decode + backprojection on a 2-core host.
        # Callers only fancy-index the returned arrays (never mutate), so
        # sharing entries across threads is safe.  ~10 MB/frame.
        from collections import OrderedDict

        self._frame_cache: "OrderedDict[Tuple[str, int], tuple]" = OrderedDict()
        self._frame_lock = threading.Lock()
        self._frame_cache_cap = int(os.environ.get("GRASPNET_FRAME_CACHE", "32"))

        self.scene_ids = [f"scene_{i:04d}" for i in SPLITS[split]]
        self.frames: List[Tuple[str, int]] = []
        self.collision_labels: Dict[str, Dict[int, np.ndarray]] = {}
        for scene in self.scene_ids:
            scene_dir = os.path.join(root, "scenes", scene, camera)
            if not os.path.isdir(scene_dir):
                continue  # tolerate partial local copies of the dataset
            depth_dir = os.path.join(scene_dir, "depth")
            n_frames = (
                len(os.listdir(depth_dir))
                if os.path.isdir(depth_dir)
                else FRAMES_PER_SCENE
            )
            for f in range(n_frames):
                self.frames.append((scene, f))
            if load_label:
                coll = np.load(
                    os.path.join(root, "collision_label", scene, "collision_labels.npz")
                )
                self.collision_labels[scene] = {
                    i: coll[f"arr_{i}"] for i in range(len(coll))
                }

    def __len__(self):
        return len(self.frames)

    def scene_list(self):
        return [s for s, _ in self.frames]

    # ------------------------------------------------------------ loading --
    def _load_frame(self, scene: str, frame: int):
        key = (scene, frame)
        with self._frame_lock:
            hit = self._frame_cache.get(key)
            if hit is not None:
                self._frame_cache.move_to_end(key)
                return hit
        out = self._load_frame_uncached(scene, frame)
        # cached arrays are shared across threads and returned aliased
        # (get_raw_cloud / get_data fancy-index, never mutate); freeze them
        # so an accidental in-place write raises instead of silently
        # corrupting every concurrent reader of this frame
        for x in out:
            if isinstance(x, np.ndarray):
                x.flags.writeable = False
        with self._frame_lock:
            self._frame_cache[key] = out
            self._frame_cache.move_to_end(key)
            while len(self._frame_cache) > self._frame_cache_cap:
                self._frame_cache.popitem(last=False)
        return out

    def _load_frame_uncached(self, scene: str, frame: int):
        import scipy.io as scio
        from PIL import Image

        base = os.path.join(self.root, "scenes", scene, self.camera)
        depth = np.array(Image.open(os.path.join(base, "depth", f"{frame:04d}.png")))
        seg = np.array(Image.open(os.path.join(base, "label", f"{frame:04d}.png")))
        meta = scio.loadmat(os.path.join(base, "meta", f"{frame:04d}.mat"))
        intrinsic = meta["intrinsic_matrix"]
        factor_depth = float(np.asarray(meta["factor_depth"]).reshape(-1)[0])
        camera = CameraInfo(
            depth.shape[1],
            depth.shape[0],
            intrinsic[0][0],
            intrinsic[1][1],
            intrinsic[0][2],
            intrinsic[1][2],
            factor_depth,
        )
        cloud = create_point_cloud_from_depth_image(depth, camera, organized=True)
        mask = depth > 0
        if self.remove_outlier:
            camera_poses = np.load(os.path.join(base, "camera_poses.npy"))
            align = np.load(os.path.join(base, "cam0_wrt_table.npy"))
            trans = align @ camera_poses[frame]
            workspace = get_workspace_mask(cloud, seg, trans=trans, organized=True, outlier=0.02)
            mask = mask & workspace
        return cloud[mask], seg[mask], meta

    def set_epoch(self, epoch: int) -> None:
        """Re-seed per-frame randomness for a new epoch."""
        self.epoch = epoch

    def _frame_rng(self, index: int) -> np.random.Generator:
        """Per-(frame, epoch) generator — loader threads share no RNG state
        (a shared np.random.Generator is not thread-safe), and every frame's
        sampling/augmentation is reproducible."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index])
        )

    def _sample(self, n_avail: int, rng: np.random.Generator) -> np.ndarray:
        if n_avail >= self.num_points:
            return rng.choice(n_avail, self.num_points, replace=False)
        extra = rng.choice(n_avail, self.num_points - n_avail, replace=True)
        return np.concatenate([np.arange(n_avail), extra])

    def get_data(self, index: int) -> Dict[str, np.ndarray]:
        """Inference sample: sampled cloud only (reference :104-152)."""
        scene, frame = self.frames[index]
        cloud, seg, _ = self._load_frame(scene, frame)
        idxs = self._sample(len(cloud), self._frame_rng(index))
        return {"point_clouds": cloud[idxs].astype(np.float32)}

    def get_raw_cloud(self, index: int) -> np.ndarray:
        scene, frame = self.frames[index]
        cloud, _, _ = self._load_frame(scene, frame)
        return cloud

    def _object_stats(self, scene: str, ann: int, scores, widths, collision):
        """Cached (lmin, has, vmax) of the collision-zeroed FULL label slabs.

        Key (scene, annotation index) pins the collision labels; the stats
        are per-row independent, so per-frame visibility/subsampling reduce
        to row gathers downstream.  FIFO-evicted under a byte budget
        (GRASPNET_STAT_CACHE_MB, default 4 GiB).
        """
        key = (scene, ann)
        with self._stat_lock:
            hit = self._stat_cache.get(key)
        if hit is not None:
            return hit
        stats = native.label_view_stats_masked(
            scores, widths, collision, self.cfg.grasp_max_width
        )
        nbytes = sum(x.nbytes for x in stats)
        with self._stat_lock:
            if key not in self._stat_cache:
                while self._stat_bytes + nbytes > self._stat_budget and self._stat_cache:
                    old = self._stat_cache.pop(next(iter(self._stat_cache)))
                    self._stat_bytes -= sum(x.nbytes for x in old)
                self._stat_cache[key] = stats
                self._stat_bytes += nbytes
        return stats

    def get_data_label(self, index: int) -> Dict[str, Any]:
        """Training sample with padded labels + precomputed FPS seed chain."""
        scene, frame = self.frames[index]
        cloud, seg, meta = self._load_frame(scene, frame)
        obj_idxs = meta["cls_indexes"].flatten().astype(np.int32)
        poses = meta["poses"]

        rng = self._frame_rng(index)
        idxs = self._sample(len(cloud), rng)
        cloud_s = cloud[idxs].astype(np.float32)
        seg_s = seg[idxs]
        objectness = (seg_s > 0).astype(np.int32)

        object_poses, pts_list, scores_list, widths_list, tol_list = [], [], [], [], []
        objects: List[Dict[str, Any]] = []  # indexed compact-path state
        for i, obj_idx in enumerate(obj_idxs):
            if obj_idx not in self.valid_obj_idxs:
                continue
            if (seg_s == obj_idx).sum() < 50:  # reference :209
                continue
            pose = poses[:, :, i]
            points, offsets, scores, tolerance = self.grasp_labels[obj_idx]
            collision = self.collision_labels[scene][i]
            if self.label_mode == "compact":
                # indexed path: visibility + subsampling reduce to ROW
                # INDICES into the shared full label arrays — no (k,V,A,D)
                # slab copies, no per-frame stats pass (cached per
                # (scene, ann)).  Identical rng draws to the copy path.
                if self.remove_invisible:
                    visible = remove_invisible_grasp_points(
                        cloud_s[seg_s == obj_idx], points, pose, th=0.01
                    )
                    vis_ids = np.flatnonzero(visible)
                else:
                    vis_ids = np.arange(len(points), dtype=np.int64)
                k = min(max(int(len(vis_ids) / 4), 300), len(vis_ids))
                sel = rng.choice(len(vis_ids), k, replace=False)
                widths = offsets[..., 2]
                lmin, has, vmax = self._object_stats(
                    scene, i, scores, widths, collision
                )
                object_poses.append(pose)
                objects.append(
                    dict(
                        rows=vis_ids[sel], points=points, scores=scores,
                        widths=widths, tol=tolerance, coll=collision,
                        lmin=lmin, has=has, vmax=vmax,
                    )
                )
                continue
            if self.remove_invisible:
                visible = remove_invisible_grasp_points(
                    cloud_s[seg_s == obj_idx], points, pose, th=0.01
                )
                points, offsets = points[visible], offsets[visible]
                scores, tolerance = scores[visible], tolerance[visible]
                collision = collision[visible]
            # subsample label points (reference :224)
            k = min(max(int(len(points) / 4), 300), len(points))
            sel = rng.choice(len(points), k, replace=False)
            points, offsets = points[sel], offsets[sel]
            scores = scores[sel].copy()
            tolerance = tolerance[sel].copy()
            collision = collision[sel]
            scores[collision] = 0.0
            tolerance[collision] = 0.0
            object_poses.append(pose)
            pts_list.append(points)
            scores_list.append(scores)
            widths_list.append(offsets[..., 2])
            tol_list.append(tolerance)

        if self.augment:
            cloud_s, object_poses = augment_flip_rotate(cloud_s, object_poses, rng)

        sa_inds, seed_xyz = lp.seed_chain(cloud_s, self.cfg)
        if self.label_mode == "compact":
            # two-phase path: defer the (Ns, V, A, D) slab gathers until the
            # predicted top view is known (Trainer.prepare); ~100x less
            # host->device label traffic per step, bit-identical step output
            ctx = lp.prepare_scene_labels_indexed(
                seed_xyz,
                object_poses,
                objects,
                self.cfg,
                max_objects=self.max_objects,
            )
            return {
                "point_clouds": cloud_s,
                "objectness_label": objectness,
                "sa_inds": sa_inds,
                "label_ctx": ctx,
            }
        labels = lp.build_scene_labels(
            cloud_s,
            seed_xyz,
            object_poses,
            pts_list,
            scores_list,
            widths_list,
            tol_list,
            self.cfg,
            max_objects=self.max_objects,
        )
        labels["point_clouds"] = cloud_s
        labels["objectness_label"] = objectness
        labels["sa_inds"] = sa_inds
        return labels

    def __getitem__(self, index: int):
        return self.get_data_label(index) if self.load_label else self.get_data(index)


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of fixed-shape sample dicts into one batch dict.

    Non-array values (e.g. the host-only SceneLabelContext of the compact
    label path) are kept as plain lists.
    """
    out: Dict[str, Any] = {}
    for k in samples[0]:
        if isinstance(samples[0][k], dict):
            out[k] = {s: np.stack([x[k][s] for x in samples]) for s in samples[0][k]}
        elif isinstance(samples[0][k], (np.ndarray, np.generic, int, float)):
            out[k] = np.stack([x[k] for x in samples])
        else:
            out[k] = [x[k] for x in samples]
    return out


class DataLoader:
    """Thread-pooled prefetching loader (reference DataLoader num_workers=4).

    num_shards/shard_index partition the (identically-seeded, identically-
    shuffled) frame order across processes for multi-host data parallelism:
    every host sees a disjoint slice of each epoch's permutation, so a
    global batch = the concatenation of per-host local batches covers
    distinct frames.

    Call set_epoch(epoch) before each epoch (torch DistributedSampler
    convention) to pin the shuffle to the GLOBAL epoch number: the
    cross-host identical-permutation guarantee then holds even if a host
    restarts mid-training or calls __iter__ a different number of times
    (e.g. an extra eval pass).  Without it, the legacy stream RNG requires
    strict __iter__ lockstep across hosts.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 4, seed: int = 0, drop_last: bool = True, num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._epoch = None
        self.drop_last = drop_last
        assert 0 <= shard_index < num_shards, (shard_index, num_shards)
        self.num_shards = num_shards
        self.shard_index = shard_index

    def set_epoch(self, epoch: int) -> None:
        """Pin the next __iter__'s shuffle to (seed, epoch)."""
        self._epoch = epoch

    def __len__(self):
        n_local = len(self.dataset) // self.num_shards if self.num_shards > 1 else len(self.dataset)
        n = n_local // self.batch_size
        if not self.drop_last and n_local % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            if self._epoch is not None:
                np.random.default_rng(
                    np.random.SeedSequence([self.seed, self._epoch])
                ).shuffle(order)
            else:
                self.rng.shuffle(order)
        if self.num_shards > 1:
            usable = (len(order) // self.num_shards) * self.num_shards
            order = order[:usable][self.shard_index :: self.num_shards]
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        # per-SAMPLE futures (not per-batch): a batch is assembled from
        # whichever workers finish its samples, so a 2-scene batch spreads
        # over 2 cores instead of serializing inside one worker
        flat = [i for b in batches for i in b]
        depth = (self.num_workers + 1) * max(self.batch_size, 1)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            futures = {
                j: pool.submit(self.dataset.__getitem__, idx)
                for j, idx in enumerate(flat[:depth])
            }
            next_submit = min(depth, len(flat))
            pos = 0
            for b in batches:
                samples = [futures.pop(pos + k).result() for k in range(len(b))]
                pos += len(b)
                for _ in range(len(b)):
                    if next_submit < len(flat):
                        futures[next_submit] = pool.submit(
                            self.dataset.__getitem__, flat[next_submit]
                        )
                        next_submit += 1
                yield collate(samples)
