"""The training loader's label prep in plain numpy: a frozen copy of the
port's `GraspNetDataset.get_data_label` in its full label mode (the
compact mode is bitwise the same step), with its sampling, augmentation,
visibility filter and seed chain, on the numpy plain versions of the host
library (`label_pipeline.fps_numpy`, `nearest`, `label_view_stats`,
`visible_mask_plain`), and the loader's shuffle and collation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from . import label_pipeline as lp
from .config import GraspNetConfig


def transform_point_cloud_np(cloud: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """(N,3) x (3,3)|(3,4)|(4,4) -> (N,3)."""
    if transform.shape == (3, 3):
        return (transform @ cloud.T).T
    rot, trans = transform[:3, :3], transform[:3, 3]
    return (rot @ cloud.T).T + trans


def visible_mask_plain(cloud: np.ndarray, pts: np.ndarray, th: float) -> np.ndarray:
    """(N, 3) scene cloud, (M, 3) points -> (M,) bool: the nearest scene
    point lies closer than `th`."""
    out = np.empty(len(pts), dtype=bool)
    step = 4096
    for i in range(0, len(pts), step):
        d = np.linalg.norm(pts[i: i + step][:, None, :] - cloud[None, :, :], axis=-1)
        out[i: i + step] = d.min(axis=1) < th
    return out


def remove_invisible_grasp_points(cloud, grasp_points, pose, th: float = 0.01) -> np.ndarray:
    return visible_mask_plain(cloud, transform_point_cloud_np(grasp_points, pose), th)


def augment_flip_rotate(cloud: np.ndarray, poses: List[np.ndarray], rng: np.random.Generator):
    """Random YZ flip + uniform +-30 degree rotation about camera X."""
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


class SceneLabels:
    """`get_data_label` over one scene's raw arrays (every frame reads it):
    `cloud`, `seg`, `meta`, `grasp_labels` and `collision` as the loader's
    dataset holds them."""

    def __init__(self, scene: Dict[str, Any], cfg: GraspNetConfig, num_points: int, seed: int = 0,
                 epoch: int = 0, max_objects: int = 16):
        self.scene, self.cfg, self.num_points = scene, cfg, num_points
        self.seed, self.epoch, self.max_objects = seed, epoch, max_objects
        self.valid_obj_idxs = list(scene["grasp_labels"])

    def _frame_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, index]))

    def _sample(self, n_avail: int, rng: np.random.Generator) -> np.ndarray:
        if n_avail >= self.num_points:
            return rng.choice(n_avail, self.num_points, replace=False)
        extra = rng.choice(n_avail, self.num_points - n_avail, replace=True)
        return np.concatenate([np.arange(n_avail), extra])

    def get_data_label(self, index: int) -> Dict[str, Any]:
        cloud, seg, meta = self.scene["cloud"], self.scene["seg"], self.scene["meta"]
        obj_idxs = meta["cls_indexes"].flatten().astype(np.int32)
        poses = meta["poses"]
        rng = self._frame_rng(index)
        idxs = self._sample(len(cloud), rng)
        cloud_s = cloud[idxs].astype(np.float32)
        seg_s = seg[idxs]
        objectness = (seg_s > 0).astype(np.int32)
        object_poses, pts_list, scores_list, widths_list, tol_list = [], [], [], [], []
        for i, obj_idx in enumerate(obj_idxs):
            if obj_idx not in self.valid_obj_idxs:
                continue
            if (seg_s == obj_idx).sum() < 50:
                continue
            pose = poses[:, :, i]
            points, offsets, scores, tolerance = self.scene["grasp_labels"][obj_idx]
            collision = self.scene["collision"][i]
            visible = remove_invisible_grasp_points(cloud_s[seg_s == obj_idx], points, pose, th=0.01)
            points, offsets = points[visible], offsets[visible]
            scores, tolerance = scores[visible], tolerance[visible]
            collision = collision[visible]
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
        cloud_s, object_poses = augment_flip_rotate(cloud_s, object_poses, rng)
        sa_inds, seed_xyz = lp.seed_chain(cloud_s, self.cfg)
        labels = lp.build_scene_labels(cloud_s, seed_xyz, object_poses, pts_list, scores_list, widths_list,
                                       tol_list, self.cfg, max_objects=self.max_objects)
        labels["point_clouds"] = cloud_s
        labels["objectness_label"] = objectness
        labels["sa_inds"] = sa_inds
        return labels


def loader_batches(n_frames: int, batch_size: int, seed: int = 0, epoch: int = 0) -> List[np.ndarray]:
    """The frames of each batch of an epoch, in order: the loader's
    shuffle pinned to (seed, epoch), whole batches only."""
    order = np.arange(n_frames)
    np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(order)
    return [order[i: i + batch_size] for i in range(0, n_frames - batch_size + 1, batch_size)]


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in samples[0]:
        if isinstance(samples[0][k], dict):
            out[k] = {s: np.stack([x[k][s] for x in samples]) for s in samples[0][k]}
        else:
            out[k] = np.stack([x[k] for x in samples])
    return out
