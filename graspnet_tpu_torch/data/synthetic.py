"""Production-shape synthetic dataset for pipeline benchmarks and smoke tests
(a copy of `graspnet_tpu/data/synthetic.py`).

`SyntheticGraspNetDataset` fabricates in-memory raw inputs with the same
shapes/statistics as a real GraspNet-1B training frame (reference
dataset/graspnet_dataset.py:104-247: ~35k-point scene cloud, ~8 labeled
objects with (Np, V, A, D) score/offset/tolerance slabs and per-scene
collision labels) and then runs the UNMODIFIED `GraspNetDataset.get_data_label`
path on them — visibility filtering, label subsampling, collision zeroing,
augmentation, FPS seed chain, compact label preparation.  Only the on-disk
frame decode (`_load_frame`) is stubbed out, so a loader benchmark over this
dataset measures exactly the host label-prep work a real training run pays
per frame, minus disk/PNG costs (which a benchmark's "data gen excluded"
convention sets aside).

Raw arrays are generated once at construction (untimed); per-frame work is
the real per-frame path, differentiated by the dataset's per-(frame, epoch)
RNG exactly as in training.
"""

from __future__ import annotations

import numpy as np

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.data.dataset import GraspNetDataset


class SyntheticGraspNetDataset(GraspNetDataset):
    """GraspNetDataset over fabricated production-shape frames.

    Geometry is constructed so the visibility filter keeps a realistic
    fraction of label points: each object's scene-surface points are a
    jittered (sigma << th=0.01) subset of its transformed label points, so
    roughly `visible_frac` of label points find a scene point within the
    visibility threshold, like a real partially-occluded object view.
    """

    def __init__(
        self,
        n_frames: int = 64,
        n_objects: int = 8,
        label_points: int = 1600,
        cloud_points: int = 35000,
        num_points: int = 20000,
        visible_frac: float = 0.8,
        cfg: GraspNetConfig = GraspNetConfig(),
        augment: bool = True,
        label_mode: str = "compact",
        seed: int = 0,
        with_labels: bool = True,
    ):
        """with_labels=False skips the (big) label-slab fabrication for
        inference-only benchmarks (load_label=False paths)."""
        rng = np.random.default_rng(seed)
        v, a, d = cfg.num_view, cfg.num_angle, cfg.num_depth

        # per-object label slabs (shared across frames, like the real
        # per-object grasp_label files reused by every scene)
        grasp_labels = {}
        valid_obj_idxs = []
        centers = rng.uniform(-0.15, 0.15, (n_objects, 3)).astype(np.float32)
        centers[:, 2] = rng.uniform(0.45, 0.6, n_objects)
        for o in range(n_objects):
            oid = o + 1
            valid_obj_idxs.append(oid)
            pts = rng.uniform(-0.04, 0.04, (label_points, 3)).astype(np.float32)
            if not with_labels:
                grasp_labels[oid] = (pts, None, None, None)
                continue
            scores = rng.uniform(0.0, 1.2, (label_points, v, a, d)).astype(np.float32)
            # ~15% infeasible (score 0), like real friction labels
            scores[rng.random((label_points, v, a, d)) < 0.15] = 0.0
            offsets = np.empty((label_points, v, a, d, 3), np.float32)
            offsets[..., 0] = rng.uniform(0, np.pi, (label_points, v, a, d))
            offsets[..., 1] = rng.uniform(0.01, 0.04, (label_points, v, a, d))
            offsets[..., 2] = rng.uniform(0.0, 0.12, (label_points, v, a, d))
            tol = rng.uniform(0.0, 0.05, (label_points, v, a, d)).astype(np.float32)
            grasp_labels[oid] = (pts, offsets, scores, tol)

        # one scene: per-frame randomness comes from the dataset's
        # per-(frame, epoch) RNG, exactly as in real training
        scene = "scene_synth"
        collision = (
            {
                o: rng.random((label_points, v, a, d)) < 0.1
                for o in range(n_objects)
            }
            if with_labels
            else {}
        )

        # scene cloud: background table plane + per-object surfaces that are
        # jittered subsets of the transformed label points
        poses = np.zeros((3, 4, n_objects), np.float32)
        cloud_parts = [
            np.stack(
                [
                    rng.uniform(-0.4, 0.4, cloud_points // 2),
                    rng.uniform(-0.4, 0.4, cloud_points // 2),
                    np.full(cloud_points // 2, 0.7, np.float32),
                ],
                axis=1,
            ).astype(np.float32)
        ]
        seg_parts = [np.zeros(cloud_points // 2, np.int32)]
        per_obj = (cloud_points - cloud_points // 2) // n_objects
        for o in range(n_objects):
            poses[:, :3, o] = np.eye(3, dtype=np.float32)
            poses[:, 3, o] = centers[o]
            n_vis = int(label_points * visible_frac)
            vis = rng.choice(label_points, n_vis, replace=False)
            surf = grasp_labels[o + 1][0][vis] + centers[o]
            surf = surf[rng.integers(0, n_vis, per_obj)]
            surf = surf + rng.normal(0, 0.002, surf.shape).astype(np.float32)
            cloud_parts.append(surf.astype(np.float32))
            seg_parts.append(np.full(per_obj, o + 1, np.int32))
        self._cloud = np.concatenate(cloud_parts, axis=0)
        self._seg = np.concatenate(seg_parts, axis=0)
        self._meta = {
            "cls_indexes": np.arange(1, n_objects + 1, dtype=np.int32)[None],
            "poses": poses.astype(np.float64),
        }

        # GraspNetDataset.__init__ scans the filesystem; build the state
        # it would have produced directly instead
        super().__init__(
            root="<synthetic>",
            valid_obj_idxs=valid_obj_idxs,
            grasp_labels=grasp_labels,
            split="train",
            num_points=num_points,
            remove_outlier=False,
            remove_invisible=True,
            augment=augment,
            load_label=with_labels,
            cfg=cfg,
            seed=seed,
            label_mode=label_mode,
        )
        self.frames = [(scene, f) for f in range(n_frames)]
        self.collision_labels = {scene: collision}

    def _load_frame(self, scene: str, frame: int):
        return self._cloud, self._seg, self._meta
