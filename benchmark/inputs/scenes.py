"""Seeded training scenes at the production shape of GraspNet-1Billion.

A frozen copy of the fabrication in the port's `data/synthetic.py`
(`SyntheticGraspNetDataset`), rewritten to take the seed and to make the
label slabs on the device: each object's (label points, 300 views, 12
angles, 4 depths) score, offset and tolerance slabs and its collision
labels are drawn with a `torch.Generator` on the device in a few large
calls and copied to the host once (~3.9 GB for 8 objects of 1600 label
points), so set-up does not spend tens of seconds in numpy.  The scene
cloud is a table plane and, per object, a jittered visible subset of its
label points moved to the object's pose, so the visibility filter keeps
about `visible_frac` of the label points, as a real partly occluded view.
Every frame of the dataset reads this one scene; the dataset's
per-(frame, epoch) generator makes frames differ, as in training.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def make_scene(seed: int, num_view: int, num_angle: int, num_depth: int, n_objects: int = 8,
               label_points: int = 1600, cloud_points: int = 35000, visible_frac: float = 0.8,
               device="cuda") -> Dict[str, object]:
    """The raw arrays a loader reads: `grasp_labels` (object id ->
    (points, offsets, scores, tolerance)), `collision` (annotation index ->
    bool slab), `cloud`, `seg` and `meta`."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32 & 0xFFFFFFFF, 0x5CE4E])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**62)))
    shape = (label_points, num_view, num_angle, num_depth)
    centers = rng.uniform(-0.15, 0.15, (n_objects, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(0.45, 0.6, n_objects)
    grasp_labels, collision = {}, {}
    for o in range(n_objects):
        pts = rng.uniform(-0.04, 0.04, (label_points, 3)).astype(np.float32)
        u = torch.rand((6, *shape), generator=gen, device=device)
        scores = u[0] * 1.2
        scores = torch.where(u[1] < 0.15, torch.zeros_like(scores), scores)  # ~15 % infeasible
        offsets = torch.stack([u[2] * np.pi, 0.01 + u[3] * 0.03, u[4] * 0.12], dim=-1)
        tol = torch.rand(shape, generator=gen, device=device) * 0.05
        grasp_labels[o + 1] = (pts, offsets.cpu().numpy(), scores.cpu().numpy(), tol.cpu().numpy())
        collision[o] = (u[5] < 0.1).cpu().numpy()
        del u, scores, offsets, tol
    half = cloud_points // 2
    parts = [np.stack([rng.uniform(-0.4, 0.4, half), rng.uniform(-0.4, 0.4, half),
                       np.full(half, 0.7, np.float32)], axis=1).astype(np.float32)]
    segs = [np.zeros(half, np.int32)]
    poses = np.zeros((3, 4, n_objects), np.float32)
    per_obj = (cloud_points - half) // n_objects
    n_vis = int(label_points * visible_frac)
    for o in range(n_objects):
        poses[:, :3, o] = np.eye(3, dtype=np.float32)
        poses[:, 3, o] = centers[o]
        vis = rng.choice(label_points, n_vis, replace=False)
        surf = grasp_labels[o + 1][0][vis] + centers[o]
        surf = surf[rng.integers(0, n_vis, per_obj)]
        parts.append((surf + rng.normal(0, 0.002, surf.shape)).astype(np.float32))
        segs.append(np.full(per_obj, o + 1, np.int32))
    meta = {"cls_indexes": np.arange(1, n_objects + 1, dtype=np.int32)[None], "poses": poses.astype(np.float64)}
    return {"grasp_labels": grasp_labels, "collision": collision, "cloud": np.concatenate(parts),
            "seg": np.concatenate(segs), "meta": meta, "n_objects": n_objects}
