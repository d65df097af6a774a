"""Seeded raw tabletop captures: the requests of the robot cells.

A frozen copy of the port's `utils/synthetic.py::tabletop_cloud`: a
camera-frame table plane at z = 0.55 m with boxes and spheres standing on
it, about 0.5 m from the camera, the points in a random order.  A capture
of 250,000 points (a RealSense frame after the workspace mask) takes tens
of milliseconds.
"""

from __future__ import annotations

from typing import List

import numpy as np


def tabletop_cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3) float32 camera-frame tabletop."""
    parts = []
    n_table = n * 2 // 5
    parts.append(np.stack([rng.uniform(-0.3, 0.3, n_table), rng.uniform(-0.3, 0.3, n_table),
                           0.55 + rng.normal(0, 0.001, n_table)], 1))
    n_obj = n - n_table
    per = n_obj // 6
    for k in range(6):
        cnt = per if k < 5 else n_obj - 5 * per
        cx, cy = rng.uniform(-0.2, 0.2, 2)
        if k % 2 == 0:  # box: points on its faces
            half = rng.uniform(0.02, 0.06, 3)
            p = rng.uniform(-1, 1, (cnt, 3))
            face = rng.integers(0, 3, cnt)
            p[np.arange(cnt), face] = np.sign(p[np.arange(cnt), face])
            p = p * half + [cx, cy, 0.55 - half[2]]
        else:  # sphere
            r = rng.uniform(0.02, 0.05)
            v = rng.normal(size=(cnt, 3))
            p = v / np.linalg.norm(v, axis=1, keepdims=True) * r + [cx, cy, 0.55 - r]
        parts.append(p)
    cloud = np.concatenate(parts, 0).astype(np.float32)
    return cloud[rng.permutation(len(cloud))]


def capture_pool(seed: int, count: int, points: int) -> List[np.ndarray]:
    """`count` captures of `points` points, drawn from `seed`."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32 & 0xFFFFFFFF, 0x7AB1E])
    return [tabletop_cloud(rng, points) for _ in range(count)]
