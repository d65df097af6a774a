"""Seeded indoor room scans: the scans of the detection cells.

A room of 4-8 m by 4-8 m, 2.5-3 m high, centred on the origin with its
floor at z = 0 (ScanNet's axis-aligned scans stand so): the floor, 2-4 of
the walls and 10-30 axis-aligned furniture boxes standing on the floor
(their tops and sides), sampled uniformly by area to `points` points with
5 mm of Gaussian noise, so that no point lies on an exact plane, in a
random order.  Each point carries its height above the floor, z less the
0.99th percentile of z, as votenet's `scannet_detection_dataset.py` makes
the fourth channel.  A pool of 32 scans of 40,000 points takes about a
second of numpy.
"""

from __future__ import annotations

import numpy as np

NOISE_M = 0.005


def _rects(rng: np.random.Generator, w: float, d: float, h: float):
    """The room's surfaces as rectangles (origin, edge u, edge v)."""
    x0, y0 = -w / 2, -d / 2
    rects = [((x0, y0, 0.0), (w, 0, 0), (0, d, 0))]  # the floor
    walls = [((x0, y0, 0.0), (w, 0, 0), (0, 0, h)), ((x0, -y0, 0.0), (w, 0, 0), (0, 0, h)),
             ((x0, y0, 0.0), (0, d, 0), (0, 0, h)), ((-x0, y0, 0.0), (0, d, 0), (0, 0, h))]
    for k in rng.choice(4, int(rng.integers(2, 5)), replace=False):
        rects.append(walls[k])
    for _ in range(int(rng.integers(10, 31))):
        sx, sy = rng.uniform(0.3, 2.0, 2)
        sz = rng.uniform(0.3, min(2.0, h - 0.2))
        cx, cy = rng.uniform(x0 + sx / 2, -x0 - sx / 2), rng.uniform(y0 + sy / 2, -y0 - sy / 2)
        bx, by = cx - sx / 2, cy - sy / 2
        rects += [((bx, by, sz), (sx, 0, 0), (0, sy, 0)),  # the top
                  ((bx, by, 0.0), (sx, 0, 0), (0, 0, sz)), ((bx, by + sy, 0.0), (sx, 0, 0), (0, 0, sz)),
                  ((bx, by, 0.0), (0, sy, 0), (0, 0, sz)), ((bx + sx, by, 0.0), (0, sy, 0), (0, 0, sz))]
    return [tuple(np.asarray(a, np.float64) for a in r) for r in rects]


def room_scan(rng: np.random.Generator, points: int) -> np.ndarray:
    """(points, 4) float32: xyz and the height above the floor."""
    w, d = rng.uniform(4.0, 8.0, 2)
    h = rng.uniform(2.5, 3.0)
    rects = _rects(rng, w, d, h)
    area = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v in rects])
    which = rng.choice(len(rects), points, p=area / area.sum())
    origin = np.stack([r[0] for r in rects])[which]
    u = np.stack([r[1] for r in rects])[which]
    v = np.stack([r[2] for r in rects])[which]
    st = rng.uniform(0.0, 1.0, (points, 2))
    xyz = origin + st[:, :1] * u + st[:, 1:] * v + rng.normal(0.0, NOISE_M, (points, 3))
    xyz = xyz.astype(np.float32)
    height = xyz[:, 2] - np.percentile(xyz[:, 2], 0.99)
    return np.concatenate([xyz, height[:, None].astype(np.float32)], axis=1)


def room_pool(seed: int, count: int, points: int) -> np.ndarray:
    """(count, points, 4): `count` scans drawn from `seed`."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32 & 0xFFFFFFFF, 0x500A])
    return np.stack([room_scan(rng, points) for _ in range(count)])
