"""Seeded grid-sampled room fragments: the scans of the segmentation cell.

`rooms.py`'s rooms (a floor, 2-4 walls, 10-30 furniture boxes; its
surfaces and 5 mm of Gaussian noise), sampled densely enough that grid
sampling leaves a surface's cells occupied as a ScanNet mesh's vertices
do: `DENSITY` raw points a 2 cm cell of surface (Poisson, so ~92 % of a
surface's cells get one).  Each point carries its surface's unit normal
and the surface's seeded colour (0-255 an channel) with 10 units of
Gaussian noise, clipped.  Then, as Pointcept's ScanNet pipeline prepares a
scene for Point Transformer V3:

  * `GridSample(grid_size=0.02)`: the cell of a point is floor(coord /
    0.02) and each occupied cell keeps one point (the first drawn);
  * `SphereCrop(point_max=102400)`: the `points` points nearest a seeded
    point of the room's surfaces (all of them in a room with fewer);
    where the caller gives a range of scene sizes, each fragment first
    draws one from it and keeps the lesser of that size and `points` (a
    scene smaller than the crop stands in as that many points nearest the
    centre), so fragments differ in length; the draws are stratified:
    fragment i draws uniformly from the (i mod `strata`)-th of `strata`
    equal parts of the range, so each run of `strata` fragments (a batch)
    holds one scene of each part and batches carry alike amounts of work;
  * `grid_coord` = the cell less the fragment's least cell an axis, so
    every index is >= 0 and two points never share one;
  * `feat` = [colour / 127.5 - 1, normal], 6 channels;
  * the points in a seeded random order (GridSample's hash order is one).

A pool of 16 fragments of up to 102,400 points takes a few seconds of
numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from benchmark.inputs.rooms import NOISE_M, _rects

GRID_M = 0.02
DENSITY = 2.5  # raw points a grid cell of surface
COLOUR_NOISE = 10.0

Fragment = Tuple[np.ndarray, np.ndarray, np.ndarray]  # coord (n, 3) f32, grid_coord (n, 3) i32, feat (n, 6) f32


def _clipped(rects, lo, hi):
    """Each rectangle's part inside the box [lo, hi] (its edges run along
    the axes): (index, s0, s1, t0, t1, area) in its edge parameters."""
    out = []
    for i, (o, u, v) in enumerate(rects):
        a, b = int(np.argmax(u)), int(np.argmax(v))
        fixed = 3 - a - b
        if not lo[fixed] <= o[fixed] <= hi[fixed]:
            continue
        s0, s1 = np.clip((np.array([lo[a], hi[a]]) - o[a]) / u[a], 0.0, 1.0)
        t0, t1 = np.clip((np.array([lo[b], hi[b]]) - o[b]) / v[b], 0.0, 1.0)
        out.append((i, s0, s1, t0, t1, (s1 - s0) * u[a] * (t1 - t0) * v[b]))
    return out


def _sample(rng, rects, lo, hi):
    """The raw points of the rectangles' parts inside the box [lo, hi] at
    `DENSITY` points a cell, Poisson; returns xyz and each point's
    rectangle."""
    parts, which = [], []
    for i, s0, s1, t0, t1, area in _clipped(rects, lo, hi):
        o, u, v = rects[i]
        n = rng.poisson(area * DENSITY / GRID_M ** 2)
        st = rng.uniform(0.0, 1.0, (n, 2)) * [s1 - s0, t1 - t0] + [s0, t0]
        parts.append(o + st[:, :1] * u + st[:, 1:] * v)
        which.append(np.full(n, i))
    xyz = np.concatenate(parts)
    return xyz + rng.normal(0.0, NOISE_M, xyz.shape), np.concatenate(which)


def room_fragment(rng: np.random.Generator, points: int) -> Fragment:
    """One room's fragment.  The raw points are drawn only in a cube about
    the crop's centre (a point drawn on a surface, weighted by area),
    half-side R + 3 cm: R the least of 0.5 m x 1.1^i whose cube's surface
    area, times pi / 4 (a disc in its square), would fill `points` cells
    a fifth over, grown by half until the points within R of the centre
    fill them (or the cube holds the room).  The crop takes the cells
    nearest the centre among those within R, so it is the crop of the
    whole room's sample."""
    w, d = rng.uniform(4.0, 8.0, 2)
    h = rng.uniform(2.5, 3.0)
    rects = _rects(rng, w, d, h)
    cross = np.stack([np.cross(u, v) for _, u, v in rects])
    area = np.linalg.norm(cross, axis=1)
    normal = (cross / area[:, None]).astype(np.float32)
    colour = rng.uniform(0.0, 255.0, (len(rects), 3))
    o, u, v = rects[rng.choice(len(rects), p=area / area.sum())]
    centre = o + rng.uniform(0.0, 1.0) * u + rng.uniform(0.0, 1.0) * v
    room_lo, room_hi = np.array([-w / 2, -d / 2, 0.0]), np.array([w / 2, d / 2, h])
    r = 0.5
    need = 1.2 * points * GRID_M ** 2 / (1.0 - np.exp(-DENSITY))
    while np.pi / 4 * sum(c[-1] for c in _clipped(rects, centre - r, centre + r)) < need and r < max(w, d, h):
        r *= 1.1
    while True:
        xyz, which = _sample(rng, rects, centre - r - 0.03, centre + r + 0.03)
        cell = np.floor(xyz / GRID_M).astype(np.int64)
        cell -= cell.min(axis=0)
        span = cell.max(axis=0) + 1
        _, keep = np.unique((cell[:, 0] * span[1] + cell[:, 1]) * span[2] + cell[:, 2], return_index=True)
        d2 = np.square(xyz[keep] - centre).sum(axis=1)
        inside = d2 <= r * r
        whole = np.all(centre - r <= room_lo) and np.all(centre + r >= room_hi)
        if inside.sum() >= points or whole:
            break
        r *= 1.5
    keep, d2 = keep[inside], d2[inside]
    if len(keep) > points:
        keep = np.sort(keep[np.argpartition(d2, points - 1)[:points]])
    keep = keep[rng.permutation(len(keep))]
    grid = cell[keep] - cell[keep].min(axis=0)
    rgb = np.clip(colour[which[keep]] + rng.normal(0.0, COLOUR_NOISE, (len(keep), 3)), 0.0, 255.0)
    feat = np.concatenate([rgb / 127.5 - 1.0, normal[which[keep]]], axis=1).astype(np.float32)
    return xyz[keep].astype(np.float32), grid.astype(np.int32), feat


def fragment_pool(seed: int, count: int, points: int, scene_points: Optional[Tuple[int, int]] = None,
                  strata: int = 1) -> List[Fragment]:
    """`count` fragments of up to `points` points drawn from `seed`; with
    `scene_points` (least, most), fragment i holds the lesser of `points`
    and a scene size drawn uniformly from the (i mod `strata`)-th of
    `strata` equal parts of that range."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32 & 0xFFFFFFFF, 0x5E6])
    out = []
    for i in range(count):
        n = points
        if scene_points is not None:
            lo, hi = scene_points
            part = (hi - lo) / strata
            a = lo + part * (i % strata)
            n = min(points, int(rng.uniform(a, a + part)))
        out.append(room_fragment(rng, n))
    return out
