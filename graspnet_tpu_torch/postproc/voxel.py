"""Voxel-grid downsampling, the plain version of the host library's
`native.voxel_downsample` (`csrc/host.cpp::gn_voxel_downsample`).

A copy of `graspnet_tpu/postproc/voxel.py`.  Like open3d's
voxel_down_sample it averages the points of each occupied voxel of an
axis-aligned grid anchored half a voxel below the cloud's minimum.  The
rows come out in voxel-key order; the host library's come out unordered,
and every consumer (the collision counts, the evaluator's model clouds) is
order-invariant.
"""

from __future__ import annotations

import numpy as np


def voxel_down_sample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """(N, 3) -> (K, 3) centroid per occupied voxel."""
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) == 0:
        return pts.astype(np.float32)
    min_bound = pts.min(axis=0) - voxel_size * 0.5
    coords = np.floor((pts - min_bound) / voxel_size).astype(np.int64)
    # unique voxel ids via lexicographic packing
    dims = coords.max(axis=0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    uniq, inverse = np.unique(key, return_inverse=True)
    sums = np.zeros((len(uniq), 3), dtype=np.float64)
    np.add.at(sums, inverse, pts)
    counts = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
    return (sums / counts[:, None]).astype(np.float32)
