"""Radius (ball) and oriented-cylinder queries, plus grouping.

Counterpart of `graspnet_tpu/ops/query.py` and of the cylinder query in
`graspnet_tpu/models/heads.py:94-154`.  Selection semantics are the
reference CUDA scan's: the first `nsample` hits in index order; an empty
slot takes the first hit; a row with no hits is all index 0.

The kernel wrappers of the ball query and of the multi-depth cylinder
query, with their plain versions, live in `ops/cuda/query.py` (exported as
`ops.ball_query` and `ops.cylinder_query_multi_depth`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from graspnet_tpu_torch.ops.scatter import gather_rows

# (rows x points) elements per chunk of a plain query: bounds the mask and
# running-count buffers (int32) to ~64 MB at any cloud size
CHUNK_ELEMS = 1 << 24


def select_first_hits(mask: torch.Tensor, nsample: int) -> torch.Tensor:
    """First `nsample` True positions per row, index order, first-hit padding.

    mask: (..., n) bool -> (..., nsample) int64 (`graspnet_tpu/ops/query.py:45-88`).
    The s-th hit is the first position whose running hit count reaches s,
    which `searchsorted` finds on the inclusive prefix count.
    """
    lead = mask.shape[:-1]
    n = mask.shape[-1]
    m2 = mask.reshape(-1, n)
    rank = torch.cumsum(m2, dim=-1, dtype=torch.int32)  # (m, n) non-decreasing
    slots = torch.arange(1, nsample + 1, dtype=torch.int32, device=mask.device)
    idx = torch.searchsorted(rank, slots.expand(m2.shape[0], nsample).contiguous())
    total = rank[:, -1:]
    first = idx[:, 0:1]
    idx = torch.where(slots[None, :] <= total, idx, first)  # first-hit padding
    idx = torch.where(total == 0, torch.zeros_like(idx), idx)  # zero-hit rows -> 0
    return idx.reshape(*lead, nsample)


def chunk_centers(rows_per_center: int, n: int) -> int:
    """Centres per chunk of a plain query with rows_per_center masks of n points."""
    return max(1, CHUNK_ELEMS // max(1, rows_per_center * n))


def ball_mask(xyz: torch.Tensor, centers: torch.Tensor, radius: float) -> torch.Tensor:
    """(B, N, 3), (B, m, 3) -> (B, m, N) bool, d2 = dx*dx+dy*dy+dz*dz < r*r."""
    dx = xyz[:, None, :, 0] - centers[..., 0:1]
    dy = xyz[:, None, :, 1] - centers[..., 1:2]
    dz = xyz[:, None, :, 2] - centers[..., 2:3]
    return dx * dx + dy * dy + dz * dz < radius * radius


def rotate_offsets(dx, dy, dz, rot: torch.Tensor):
    """Offsets into the gripper frame, offset @ R with the transposed
    convention x_r = dx*R00 + dy*R10 + dz*R20 (`heads.py:121-143`).

    dx/dy/dz broadcast against rot[..., i, j][..., None]."""
    def axis(j):
        return (
            dx * rot[..., 0, j, None]
            + dy * rot[..., 1, j, None]
            + dz * rot[..., 2, j, None]
        )

    return axis(0), axis(1), axis(2)


def cylinder_masks(
    xyz: torch.Tensor,
    centers: torch.Tensor,
    rot: torch.Tensor,
    radius: float,
    hmin: float,
    hmax_list: Sequence[float],
) -> torch.Tensor:
    """(B, N, 3), (B, m, 3), (B, m, 3, 3) -> (B, m, D, N) bool masks
    y_r^2 + z_r^2 < r^2 and hmin < x_r < hmax_d."""
    dx = xyz[:, None, :, 0] - centers[..., 0:1]
    dy = xyz[:, None, :, 1] - centers[..., 1:2]
    dz = xyz[:, None, :, 2] - centers[..., 2:3]
    x_r, y_r, z_r = rotate_offsets(dx, dy, dz, rot)
    base = (y_r * y_r + z_r * z_r < radius * radius) & (x_r > hmin)
    hmaxs = torch.tensor(hmax_list, dtype=xyz.dtype, device=xyz.device)
    return base[:, :, None, :] & (x_r[:, :, None, :] < hmaxs[None, None, :, None])


def cylinder_query(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    rot: torch.Tensor,
    radius: float,
    hmin: float,
    hmax: float,
    nsample: int,
) -> torch.Tensor:
    """(B, N, 3), (B, M, 3), (B, M, 3, 3) -> (B, M, nsample) int64: the
    single-depth cylinder query (`graspnet_tpu/ops/query.py:131-193`), plain
    torch on any device, as in the JAX package."""
    chunk = chunk_centers(1, xyz.shape[1])
    out = [
        select_first_hits(
            cylinder_masks(
                xyz, new_xyz[:, m0 : m0 + chunk], rot[:, m0 : m0 + chunk],
                radius, hmin, (hmax,),
            )[:, :, 0],
            nsample,
        )
        for m0 in range(0, new_xyz.shape[1], chunk)
    ]
    return torch.cat(out, dim=1)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, S) -> (B, M, S, C): out[b,m,s] = points[b, idx[b,m,s]];
    the backward is the deterministic scatter-add (`ops/scatter.py`), as
    the JAX `custom_vjp` (`graspnet_tpu/ops/query.py:196-229`)."""
    b, m, s = idx.shape
    return gather_rows(points, idx.reshape(b, m * s)).reshape(b, m, s, points.shape[-1])
