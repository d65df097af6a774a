"""Plain PyTorch point-cloud operations of the reference: furthest point
sampling, ball and cylinder queries, grouping, 3-NN interpolation, the
fused crops as grouped offsets -> MLP -> max, and the crop MLP's training
forward.

A frozen copy of the port's plain versions (`ops/query.py`, `ops/knn.py`,
the `*_plain` functions of `ops/cuda/*.py` and the gathers of
`ops/scatter.py`), which the port's tests hold against the JAX package.
Gathers are `torch.gather`, whose backward is PyTorch's own scatter-add.
No custom kernel runs here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .layers import SharedMLP, Stats, folded_mlp

NEAR_ORIGIN_SQ = 1e-3
INIT_DIST = 1e10

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


def _take_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, K) int64 -> (B, K, C): out[b, k] = points[b, idx[b, k]]."""
    return _take_rows(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, S) -> (B, M, S, C): out[b,m,s] = points[b, idx[b,m,s]]."""
    b, m, s = idx.shape
    return _take_rows(points, idx.reshape(b, m * s)).reshape(b, m, s, points.shape[-1])


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, m, C), (B, n, 3) int64, (B, n, 3) -> (B, n, C): the weighted sum
    of the three neighbour rows, in neighbour order."""
    b, n, _ = idx.shape
    g = _take_rows(features, idx.reshape(b, n * 3)).reshape(b, n, 3, features.shape[-1])
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]


def _pairwise_d2(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, nq, 3), (B, nr, 3) -> (B, nq, nr) squared distances."""
    dx = query[:, :, None, 0] - ref[:, None, :, 0]
    dy = query[:, :, None, 1] - ref[:, None, :, 1]
    dz = query[:, :, None, 2] - ref[:, None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _iter_min_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row by k first-occurrence argmin passes,
    masking each winner with +inf (`graspnet_tpu/ops/knn.py:54-71`)."""
    dists, idxs = [], []
    for _ in range(k):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        dists.append(torch.gather(d2, -1, i))
        idxs.append(i)
        d2 = d2.scatter(-1, i, float("inf"))
    return torch.cat(dists, dim=-1), torch.cat(idxs, dim=-1)


def knn(ref: torch.Tensor, query: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k nearest `ref` points of each query point.

    (B, Nr, 3), (B, Nq, 3) -> (B, Nq, k) int64, ascending by distance, the
    earliest index first among equal distances (`graspnet_tpu/ops/knn.py:32-51`).
    k <= 4 takes the argmin passes; above, a stable sort of the distances
    stands for `lax.top_k`, which also puts the earliest index first
    (`torch.topk` does not promise that order).
    """
    d2 = _pairwise_d2(query, ref)
    if k <= 4:
        return _iter_min_k(d2, k)[1]
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Three nearest `known` points per `unknown` point.

    (B, n, 3), (B, m, 3) -> dist (B, n, 3) Euclidean, idx (B, n, 3) int64
    (`graspnet_tpu/ops/knn.py:74-95`).
    """
    dist2, idx = _iter_min_k(_pairwise_d2(unknown, known), 3)
    return torch.sqrt(dist2), idx


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """One FPS stage, `graspnet_tpu/ops/sampling.py:53-73` semantics.

    (B, N, 3) float32 -> (B, npoint) int64.  Index 0 first; points with
    x*x+y*y+z*z <= 1e-3 are never picked; min-distance starts at 1e10;
    ties go to the lowest index (torch.argmax returns the first maximum).
    """
    b, n, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    valid = (x * x + y * y + z * z) > NEAR_ORIGIN_SQ
    min_dist = torch.full((b, n), INIT_DIST, dtype=xyz.dtype, device=xyz.device)
    idxs = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = torch.zeros(b, dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        c = xyz[rows, last]  # (B, 3)
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        min_dist = torch.where(valid, torch.minimum(d, min_dist), min_dist)
        last = torch.argmax(torch.where(valid, min_dist, -1.0), dim=1)
        idxs[:, j] = last
    return idxs


def fps_chain_plain(xyz: torch.Tensor, npoints: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Stage k samples the points stage k-1 selected; returns one (B, npoint_k)
    int64 tensor per stage, indexing stage k-1's list."""
    outs = []
    cur = xyz
    for npoint in npoints:
        idx = fps_plain(cur, npoint)
        outs.append(idx)
        cur = torch.gather(cur, 1, idx[..., None].expand(-1, -1, 3))
    return tuple(outs)



def ball_query_plain(
    xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int
) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, M, nsample) int64: the first nsample
    points with d2 < r*r in index order, first-hit padded
    (`graspnet_tpu/ops/query.py:91-128`)."""
    chunk = chunk_centers(1, xyz.shape[1])
    out = [
        select_first_hits(ball_mask(xyz, new_xyz[:, m0 : m0 + chunk], radius), nsample)
        for m0 in range(0, new_xyz.shape[1], chunk)
    ]
    return torch.cat(out, dim=1)


def _grouped_chunks(xyz, new_xyz, rot, radius, hmin, hmax_list, nsample, normalize, ball):
    """(B, N, 3), (B, M, 3), (B, M, 3, 3) | None -> (B, m, D, S, 3) offsets,
    a chunk of m centres at a time, so the masks and whatever the caller
    computes from a chunk stay bounded.

    The selection pads with first-hit / point-0 indices, and gathering the
    raw coordinates at those indices is the kernel's padding on raw values
    (`graspnet_tpu/ops/pallas/crop.py:145-157`); the centre is subtracted
    after the gather, then the rotation (cylinder) and `* normalize`.
    """
    chunk = chunk_centers(1 if ball else len(hmax_list), xyz.shape[1])
    for m0 in range(0, new_xyz.shape[1], chunk):
        c = new_xyz[:, m0 : m0 + chunk]  # (B, m, 3)
        if ball:
            mask = ball_mask(xyz, c, radius)[:, :, None, :]
        else:
            r = rot[:, m0 : m0 + chunk]
            mask = cylinder_masks(xyz, c, r, radius, hmin, hmax_list)
        idx = select_first_hits(mask, nsample)  # (B, m, D, S)
        b, m, d, s = idx.shape
        v = torch.gather(xyz, 1, idx.reshape(b, m * d * s, 1).expand(-1, -1, 3))
        v = v.reshape(b, m, d * s, 3)
        dx = v[..., 0] - c[..., 0:1]
        dy = v[..., 1] - c[..., 1:2]
        dz = v[..., 2] - c[..., 2:3]
        if not ball:
            dx, dy, dz = rotate_offsets(dx, dy, dz, r)
        off = torch.stack([dx, dy, dz], dim=-1)
        if normalize != 1.0:
            off = off * normalize
        yield off.reshape(b, m, d, s, 3)


def crop_group_plain(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    rot: torch.Tensor,
    radius: float,
    hmin: float,
    hmax_list: Sequence[float],
    nsample: int,
) -> torch.Tensor:
    """(B, N, 3), (B, M, 3), (B, M, 3, 3) -> (B, M, D, S, 3) rotated offsets."""
    chunks = _grouped_chunks(xyz, new_xyz, rot, radius, hmin, hmax_list, nsample, 1.0, False)
    return torch.cat(list(chunks), dim=1)


def crop_fused_plain(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    rot: torch.Tensor | None,
    folded,
    radius: float,
    hmin: float,
    hmax_list: Sequence[float],
    nsample: int,
    normalize: float = 1.0,
    ball: bool = False,
) -> torch.Tensor:
    """(B, N, 3), (B, M, 3), (B, M, 3, 3) | None -> (B, M, D, C3) pooled:
    the grouped offsets, the folded MLP and the max over samples, a chunk of
    centres at a time so the activations stay bounded."""
    chunks = _grouped_chunks(xyz, new_xyz, rot, radius, hmin, hmax_list, nsample, normalize, ball)
    return torch.cat([torch.amax(folded_mlp(folded, off), dim=3) for off in chunks], dim=1)



def crop_mlp_train_plain(mlp: SharedMLP, grouped: torch.Tensor) -> Tuple[torch.Tensor, List[Stats]]:
    """(B, Ns, D, S, 3) -> pooled (B, Ns, D, C3) and per-layer
    {mean, unbiased var}: `SharedMLP.forward_train`, then the max over S."""
    out, stats = mlp.forward_train(grouped)
    return torch.amax(out, dim=3), stats



# the port's kernel entry points, by name, as their plain versions
def fps_chain(xyz: torch.Tensor, npoints: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    return fps_chain_plain(xyz, tuple(int(p) for p in npoints))


def ball_query(xyz, new_xyz, radius: float, nsample: int) -> torch.Tensor:
    return ball_query_plain(xyz, new_xyz, radius, nsample)


def sa1_fused(xyz, new_xyz, folded, radius: float, nsample: int) -> torch.Tensor:
    return crop_fused_plain(xyz, new_xyz, None, folded, radius, 0.0, (0.0,), nsample, 1.0 / radius, True)[:, :, 0]


def crop_fused(xyz, new_xyz, rot, folded, radius, hmin, hmax_list, nsample) -> torch.Tensor:
    return crop_fused_plain(xyz, new_xyz, rot, folded, radius, hmin, tuple(hmax_list), nsample)


def crop_group(xyz, new_xyz, rot, radius, hmin, hmax_list, nsample) -> torch.Tensor:
    return crop_group_plain(xyz.detach(), new_xyz.detach(), rot.detach(), radius, hmin, tuple(hmax_list), nsample)


def crop_mlp_train(mlp: SharedMLP, grouped: torch.Tensor):
    return crop_mlp_train_plain(mlp, grouped.detach())

