"""First-ns ball query (K4), multi-depth cylinder query (K8) and the
per-query oracle of both (K10): the `csrc/query.cu` kernels and their plain
versions; and the cylinder scan that K8, the crop group (K6) and the
CloudCrop (K5) launch.

Counterpart of `graspnet_tpu/ops/pallas/query.py`: `ball_query_pallas` and
`cylinder_query_multi_pallas` (the two modes of
`multi_query_batched_pallas`) and `multi_query_pallas`.  Each wrapper
launches its kernel for a CUDA tensor and runs its plain version
(`ball_query_plain`, `cylinder_query_multi_plain`, `multi_query_plain`) for
a CPU tensor; each keeps its own launch count.  Indices are int64.
`ball_scan` and `cylinder_scan` launch the scans without a count, for the
wrappers that run them (`ops/cuda/crop.py` too).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from graspnet_tpu_torch.ops.cuda import build
from graspnet_tpu_torch.ops.query import (
    ball_mask,
    chunk_centers,
    cylinder_masks,
    select_first_hits,
)

MAX_DEPTHS = 8  # kMaxDepths of csrc/query.cu and csrc/crop.cu
# K4's schedule (csrc/query.cu): consecutive centres a block takes (one a
# warp), 32-point chunks a warp tests a step, points a shared-memory stage
# holds, stages in the ring
BALL_SCAN_CENTERS, BALL_SCAN_UNROLL, BALL_SCAN_TILE, BALL_SCAN_STAGES = 8, 4, 1024, 4
# The cylinder scan runs on the same ring, a block taking 4 consecutive
# centres, one a warp, and 4 chunks a step (kCylinderWarps, kCylinderUnroll)
CYLINDER_SCAN_CENTERS, CYLINDER_SCAN_UNROLL = 4, 4
# K10 (seed_query_kernel, a warp per centre): 32-point chunks a warp loads
# before it tests them (kSeedUnroll); it reads the points from device
# memory, with no ring
SEED_SCAN_UNROLL = 4


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


def cylinder_query_multi_plain(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    rot: torch.Tensor,
    radius: float,
    hmin: float,
    hmax_list: Sequence[float],
    nsample: int,
) -> torch.Tensor:
    """(B, N, 3), (B, M, 3), (B, M, 3, 3) -> (B, M, D, nsample) int64
    cylinder-query indices for several hmax sharing one rotation pass
    (`graspnet_tpu/models/heads.py:94-154`), a chunk of centres at a time."""
    chunk = chunk_centers(len(hmax_list), xyz.shape[1])
    out = [
        select_first_hits(
            cylinder_masks(
                xyz, new_xyz[:, m0 : m0 + chunk], rot[:, m0 : m0 + chunk],
                radius, hmin, hmax_list,
            ),
            nsample,
        )
        for m0 in range(0, new_xyz.shape[1], chunk)
    ]
    return torch.cat(out, dim=1)


def multi_query_plain(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    rot: torch.Tensor | None,
    radius: float,
    hmin: float,
    hmax_list: Sequence[float],
    nsample: int,
    rotate: bool = True,
) -> torch.Tensor:
    """(B, M, D, nsample) int64, D = len(hmax_list): the cylinder query
    (rotate=True) or, in every depth, the ball query (rotate=False), as
    `multi_query_pallas` computes them."""
    if rotate:
        return cylinder_query_multi_plain(xyz, new_xyz, rot, radius, hmin, hmax_list, nsample)
    idx = ball_query_plain(xyz, new_xyz, radius, nsample)
    return idx[:, :, None, :].expand(-1, -1, len(hmax_list), -1).contiguous()


def _fn(name: str, argtypes):
    fn = getattr(build.load("query"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_inputs(who, xyz, new_xyz, rot, nsample, ndepth):
    """Contiguous float32 CUDA (xyz, new_xyz, rot), or raise; rot=None
    stands for the ball mode, which has no rotations.  The cylinder scan
    also needs a point (a depth with no hits takes point 0)."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    ok = (
        xyz.dtype == torch.float32
        and (rot is None or n >= 1)
        and new_xyz.dtype == torch.float32
        and xyz.shape[-1] == 3
        and new_xyz.shape == (b, m, 3)
        and new_xyz.is_cuda
        and nsample >= 1
        and 1 <= ndepth <= MAX_DEPTHS
        and (rot is None or (rot.dtype == torch.float32 and rot.is_cuda and rot.shape == (b, m, 3, 3)))
    )
    if not ok:
        raise ValueError(
            f"{who} takes float32 CUDA (B, N, 3), (B, M, 3) and (B, M, 3, 3) tensors, "
            f"N >= 1 with rotations, nsample >= 1 and 1-{MAX_DEPTHS} depths"
        )
    return xyz.contiguous(), new_xyz.contiguous(), None if rot is None else rot.contiguous()


def ball_scan(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, out: torch.Tensor) -> None:
    """Launch K4's scan: out (B, M, nsample) int64 <- the padded first-hit
    indices, for contiguous float32 CUDA (B, N, 3) and (B, M, 3).  Counts no
    launch: `ball_query` counts its own, and the fused SA1 stage (K3) runs
    this scan as the first of its two kernels under its own count."""
    b, n, _ = xyz.shape
    m, nsample = out.shape[1], out.shape[2]
    # r*r rounded to float32 once, as the JAX package compares against it
    with build.on_device(xyz.device) as stream:
        err = _fn("gn_ball_query", [_P, _P, _P, _I, _I, _I, _F, _I, _P])(
            xyz.data_ptr(), new_xyz.data_ptr(), out.data_ptr(), b, n, m,
            radius * radius, nsample, stream,
        )
    build.check(err, "ball_query")


def cylinder_scan(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    rot: torch.Tensor,
    radius: float,
    hmin: float,
    hmax_list: Sequence[float],
    out: torch.Tensor,
) -> None:
    """Launch the cylinder scan for contiguous float32 CUDA (B, N >= 1, 3),
    (B, M, 3) and (B, M, 3, 3): an int64 out (B, M, D, nsample) <- the
    padded first-hit indices (K8), a float32 out (B, M, D, nsample, 3) <-
    the rotated offsets of those points (K6, and K5's first launch).  r*r,
    hmin and every hmax are rounded to float32 once.  Counts no launch: each
    caller counts its own."""
    b, n, _ = xyz.shape
    m, ndepth, nsample = out.shape[1:4]
    hmax = (ctypes.c_float * ndepth)(*hmax_list)
    with build.on_device(xyz.device) as stream:
        err = _fn("gn_cylinder_scan", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P, _I, _P])(
            xyz.data_ptr(), new_xyz.data_ptr(), rot.data_ptr(), out.data_ptr(), int(out.dim() == 5),
            b, n, m, nsample, radius * radius, hmin, ctypes.cast(hmax, ctypes.c_void_p), ndepth, stream,
        )
    build.check(err, "cylinder_scan")


def ball_query(
    xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int
) -> torch.Tensor:
    """Indices of the first <= nsample points within `radius` of each center.

    (B, N, 3), (B, M, 3) float32 -> (B, M, nsample) int64.  CUDA tensor: the
    query.cu ball scan (K4); CPU tensor: `ball_query_plain`.
    """
    if not xyz.is_cuda:
        return ball_query_plain(xyz, new_xyz, radius, nsample)
    xyz, new_xyz, _ = _check_inputs("ball_query", xyz, new_xyz, None, nsample, 1)
    out = torch.empty((*new_xyz.shape[:2], nsample), dtype=torch.int64, device=xyz.device)
    ball_scan(xyz, new_xyz, radius, out)
    build.count_launch(ball_query)
    return out


def cylinder_query_multi(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    rot: torch.Tensor,
    radius: float,
    hmin: float,
    hmax_list: Sequence[float],
    nsample: int,
) -> torch.Tensor:
    """Multi-depth cylinder query, (B, N, 3), (B, M, 3), (B, M, 3, 3)
    float32 -> (B, M, D, nsample) int64.  CUDA tensor: the query.cu
    cylinder scan writing indices (K8); CPU tensor:
    `cylinder_query_multi_plain`."""
    hmax_list = tuple(hmax_list)
    if not xyz.is_cuda:
        return cylinder_query_multi_plain(xyz, new_xyz, rot, radius, hmin, hmax_list, nsample)
    ndepth = len(hmax_list)
    if rot is None:
        raise ValueError("cylinder_query_multi needs the rotations")
    xyz, new_xyz, rot = _check_inputs("cylinder_query_multi", xyz, new_xyz, rot, nsample, ndepth)
    out = torch.empty((*new_xyz.shape[:2], ndepth, nsample), dtype=torch.int64, device=xyz.device)
    cylinder_scan(xyz, new_xyz, rot, radius, hmin, hmax_list, out)
    build.count_launch(cylinder_query_multi)
    return out


def multi_query(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    rot: torch.Tensor | None,
    radius: float,
    hmin: float,
    hmax_list: Sequence[float],
    nsample: int,
    rotate: bool = True,
) -> torch.Tensor:
    """The per-query oracle of K4/K8: (B, M, D, nsample) int64 with the
    semantics of `multi_query_plain`.  CUDA tensor: the query.cu
    warp-per-query scan (K10), which shares no code with the ring scan but
    the membership test; CPU tensor: `multi_query_plain`."""
    hmax_list = tuple(hmax_list)
    if not xyz.is_cuda:
        return multi_query_plain(xyz, new_xyz, rot, radius, hmin, hmax_list, nsample, rotate)
    ndepth = len(hmax_list)
    if rotate and rot is None:
        raise ValueError("multi_query(rotate=True) needs the rotations")
    xyz, new_xyz, rot = _check_inputs(
        "multi_query", xyz, new_xyz, rot if rotate else None, nsample, ndepth)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    hmax = (ctypes.c_float * ndepth)(*hmax_list)
    out = torch.empty((b, m, ndepth, nsample), dtype=torch.int64, device=xyz.device)
    with build.on_device(xyz.device) as stream:
        err = _fn("gn_multi_query", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P, _I, _P])(
            xyz.data_ptr(), new_xyz.data_ptr(), 0 if rot is None else rot.data_ptr(), out.data_ptr(),
            b, n, m, nsample, int(rotate), radius * radius, hmin, ctypes.cast(hmax, ctypes.c_void_p),
            ndepth, stream,
        )
    build.check(err, "multi_query")
    build.count_launch(multi_query)
    return out


ball_query.launches = 0
cylinder_query_multi.launches = 0
multi_query.launches = 0
