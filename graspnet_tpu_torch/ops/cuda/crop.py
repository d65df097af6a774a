"""Fused crop (query + gather + frame transform + folded MLP + max), the
crop group (its front half) and the fused SA2-4 stage: the `csrc/crop.cu`
kernels and their plain versions.

Counterpart of `graspnet_tpu/ops/pallas/crop.py::crop_fused_pallas` (the
inference CloudCrop), `sa1_fused_pallas` (backbone SA1, the same function in
ball mode with offsets scaled by 1/r), `crop_group_pallas` (the training
crop's query + group + rotate) and `sa_feat_fused_pallas` (an SA stage with
feature grouping, ball mode with a feature input).  Each wrapper launches
its kernels for a CUDA tensor and runs the plain version
(`crop_fused_plain`, `crop_group_plain`, `sa_feat_fused_plain`) for a CPU
tensor; each keeps its own launch count.  The scans are `csrc/query.cu`'s:
`crop_group` is the cylinder scan writing offsets (`query.cylinder_scan`),
and three wrappers run two kernels under one count: `crop_fused` that scan,
then the tensor-core MLP `crop_mlp_tc_kernel`; `sa1_fused` and
`sa_feat_fused` K4's ball scan (`query.ball_scan`, not counted as a
`ball_query` launch), then `sa1_mlp_tc_kernel` or `sa_feat_tc_kernel`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from graspnet_tpu_torch.nn.layers import folded_mlp
from graspnet_tpu_torch.ops.cuda import build
from graspnet_tpu_torch.ops.cuda.query import MAX_DEPTHS, ball_query_plain, ball_scan, cylinder_scan
from graspnet_tpu_torch.ops.query import (
    ball_mask,
    chunk_centers,
    cylinder_masks,
    group_points,
    rotate_offsets,
    select_first_hits,
)

Folded = Sequence[Tuple[torch.Tensor, torch.Tensor]]
MAX_SAMPLES = 64


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
    folded: Folded,
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


def _fn(name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(build.load("crop"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _operands(*ts: torch.Tensor):
    """Contiguous float32 tensors whose data are 16-byte aligned (the
    kernels read weights as float4 or copy rows in 16-byte units)."""
    out = [t.detach().contiguous().float() for t in ts]
    return [t.clone() if t.data_ptr() % 16 else t for t in out]


def _check_inputs(xyz, new_xyz, rot, w1, nsample, ndepth, ball):
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    return (
        xyz.dtype == torch.float32
        and (ball or n >= 1)
        and new_xyz.shape == (b, m, 3)
        and new_xyz.is_cuda
        and (ball or (rot is not None and rot.shape == (b, m, 3, 3)))
        and w1.shape[0] == 3
        and 1 <= nsample <= MAX_SAMPLES
        and 1 <= ndepth <= MAX_DEPTHS
    )


def cylinder_smem_bytes(c1: int, c2: int, c3: int) -> int:
    """Dynamic shared memory of the CloudCrop's tensor-core MLP kernel at
    widths (c1, c2, c3); 0 where it does not take them (widths multiples of
    8 whose resident W2, W3 and activation tiles fit one block)."""
    fn = _fn("gn_crop_mlp_tc_smem", [ctypes.c_int] * 3, ctypes.c_size_t)
    return int(fn(c1, c2, c3))


def _launch_ball(xyz, new_xyz, folded, radius, nsample, normalize):
    """K3: K4's ball scan into a (B, M, ns) index scratch, then the
    tensor-core MLP over (xyz[idx] - centre) x normalize -> (B, M, c3)."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    (w1, b1), (w2, b2), (w3, b3) = folded
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    if not _check_inputs(xyz, new_xyz, None, w1, nsample, 1, True) or not cylinder_smem_bytes(c1, c2, c3):
        raise ValueError(
            "sa1_fused takes float32 (B,N,3)/(B,M,3) inputs, ns <= "
            f"{MAX_SAMPLES} and a 3-layer 3->c1->c2->c3 MLP with widths multiples of 8 "
            "whose W2 and W3 fit in one block's shared memory"
        )
    ts = _operands(xyz, new_xyz, w1, b1, w2, b2, w3, b3)
    idx = torch.empty((b, m, nsample), dtype=torch.int64, device=xyz.device)
    ball_scan(ts[0], ts[1], radius, idx)
    out = torch.empty((b, m, c3), dtype=torch.float32, device=xyz.device)
    fn = _fn("gn_sa1_mlp", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with build.on_device(xyz.device) as stream:
        err = fn(
            idx.data_ptr(), *(t.data_ptr() for t in ts), out.data_ptr(), b, n, m, nsample,
            normalize, c1, c2, c3, stream,
        )
    build.check(err, "sa1_fused")
    return out


def _launch_cylinder(xyz, new_xyz, rot, folded, radius, hmin, hmax_list, nsample):
    """K5: the cylinder scan into a (B, M, D, ns, 3) offsets scratch, then
    the tensor-core MLP -> (B, M, D, c3)."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    ndepth = len(hmax_list)
    (w1, b1), (w2, b2), (w3, b3) = folded
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    if not _check_inputs(xyz, new_xyz, rot, w1, nsample, ndepth, False) or not cylinder_smem_bytes(c1, c2, c3):
        raise ValueError(
            "crop_fused takes float32 (B,N>=1,3)/(B,M,3)/(B,M,3,3) inputs, <= "
            f"{MAX_DEPTHS} depths, ns <= {MAX_SAMPLES} and a 3-layer 3->c1->c2->c3 MLP with "
            "widths multiples of 8 whose W2 and W3 fit in one block's shared memory"
        )
    ts = _operands(xyz, new_xyz, rot, w1, b1, w2, b2, w3, b3)
    grouped = torch.empty((b, m, ndepth, nsample, 3), dtype=torch.float32, device=xyz.device)
    cylinder_scan(*ts[:3], radius, hmin, hmax_list, grouped)
    out = torch.empty((b, m, ndepth, c3), dtype=torch.float32, device=xyz.device)
    fn = _fn("gn_crop_mlp", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with build.on_device(xyz.device) as stream:
        err = fn(
            grouped.data_ptr(), *(t.data_ptr() for t in ts[3:]), out.data_ptr(), b * m * ndepth, nsample,
            c1, c2, c3, stream,
        )
    build.check(err, "crop_fused")
    return out


def crop_fused(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    rot: torch.Tensor,
    folded: Folded,
    radius: float,
    hmin: float,
    hmax_list: Sequence[float],
    nsample: int,
) -> torch.Tensor:
    """Fused CloudCrop: (B, N, 3), (B, M, 3), (B, M, 3, 3) -> (B, M, D, C3).
    CUDA tensor: the cylinder scan and the tensor-core MLP (one call, two
    kernels); CPU tensor: `crop_fused_plain`."""
    hmax_list = tuple(hmax_list)
    if not xyz.is_cuda:
        return crop_fused_plain(xyz, new_xyz, rot, folded, radius, hmin, hmax_list, nsample)
    out = _launch_cylinder(xyz, new_xyz, rot, folded, radius, hmin, hmax_list, nsample)
    build.count_launch(crop_fused)
    return out


def sa1_fused(
    xyz: torch.Tensor, new_xyz: torch.Tensor, folded: Folded, radius: float, nsample: int
) -> torch.Tensor:
    """Fused SA1 stage: ball query + group + /r + folded MLP + max,
    (B, N, 3), (B, M, 3) -> (B, M, C3).  CUDA tensor: K4's ball scan, then
    the tensor-core MLP (one call, two kernels); CPU tensor:
    `crop_fused_plain(ball=True)`."""
    if not xyz.is_cuda:
        return crop_fused_plain(xyz, new_xyz, None, folded, radius, 0.0, (0.0,), nsample,
                                1.0 / radius, True)[:, :, 0]
    out = _launch_ball(xyz, new_xyz, folded, radius, nsample, 1.0 / radius)
    build.count_launch(sa1_fused)
    return out


def crop_group(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    rot: torch.Tensor,
    radius: float,
    hmin: float,
    hmax_list: Sequence[float],
    nsample: int,
) -> torch.Tensor:
    """Cylinder query + group + centre subtraction + gripper-frame rotation,
    (B, N, 3), (B, M, 3), (B, M, 3, 3) -> (B, M, D, nsample, 3) float32.
    CUDA tensor: the query.cu cylinder scan writing offsets (K6); CPU
    tensor: `crop_group_plain`.

    Not differentiable: the inputs are detached, as `crop_group_pallas`
    stops their gradients (in training they are the cloud, the label grasp
    points and the label view rotations)."""
    xyz, new_xyz, rot = xyz.detach(), new_xyz.detach(), rot.detach()
    hmax_list = tuple(hmax_list)
    if not xyz.is_cuda:
        return crop_group_plain(xyz, new_xyz, rot, radius, hmin, hmax_list, nsample)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    ndepth = len(hmax_list)
    if (
        n < 1
        or xyz.dtype != torch.float32
        or new_xyz.dtype != torch.float32
        or rot.dtype != torch.float32
        or new_xyz.shape != (b, m, 3)
        or rot.shape != (b, m, 3, 3)
        or not (new_xyz.is_cuda and rot.is_cuda)
        or not 1 <= nsample <= MAX_SAMPLES
        or not 1 <= ndepth <= MAX_DEPTHS
    ):
        raise ValueError(
            "crop_group takes float32 CUDA (B,N>=1,3)/(B,M,3)/(B,M,3,3) inputs, "
            f"ns <= {MAX_SAMPLES}, <= {MAX_DEPTHS} depths"
        )
    out = torch.empty((b, m, ndepth, nsample, 3), dtype=torch.float32, device=xyz.device)
    cylinder_scan(xyz.contiguous(), new_xyz.contiguous(), rot.contiguous(), radius, hmin, hmax_list, out)
    build.count_launch(crop_group)
    return out


def sa_feat_fused_plain(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: torch.Tensor,
    folded: Folded,
    radius: float,
    nsample: int,
) -> torch.Tensor:
    """(B, N, 3), (B, M, 3), (B, N, C) -> (B, M, C3): ball query, offsets
    x (1/r) as `_sa_feat_kernel` scales them (`crop.py:491-493`; the
    backbone's generic path divides by r), the features at the padded
    indices (point 0's offset and features for a centre with no hits), the
    folded MLP over [xyz | features] and the max over samples."""
    idx = ball_query_plain(xyz, new_xyz, radius, nsample)
    off = (group_points(xyz, idx) - new_xyz[:, :, None, :]) * (1.0 / radius)
    grouped = torch.cat([off, group_points(features, idx)], dim=-1)
    return torch.amax(folded_mlp(folded, grouped), dim=2)


def sa_feat_smem_bytes(c_in: int, c1: int, c2: int, c3: int) -> int:
    """Dynamic shared memory of the SA2-4 stage's tensor-core MLP kernel at
    feature width c_in and widths (c1, c2, c3); 0 where it does not take
    them (widths multiples of 8, c1 and c2 within its 8 warps' column tiles,
    the row tile's layout with at least 2 weight-ring stages in one block's
    shared memory)."""
    fn = _fn("gn_sa_feat_tc_smem", [ctypes.c_int] * 4, ctypes.c_size_t)
    return int(fn(c_in, c1, c2, c3))


def sa_feat_fused(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: torch.Tensor,
    folded: Folded,
    radius: float,
    nsample: int,
) -> torch.Tensor:
    """Fused SA stage with feature grouping (backbone SA2-4, eval mode):
    (B, N, 3), (B, M, 3), (B, N, C) float32 and the BN-folded MLP
    (3 + C) -> c1 -> c2 -> c3 -> (B, M, c3).  CUDA tensor: K4's ball scan
    into a (B, M, ns) index scratch, then the tensor-core MLP
    `sa_feat_tc_kernel` (one call, two kernels: K9); CPU tensor:
    `sa_feat_fused_plain`."""
    if not xyz.is_cuda:
        return sa_feat_fused_plain(xyz, new_xyz, features, folded, radius, nsample)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    c_in = features.shape[-1]
    (w1, b1), (w2, b2), (w3, b3) = folded
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    if (
        any(t.dtype != torch.float32 or not t.is_cuda for t in (xyz, new_xyz, features))
        or xyz.shape[-1] != 3
        or n < 1
        or new_xyz.shape != (b, m, 3)
        or features.shape[:2] != (b, n)
        or w1.shape[0] != 3 + c_in
        or not 1 <= nsample <= MAX_SAMPLES
        or not sa_feat_smem_bytes(c_in, c1, c2, c3)
    ):
        raise ValueError(
            "sa_feat_fused takes float32 CUDA (B,N>=1,3)/(B,M,3)/(B,N,C) inputs, "
            f"ns <= {MAX_SAMPLES} and a 3-layer (3+C)->c1->c2->c3 MLP with C and the widths "
            "multiples of 8, c1 and c2 <= 256, whose row tile fits one block's shared memory"
        )
    xyz, new_xyz = xyz.detach().contiguous(), new_xyz.detach().contiguous()
    ts = _operands(features, w1, b1, w2, b2, w3, b3)
    idx = torch.empty((b, m, nsample), dtype=torch.int64, device=xyz.device)
    ball_scan(xyz, new_xyz, radius, idx)
    out = torch.empty((b, m, c3), dtype=torch.float32, device=xyz.device)
    # 1/r rounded to float32 once, as the plain version scales by it
    fn = _fn("gn_sa_feat_mlp", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with build.on_device(xyz.device) as stream:
        err = fn(
            idx.data_ptr(), xyz.data_ptr(), new_xyz.data_ptr(), *(t.data_ptr() for t in ts), out.data_ptr(),
            b, n, m, nsample, 1.0 / radius, c_in, c1, c2, c3, stream,
        )
    build.check(err, "sa_feat_fused")
    build.count_launch(sa_feat_fused)
    return out


crop_fused.launches = 0
sa1_fused.launches = 0
crop_group.launches = 0
sa_feat_fused.launches = 0
