"""Fused crop (query + gather + frame transform + folded MLP + max): the
`csrc/crop.cu` kernel and its plain version.

Counterpart of `graspnet_tpu/ops/pallas/crop.py::crop_fused_pallas` (the
inference CloudCrop) and `sa1_fused_pallas` (backbone SA1, the same kernel in
ball mode with offsets scaled by 1/r).  Both wrappers launch one kernel for a
CUDA tensor and run `crop_fused_plain` for a CPU tensor; each keeps its own
launch count.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from graspnet_tpu_torch.nn.layers import folded_mlp
from graspnet_tpu_torch.ops.cuda import build
from graspnet_tpu_torch.ops.query import (
    CHUNK_ELEMS,
    ball_mask,
    cylinder_masks,
    rotate_offsets,
    select_first_hits,
)

Folded = Sequence[Tuple[torch.Tensor, torch.Tensor]]
MAX_SAMPLES = 64
MAX_DEPTHS = 8


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
    """(B, N, 3), (B, M, 3), (B, M, 3, 3) | None -> (B, M, D, C3) pooled.

    The selection pads with first-hit / point-0 indices, and gathering the
    raw coordinates at those indices is the kernel's padding on raw values
    (`graspnet_tpu/ops/pallas/crop.py:145-157`); the centre is subtracted
    after the gather, then the rotation (cylinder) and `* normalize`.
    """
    n = xyz.shape[1]
    ndepth = 1 if ball else len(hmax_list)
    chunk = max(1, CHUNK_ELEMS // (n * ndepth))
    pooled = []
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
        h = folded_mlp(folded, off.reshape(b, m, d, s, 3))
        pooled.append(torch.amax(h, dim=3))
    return torch.cat(pooled, dim=1)


def _lib():
    fn = build.load("crop").gn_crop_fused
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
            + [ctypes.c_int] * 3
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _launch(xyz, new_xyz, rot, folded, radius, hmin, hmax_list, nsample, normalize, ball):
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    ndepth = 1 if ball else len(hmax_list)
    (w1, b1), (w2, b2), (w3, b3) = folded
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    if (
        xyz.dtype != torch.float32
        or new_xyz.shape != (b, m, 3)
        or (not ball and (rot is None or rot.shape != (b, m, 3, 3)))
        or w1.shape[0] != 3
        or not 1 <= nsample <= MAX_SAMPLES
        or not 1 <= ndepth <= MAX_DEPTHS
        or c1 % 4 or c2 % 4 or 256 % c2
    ):
        raise ValueError(
            "crop kernel takes float32 (B,N,3)/(B,M,3)/(B,M,3,3) inputs, a 3-layer "
            f"3->c1->c2->c3 MLP with c1, c2 multiples of 4 and c2 | 256, ns <= {MAX_SAMPLES}"
        )
    ts = [t.contiguous().float() for t in (xyz, new_xyz, w1, b1, w2, b2, w3, b3)]
    rot_t = None if ball else rot.contiguous()
    hmax = (ctypes.c_float * ndepth)(*([0.0] if ball else hmax_list))
    out = torch.empty((b, m, ndepth, c3), dtype=torch.float32, device=xyz.device)
    err = _lib()(
        ts[0].data_ptr(), ts[1].data_ptr(), 0 if rot_t is None else rot_t.data_ptr(),
        ts[2].data_ptr(), ts[3].data_ptr(), ts[4].data_ptr(), ts[5].data_ptr(),
        ts[6].data_ptr(), ts[7].data_ptr(), out.data_ptr(),
        b, n, m, nsample, int(ball),
        radius * radius, hmin, ctypes.cast(hmax, ctypes.c_void_p), ndepth, normalize,
        c1, c2, c3, torch.cuda.current_stream(xyz.device).cuda_stream,
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
    """Fused CloudCrop: (B, N, 3), (B, M, 3), (B, M, 3, 3) -> (B, M, D, C3)."""
    args = (xyz, new_xyz, rot, folded, radius, hmin, tuple(hmax_list), nsample, 1.0, False)
    if not xyz.is_cuda:
        return crop_fused_plain(*args)
    out = _launch(*args)
    crop_fused.launches += 1
    return out


def sa1_fused(
    xyz: torch.Tensor, new_xyz: torch.Tensor, folded: Folded, radius: float, nsample: int
) -> torch.Tensor:
    """Fused SA1 stage: ball query + group + /r + folded MLP + max,
    (B, N, 3), (B, M, 3) -> (B, M, C3)."""
    args = (xyz, new_xyz, None, folded, radius, 0.0, (0.0,), nsample, 1.0 / radius, True)
    if not xyz.is_cuda:
        return crop_fused_plain(*args)[:, :, 0]
    out = _launch(*args)
    sa1_fused.launches += 1
    return out[:, :, 0]


crop_fused.launches = 0
sa1_fused.launches = 0
