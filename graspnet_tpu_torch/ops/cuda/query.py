"""First-ns ball query: the `csrc/query.cu` kernel and its plain version.

Counterpart of `graspnet_tpu/ops/pallas/query.py::ball_query_pallas`.
`ball_query` launches the kernel for a CUDA tensor and runs
`ball_query_plain` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from graspnet_tpu_torch.ops.cuda import build
from graspnet_tpu_torch.ops.query import CHUNK_ELEMS, ball_mask, select_first_hits


def ball_query_plain(
    xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int
) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, M, nsample) int64: the first nsample
    points with d2 < r*r in index order, first-hit padded
    (`graspnet_tpu/ops/query.py:91-128`)."""
    n = xyz.shape[1]
    chunk = max(1, CHUNK_ELEMS // max(1, n))
    out = [
        select_first_hits(ball_mask(xyz, new_xyz[:, m0 : m0 + chunk], radius), nsample)
        for m0 in range(0, new_xyz.shape[1], chunk)
    ]
    return torch.cat(out, dim=1)


def _lib():
    fn = build.load("query").gn_ball_query
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def ball_query(
    xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int
) -> torch.Tensor:
    """Indices of the first <= nsample points within `radius` of each center.

    (B, N, 3), (B, M, 3) float32 -> (B, M, nsample) int64.  CUDA tensor: the
    query.cu kernel; CPU tensor: `ball_query_plain`.
    """
    if not xyz.is_cuda:
        return ball_query_plain(xyz, new_xyz, radius, nsample)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if (
        xyz.dtype != torch.float32
        or new_xyz.dtype != torch.float32
        or xyz.shape[-1] != 3
        or new_xyz.shape != (b, m, 3)
        or not new_xyz.is_cuda
        or nsample < 1
    ):
        raise ValueError("ball_query takes (B, N, 3) and (B, M, 3) float32 CUDA tensors")
    xyz = xyz.contiguous()
    new_xyz = new_xyz.contiguous()
    out = torch.empty((b, m, nsample), dtype=torch.int64, device=xyz.device)
    # r*r rounded to float32 once, as the JAX package compares against it
    err = _lib()(
        xyz.data_ptr(), new_xyz.data_ptr(), out.data_ptr(), b, n, m,
        radius * radius, nsample, torch.cuda.current_stream(xyz.device).cuda_stream,
    )
    build.check(err, "ball_query")
    ball_query.launches += 1
    return out


ball_query.launches = 0
