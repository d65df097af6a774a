"""Cascaded furthest point sampling: the `csrc/fps.cu` kernel and its plain
PyTorch version.

Counterpart of `graspnet_tpu/ops/pallas/fps.py` (`fps_chain_pallas` and its
single-stage case `fps_pallas`).  `fps_chain` launches the kernel for a CUDA
tensor and runs `fps_chain_plain` for a CPU tensor; there is no other switch.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from graspnet_tpu_torch.ops.cuda import build

NEAR_ORIGIN_SQ = 1e-3
INIT_DIST = 1e10
MAX_POINTS = 1024 * 24  # threads per block x points per thread in fps.cu
MAX_STAGES = 8


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


def _lib():
    lib = build.load("fps")
    fn = lib.gn_fps_chain
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def fps_chain(xyz: torch.Tensor, npoints: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Cascaded FPS: (B, N, 3) float32 -> one (B, npoint_k) int64 per stage.

    CUDA tensor: one launch of the fps.cu kernel for every stage.  CPU
    tensor: `fps_chain_plain`.
    """
    npoints = tuple(int(p) for p in npoints)
    if not xyz.is_cuda:
        return fps_chain_plain(xyz, npoints)
    b, n, three = xyz.shape
    if three != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"fps_chain takes (B, N, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    if n > MAX_POINTS or not 1 <= len(npoints) <= MAX_STAGES:
        raise ValueError(f"fps_chain supports N <= {MAX_POINTS} and 1..{MAX_STAGES} stages")
    prev = n
    for p in npoints:
        if not 1 <= p <= prev:
            raise ValueError(f"stage npoints {npoints} must shrink from N={n}")
        prev = p
    xyz = xyz.contiguous()
    out = torch.empty((b, sum(npoints)), dtype=torch.int64, device=xyz.device)
    stages = (ctypes.c_int * len(npoints))(*npoints)
    err = _lib()(
        xyz.data_ptr(), out.data_ptr(), b, n, ctypes.cast(stages, ctypes.c_void_p),
        len(npoints), torch.cuda.current_stream(xyz.device).cuda_stream,
    )
    build.check(err, "fps_chain")
    fps_chain.launches += 1
    offs = [0]
    for p in npoints:
        offs.append(offs[-1] + p)
    return tuple(out[:, offs[k] : offs[k + 1]] for k in range(len(npoints)))


fps_chain.launches = 0
