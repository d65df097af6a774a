"""Furthest point sampling and index gathering.

Counterpart of `graspnet_tpu/ops/sampling.py`.  FPS runs through the
`ops/cuda/fps.py` wrapper: the CUDA kernel for a CUDA tensor, its plain
version for a CPU tensor.  `gather_points` is a row gather whose backward
is the deterministic scatter-add (`ops/scatter.py`), as the JAX
`custom_vjp` (`graspnet_tpu/ops/sampling.py:76-106`).
"""

from __future__ import annotations

import torch

from graspnet_tpu_torch.ops.cuda.fps import fps_chain
from graspnet_tpu_torch.ops.scatter import gather_rows


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int64 FPS indices (one chain stage)."""
    return fps_chain(xyz, (npoint,))[0]


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M) -> (B, M, C): out[b, m] = points[b, idx[b, m]]."""
    return gather_rows(points, idx)
