"""Grasp geometry: the Fibonacci view lattice and approach + angle ->
rotation matrices.

Counterpart of `graspnet_tpu/models/geometry.py:22-71`.  The rotation is
written element by element in a fixed order, every product rounded on its
own, so the CPU and the card compute bitwise the same matrices and hence
the same cylinder masks.  XLA on the CPU contracts the norms and the cross
product into FMAs, so against the JAX package the entries agree to an ULP
or two.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def generate_grasp_views_np(n: int = 300, phi: float = (np.sqrt(5) - 1) / 2, r: float = 1.0) -> np.ndarray:
    """Fibonacci lattice on the unit sphere, computed in float64 then cast."""
    i = np.arange(n, dtype=np.float64)
    z = (2 * i + 1) / n - 1
    s = np.sqrt(1 - z**2)
    x = s * np.cos(2 * i * np.pi * phi)
    y = s * np.sin(2 * i * np.pi * phi)
    return (r * np.stack([x, y, z], axis=1)).astype(np.float32)


def generate_grasp_views(n: int = 300, device: torch.device | str = "cpu") -> torch.Tensor:
    """(n, 3) float32 view directions on `device`."""
    return torch.from_numpy(generate_grasp_views_np(n)).to(device)


def _norm3(v0, v1, v2):
    return torch.sqrt(v0 * v0 + v1 * v1 + v2 * v2)


def batch_viewpoint_params_to_matrix(towards: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Approach vectors (..., 3) + in-plane angles (...) -> (..., 3, 3).

    Columns are x = approach, y = horizontal perpendicular (y = (0, 1, 0)
    when the approach is vertical), z = x × y; then a roll about x.
    """
    x0, x1, x2 = towards.unbind(-1)
    zeros = torch.zeros_like(x0)
    y0, y1, y2 = -x1, x0, zeros
    degenerate = _norm3(y0, y1, y2) == 0
    y0 = torch.where(degenerate, zeros, y0)
    y1 = torch.where(degenerate, torch.ones_like(y1), y1)
    nx = _norm3(x0, x1, x2)
    x0, x1, x2 = x0 / nx, x1 / nx, x2 / nx
    ny = _norm3(y0, y1, y2)
    y0, y1, y2 = y0 / ny, y1 / ny, y2 / ny
    # z = x × y, jnp.cross's component formulas
    z0 = x1 * y2 - x2 * y1
    z1 = x2 * y0 - x0 * y2
    z2 = x0 * y1 - x1 * y0
    sin = torch.sin(angle)
    cos = torch.cos(angle)
    # [x y z] @ [[1, 0, 0], [0, cos, -sin], [0, sin, cos]]
    rows = []
    for a, b, c in ((x0, y0, z0), (x1, y1, z1), (x2, y2, z2)):
        rows.append(torch.stack([a, b * cos + c * sin, c * cos - b * sin], dim=-1))
    return torch.stack(rows, dim=-2)
