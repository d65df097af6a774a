"""Grasp geometry (the view lattice, approach and angle to rotation, the
Huber loss): a frozen copy of the port's `models/geometry.py`.
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


def batch_viewpoint_params_to_matrix_np(towards: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Numpy twin for the host label pipeline, a line-for-line copy of
    `graspnet_tpu/models/geometry.py:74-95` (numpy's own norms, cross
    product and matmul), so host labels are bitwise the JAX package's."""
    x = np.asarray(towards, np.float32)
    angle = np.asarray(angle, np.float32)
    zeros = np.zeros_like(x[..., 0])
    ones = np.ones_like(x[..., 0])
    y = np.stack([-x[..., 1], x[..., 0], zeros], axis=-1)
    y_norm = np.linalg.norm(y, axis=-1, keepdims=True)
    y = np.where(y_norm == 0, np.array([0.0, 1.0, 0.0], np.float32), y)
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    y = y / np.linalg.norm(y, axis=-1, keepdims=True)
    z = np.cross(x, y)
    sin, cos = np.sin(angle), np.cos(angle)
    r1 = np.stack([ones, zeros, zeros, zeros, cos, -sin, zeros, sin, cos], axis=-1).reshape(*angle.shape, 3, 3)
    r2 = np.stack([x, y, z], axis=-1)
    return (r2 @ r1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def canonical_view_rotations_np(num_view: int) -> np.ndarray:
    """(V, 3, 3) zero-angle rotations of the -view approach directions."""
    views = generate_grasp_views_np(num_view)
    return batch_viewpoint_params_to_matrix_np(-views, np.zeros(num_view, np.float32))


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic**2 + delta * linear
