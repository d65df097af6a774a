"""Small rigid-transform helpers shared by the app layer.

A copy of `graspnet_tpu/utils/transforms.py` (numpy only).
"""

from __future__ import annotations

import numpy as np


def matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), Shepperd's method."""
    m = np.asarray(R, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w], dtype=np.float64)


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = np.asarray(q, dtype=np.float64)
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


def apply_rotation_offsets(pose: np.ndarray, offsets) -> np.ndarray:
    """Chain fixed rotation offsets onto a 4x4 grasp pose: R_final =
    R_raw · R(q1) · R(q2) · ..., translation untouched (reference
    demo.py:590-655 publish_modified_grasp_tf — the published
    `estimated_grasp` TF carries the offset-chained rotation).

    offsets: iterable of (x, y, z, w) quaternions.
    """
    out = np.array(pose, dtype=np.float64, copy=True)
    R = out[:3, :3]
    for q in offsets:
        R = R @ quaternion_to_matrix(q)
    out[:3, :3] = R
    return out


def compose_base_grasp(
    base_from_camera: np.ndarray, camera_grasp: np.ndarray
) -> np.ndarray:
    """Compose a camera-frame grasp pose into the robot base frame
    (reference grasp_base.py:27-57)."""
    return np.asarray(base_from_camera) @ np.asarray(camera_grasp)
