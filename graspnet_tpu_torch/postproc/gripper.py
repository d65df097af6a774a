"""Gripper-frame mesh generation for grasp visualization.

Open3d-free equivalent of graspnetAPI's `Grasp.to_open3d_geometry()` /
`GraspGroup.to_open3d_geometry_list()` (used by every reference demo's
`visualize_results`, e.g. image_demo.py:235): each grasp renders as a
two-finger gripper assembled from four boxes — left finger, right finger,
bottom plate, and approach tail — in the gripper frame (x = approach,
y = closing direction), transformed by the grasp rotation/translation.

Returns plain numpy (vertices, triangles, color) meshes so visualization
works without open3d; `to_open3d_geometry_list` converts them when open3d is
importable.

A copy of `graspnet_tpu/postproc/gripper.py` (numpy only; `open3d` stays a
lazy import).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# graspnetAPI gripper model constants (grasp.py plot_gripper_pro_max).
FINGER_WIDTH = 0.004
TAIL_LENGTH = 0.04
DEPTH_BASE = 0.02

_BOX_TRIANGLES = np.array(
    [
        [4, 7, 5], [4, 6, 7], [0, 2, 4], [2, 6, 4],
        [0, 1, 2], [1, 3, 2], [1, 5, 7], [1, 7, 3],
        [2, 3, 7], [2, 7, 6], [0, 4, 1], [1, 4, 5],
    ],
    dtype=np.int32,
)


def _box(dx: float, dy: float, dz: float, origin: np.ndarray) -> np.ndarray:
    """8 corners of an axis-aligned box with one corner at `origin`."""
    corners = np.array(
        [[x, y, z] for x in (0, dx) for y in (0, dy) for z in (0, dz)],
        dtype=np.float32,
    )
    return corners + origin


def gripper_mesh(
    center: np.ndarray,
    rotation: np.ndarray,
    width: float,
    depth: float,
    score: float = 1.0,
    height: float = 0.004,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mesh for one grasp: (vertices (32,3), triangles (48,3), rgb (3,)).

    Color encodes score as in graspnetAPI: red channel = score, green =
    1 - score (high-score grasps render red, low-score green).
    """
    w, d = float(width), float(depth)
    # gripper frame: x approach, y finger travel, z gripper height
    left = _box(
        d + DEPTH_BASE + FINGER_WIDTH,
        FINGER_WIDTH,
        height,
        np.array([-DEPTH_BASE - FINGER_WIDTH, -w / 2 - FINGER_WIDTH, -height / 2]),
    )
    right = _box(
        d + DEPTH_BASE + FINGER_WIDTH,
        FINGER_WIDTH,
        height,
        np.array([-DEPTH_BASE - FINGER_WIDTH, w / 2, -height / 2]),
    )
    bottom = _box(
        FINGER_WIDTH,
        w + 2 * FINGER_WIDTH,
        height,
        np.array([-DEPTH_BASE - FINGER_WIDTH, -w / 2 - FINGER_WIDTH, -height / 2]),
    )
    tail = _box(
        TAIL_LENGTH,
        FINGER_WIDTH,
        height,
        np.array(
            [-DEPTH_BASE - FINGER_WIDTH - TAIL_LENGTH, -FINGER_WIDTH / 2, -height / 2]
        ),
    )

    vertices = np.concatenate([left, right, bottom, tail], axis=0)
    triangles = np.concatenate(
        [_BOX_TRIANGLES + 8 * i for i in range(4)], axis=0
    )
    vertices = vertices @ np.asarray(rotation, np.float32).T + np.asarray(
        center, np.float32
    )
    s = float(np.clip(score, 0.0, 1.0))
    color = np.array([s, 1.0 - s, 0.0], dtype=np.float32)
    return vertices.astype(np.float32), triangles, color


def grasp_row_mesh(
    row: np.ndarray, color_score: float | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mesh for one 17-float grasp row.

    The render height is the stored grasp height / 5 with a 4 mm floor (the
    full 0.02 m gripper height occludes the scene).  `color_score` sets the
    position on the green→red ramp; None uses the row's raw score clamped to
    [0, 1] — group visualization passes a min-max-normalized value instead.
    """
    if color_score is None:
        color_score = float(np.clip(row[0], 0.0, 1.0))
    return gripper_mesh(
        center=row[13:16],
        rotation=row[4:13].reshape(3, 3),
        width=row[1],
        depth=row[3],
        score=color_score,
        height=max(float(row[2]) / 5.0, 0.004),
    )


def grasp_group_meshes(
    gg, normalize_scores: bool = True
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Meshes for every grasp in a GraspGroup.

    By default scores are min-max normalized to the [0,1] color ramp (like
    the reference demos' visualizer); pass normalize_scores=False for raw
    clamped scores — the convention `Grasp.mesh()` uses — when mixing
    per-grasp and group rendering of the same grasps.
    """
    arr = gg.grasp_group_array
    if len(arr) == 0:
        return []
    scores = arr[:, 0]
    if normalize_scores:
        lo, hi = float(scores.min()), float(scores.max())
        norm = (scores - lo) / (hi - lo) if hi > lo else np.ones_like(scores)
    else:
        norm = np.clip(scores, 0.0, 1.0)
    return [grasp_row_mesh(row, float(norm[i])) for i, row in enumerate(arr)]


def mesh_to_open3d(vertices: np.ndarray, triangles: np.ndarray, color: np.ndarray):
    """Convert one (vertices, triangles, rgb) mesh to an open3d TriangleMesh."""
    import open3d as o3d  # noqa: PLC0415 — optional dependency

    mesh = o3d.geometry.TriangleMesh()
    mesh.vertices = o3d.utility.Vector3dVector(vertices.astype(np.float64))
    mesh.triangles = o3d.utility.Vector3iVector(triangles)
    mesh.paint_uniform_color(color.astype(np.float64))
    return mesh


def to_open3d_geometry_list(gg):
    """graspnetAPI-compatible open3d TriangleMesh list (requires open3d)."""
    return [mesh_to_open3d(*m) for m in grasp_group_meshes(gg)]


def save_grasps_scene_ply(gg, scene_cloud, path: str) -> None:
    """One PLY with the gripper meshes AND the scene points (gray) — the
    offline stand-in for the reference demos' open3d top-K visualization
    (image_demo.py:235 et al.), viewable in any mesh viewer."""
    meshes = grasp_group_meshes(gg)
    if scene_cloud is not None and len(scene_cloud):
        pts = np.asarray(scene_cloud, np.float32)
        meshes = list(meshes) + [
            (pts, np.zeros((0, 3), np.int32), np.array([0.6, 0.6, 0.6], np.float32))
        ]
    save_meshes_ply(meshes, path)


def save_meshes_ply(meshes, path: str) -> None:
    """Write all gripper meshes into one ASCII PLY (viewable anywhere)."""
    all_v, all_t, all_c = [], [], []
    off = 0
    for vertices, triangles, color in meshes:
        all_v.append(vertices)
        all_t.append(triangles + off)
        all_c.append(np.tile((color * 255).astype(np.uint8), (len(vertices), 1)))
        off += len(vertices)
    v = np.concatenate(all_v) if all_v else np.zeros((0, 3), np.float32)
    t = np.concatenate(all_t) if all_t else np.zeros((0, 3), np.int32)
    c = np.concatenate(all_c) if all_c else np.zeros((0, 3), np.uint8)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element face {len(t)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        for p, rgb in zip(v, c):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {rgb[0]} {rgb[1]} {rgb[2]}\n")
        for tri in t:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
