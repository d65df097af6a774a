"""Seeded synthetic scenes for the card's checks and timings."""

from __future__ import annotations

import numpy as np


def tabletop_cloud(rng: np.random.Generator, n: int = 20000) -> np.ndarray:
    """(n, 3) float32: a camera-frame tabletop, a plane at z=0.55 m with
    boxes and spheres standing on it, about 0.5 m from the camera; the
    points in a random order."""
    parts = []
    n_table = n * 2 // 5
    parts.append(np.stack([rng.uniform(-0.3, 0.3, n_table), rng.uniform(-0.3, 0.3, n_table),
                           0.55 + rng.normal(0, 0.001, n_table)], 1))
    n_obj = n - n_table
    per = n_obj // 6
    for k in range(6):
        cnt = per if k < 5 else n_obj - 5 * per
        cx, cy = rng.uniform(-0.2, 0.2, 2)
        if k % 2 == 0:  # box: points on its faces
            half = rng.uniform(0.02, 0.06, 3)
            p = rng.uniform(-1, 1, (cnt, 3))
            face = rng.integers(0, 3, cnt)
            p[np.arange(cnt), face] = np.sign(p[np.arange(cnt), face])
            p = p * half + [cx, cy, 0.55 - half[2]]
        else:  # sphere
            r = rng.uniform(0.02, 0.05)
            v = rng.normal(size=(cnt, 3))
            p = v / np.linalg.norm(v, axis=1, keepdims=True) * r + [cx, cy, 0.55 - r]
        parts.append(p)
    cloud = np.concatenate(parts, 0).astype(np.float32)
    return cloud[rng.permutation(len(cloud))]


def write_demo_frame(out_dir: str, rng: np.random.Generator, height: int = 48, width: int = 64) -> dict:
    """One synthetic RGB-D frame in the reference demo layout (color.png,
    16-bit mm depth.png, meta.mat with intrinsic_matrix and factor_depth,
    workspace_mask.png), plus a segmentation mask PNG over one box, an
    intrinsics txt and the frame's back-projected cloud as .npy: a table
    plane at 0.55 m with two boxes standing on it, seen by a camera whose
    focal length spans the 0.6 m table.  Returns the paths by name."""
    import os

    import scipy.io as scio
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    f = width / 0.6 * 0.55
    K = np.array([[f, 0.0, width / 2], [0.0, f, height / 2], [0.0, 0.0, 1.0]])
    depth_m = 0.55 + rng.normal(0, 0.0005, (height, width))
    mask = np.zeros((height, width), np.uint8)
    for k, (v0, u0) in enumerate(((0.25, 0.2), (0.55, 0.6))):
        rows = slice(int(v0 * height), int((v0 + 0.25) * height))
        cols = slice(int(u0 * width), int((u0 + 0.2) * width))
        depth_m[rows, cols] = 0.55 - rng.uniform(0.04, 0.08)
        if k == 0:
            mask[rows, cols] = 255
    depth_m[: height // 16] = 0.0  # a band of invalid pixels
    depth_mm = np.round(depth_m * 1000).astype(np.uint16)
    rgb = (rng.uniform(0, 1, (height, width, 3)) * 255).astype(np.uint8)
    workspace = np.zeros((height, width), np.uint8)
    workspace[:, width // 16: width - width // 16] = 255
    paths = {name: os.path.join(out_dir, name) for name in
             ("color.png", "depth.png", "meta.mat", "workspace_mask.png", "mask.png", "K.txt", "cloud.npy")}
    Image.fromarray(rgb).save(paths["color.png"])
    Image.fromarray(depth_mm).save(paths["depth.png"])
    scio.savemat(paths["meta.mat"], {"intrinsic_matrix": K, "factor_depth": np.array([[1000.0]])})
    Image.fromarray(workspace).save(paths["workspace_mask.png"])
    Image.fromarray(mask).save(paths["mask.png"])
    np.savetxt(paths["K.txt"], K.reshape(1, 9))
    v, u = np.nonzero(depth_mm)
    z = depth_mm[v, u] / 1000.0
    cloud = np.stack([(u - K[0, 2]) * z / K[0, 0], (v - K[1, 2]) * z / K[1, 1], z], 1).astype(np.float32)
    np.save(paths["cloud.npy"], cloud)
    return paths
