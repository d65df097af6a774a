"""Capture inspection utilities.

Equivalents of the reference's small helper scripts: `segment_npz.py`
(merge a segmentation PNG into an rgbd .npz capture, segment_npz.py:1-19)
and `depth.py` / `opencv.py` (16-bit depth PNG -> human-viewable image).
All numpy/PIL, no cv2 dependency.
"""

from __future__ import annotations

import numpy as np


def colorize_depth(
    depth: np.ndarray, d_min: float | None = None, d_max: float | None = None
) -> np.ndarray:
    """Map a depth image (any units) to an (H, W, 3) uint8 turbo-like ramp.

    Zero-depth (invalid) pixels render black; the rest normalize over
    [d_min, d_max] (defaults: nonzero min/max of the frame).
    """
    depth = np.asarray(depth, np.float32)
    valid = depth > 0
    if not valid.any():
        return np.zeros((*depth.shape, 3), np.uint8)
    lo = float(depth[valid].min()) if d_min is None else d_min
    hi = float(depth[valid].max()) if d_max is None else d_max
    t = np.clip((depth - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    # compact 4-stop ramp: dark blue -> cyan -> yellow -> red
    stops = np.array(
        [[13, 8, 135], [5, 196, 209], [245, 221, 32], [214, 39, 40]], np.float32
    )
    seg = np.clip(t * 3.0, 0.0, 3.0 - 1e-6)
    i = seg.astype(np.int32)
    f = (seg - i)[..., None]
    rgb = stops[i] * (1 - f) + stops[i + 1] * f
    rgb[~valid] = 0
    return rgb.astype(np.uint8)


def save_depth_png(depth: np.ndarray, path: str, **kw) -> None:
    """Write the colorized depth image to a PNG."""
    from PIL import Image

    Image.fromarray(colorize_depth(depth, **kw)).save(path)


def merge_segmap_into_npz(npz_path: str, segmap_path: str, out_path: str) -> dict:
    """Add a segmentation map to an rgbd capture .npz (reference
    segment_npz.py:1-19): validates the segmap matches the depth shape and
    writes rgb/depth/K/segmap."""
    from PIL import Image

    data = dict(np.load(npz_path))
    segmap = np.array(Image.open(segmap_path))
    if segmap.ndim == 3:
        segmap = segmap[..., 0]
    if segmap.shape != data["depth"].shape:
        raise ValueError(
            f"segmentation map shape {segmap.shape} does not match depth "
            f"{data['depth'].shape}"
        )
    data["segmap"] = segmap
    np.savez(out_path, **data)
    return data
