"""The host label library: ctypes wrappers of `csrc/host.cpp`.

Counterpart of `graspnet_tpu/native/__init__.py` for what the training data
path calls: the FPS seed chain (`fps`), the seed -> label point assignment
(`nearest`), the per-(label point, view) statistics
(`label_view_stats`, `label_view_stats_masked`) and the visibility test
(`visible_mask`).  The library builds with g++ at first use
(`ops/cuda/build.py`); a failed build raises, with no numpy fallback, so a
host-prep time always measures this code.  The numpy plain versions with
the same semantics are `train/label_pipeline.py::fps_numpy`, `nearest` and
`label_view_stats`, and `data/camera.py::visible_mask_plain`; the tests
hold each against its plain version and the JAX package's library.
ctypes releases the interpreter lock during a call, so loader threads run
these in parallel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from graspnet_tpu_torch.ops.cuda import build

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_ARGTYPES = {
    "gn_fps_grid": [_F32, ctypes.c_int, ctypes.c_int, _I32],
    "gn_nearest": [_F32, ctypes.c_int, _F32, ctypes.c_int, _I32],
    "gn_label_view_stats": [_F32, _F32, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                            ctypes.c_float, _F32, _U8, _F32],
    "gn_label_view_stats_masked": [_F32, ctypes.POINTER(ctypes.c_float), _U8, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                                   _F32, _U8, _F32],
    "gn_visible": [_F32, ctypes.c_int, _F32, ctypes.c_int, ctypes.c_float, _U8],
}


def _fn(name: str):
    fn = getattr(build.load(build.HOST), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = None
    return fn


def fps(xyz: np.ndarray, npoint: int) -> np.ndarray:
    """(N, 3) float32 -> (npoint,) int32 FPS indices: index 0 first, points
    with x*x+y*y+z*z <= 1e-3 never picked, ties to the lowest index (the
    grid-pruned exact scan, `host.cpp::gn_fps_grid`)."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or not 1 <= npoint <= len(xyz):
        raise ValueError(f"fps takes (N, 3) points and 1 <= npoint <= N, got {xyz.shape}, {npoint}")
    out = np.empty(npoint, dtype=np.int32)
    _fn("gn_fps_grid")(xyz, xyz.shape[0], npoint, out)
    return out


def nearest(query: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """(Nq, 3), (Nr, 3) -> (Nq,) int32 index of the nearest ref point
    (difference-form squared distance, first index on ties)."""
    query = np.ascontiguousarray(query, dtype=np.float32)
    ref = np.ascontiguousarray(ref, dtype=np.float32)
    if query.ndim != 2 or query.shape[1] != 3 or ref.ndim != 2 or ref.shape[1] != 3 or not len(ref):
        raise ValueError(f"nearest takes (Nq, 3) and (Nr >= 1, 3) points, got {query.shape}, {ref.shape}")
    out = np.empty(len(query), dtype=np.int32)
    _fn("gn_nearest")(query, len(query), ref, len(ref), out)
    return out


def _stats_shape(scores: np.ndarray):
    npo, v = scores.shape[0], scores.shape[1]
    ad = int(np.prod(scores.shape[2:], dtype=np.int64)) if scores.ndim > 2 else 1
    return npo, v, ad


def label_view_stats(scores: np.ndarray, widths: np.ndarray, max_width: float):
    """(Np, V, A, D) scores and widths -> lmin (Np, V) float32, the least
    score among (score > 0 and width <= max_width), +inf where none; has
    (Np, V) bool, whether one exists; vmax (Np, V) float32, the raw max."""
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    widths = np.ascontiguousarray(widths, dtype=np.float32)
    if widths.shape != scores.shape:
        raise ValueError(f"scores {scores.shape} and widths {widths.shape} differ")
    npo, v, ad = _stats_shape(scores)
    lmin = np.empty((npo, v), np.float32)
    has = np.empty((npo, v), np.uint8)
    vmax = np.empty((npo, v), np.float32)
    if npo:
        _fn("gn_label_view_stats")(scores.reshape(-1), widths.reshape(-1), npo, v, ad,
                                   np.float32(max_width), lmin, has, vmax)
    return lmin, has.astype(bool), vmax


def label_view_stats_masked(scores: np.ndarray, widths: np.ndarray, collision: np.ndarray, max_width: float):
    """`label_view_stats` of the collision-zeroed scores, without the zeroed
    copy: label_view_stats(where(collision, 0, scores), widths).  `widths`
    may be a uniformly strided view (the width channel offsets[..., 2] of
    a contiguous (Np, V, A, D, 3) offsets array)."""
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    collision = np.ascontiguousarray(collision).astype(np.uint8, copy=False)
    widths = np.asarray(widths, dtype=np.float32)
    if widths.shape != scores.shape or collision.size != scores.size:
        raise ValueError(f"scores {scores.shape}, widths {widths.shape}, collision {collision.shape} differ")
    npo, v, ad = _stats_shape(scores)
    lmin = np.empty((npo, v), np.float32)
    has = np.empty((npo, v), np.uint8)
    vmax = np.empty((npo, v), np.float32)
    if not npo:
        return lmin, has.astype(bool), vmax
    # the width element stride in floats, when every leading stride is that
    # stride times the row-major extents (contiguous: 1; offsets[..., 2]: 3)
    strides = np.array(widths.strides, np.int64) // 4
    wstride = int(strides[-1]) if widths.ndim else 1
    extent = wstride
    for dim in range(widths.ndim - 1, 0, -1):
        extent *= widths.shape[dim]
        if strides[dim - 1] != extent or wstride < 1:
            widths, wstride = np.ascontiguousarray(widths), 1
            break
    wptr = ctypes.cast(widths.ctypes.data, ctypes.POINTER(ctypes.c_float))
    _fn("gn_label_view_stats_masked")(scores.reshape(-1), wptr, collision.reshape(-1), npo, v, ad,
                                      np.int64(wstride), np.float32(max_width), lmin, has, vmax)
    return lmin, has.astype(bool), vmax


def visible_mask(cloud: np.ndarray, pts: np.ndarray, th: float) -> np.ndarray:
    """(N, 3) scene cloud, (M, 3) points -> (M,) bool: the nearest scene
    point lies closer than `th` (an exact grid-hash test)."""
    cloud = np.ascontiguousarray(cloud, dtype=np.float32)
    pts = np.ascontiguousarray(pts, dtype=np.float32)
    out = np.empty(len(pts), dtype=np.uint8)
    _fn("gn_visible")(cloud, len(cloud), pts, len(pts), np.float32(th), out)
    return out.astype(bool)
