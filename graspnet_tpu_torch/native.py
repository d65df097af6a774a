"""The host label library: ctypes wrappers of `csrc/host.cpp`.

Counterpart of `graspnet_tpu/native/__init__.py`: for the training data
path the FPS seed chain (`fps`), the seed -> label point assignment
(`nearest`), the per-(label point, view) statistics
(`label_view_stats`, `label_view_stats_masked`) and the visibility test
(`visible_mask`); for the eval path the voxel downsample of raw clouds
(`voxel_downsample`), the greedy grasp NMS (`grasp_nms_fused`,
`greedy_suppress`) and the evaluator's uniform grid (`grid_build`).  The
library builds with g++ at first use (`ops/cuda/build.py`); a failed build
raises, with no numpy fallback, so a host time always measures this code.
The numpy plain versions with the same semantics are
`train/label_pipeline.py::fps_numpy`, `nearest` and `label_view_stats`,
`data/camera.py::visible_mask_plain`, `postproc/voxel.py`,
`postproc/nms.py::grasp_nms_plain` and `eval/ap.py::_SceneGrid`'s numpy
construction; the tests hold each against its plain version and the JAX
package's library.
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
_U64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_ARGTYPES = {
    "gn_fps_grid": [_F32, ctypes.c_int, ctypes.c_int, _I32],
    "gn_nearest": [_F32, ctypes.c_int, _F32, ctypes.c_int, _I32],
    "gn_label_view_stats": [_F32, _F32, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                            ctypes.c_float, _F32, _U8, _F32],
    "gn_label_view_stats_masked": [_F32, ctypes.POINTER(ctypes.c_float), _U8, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                                   _F32, _U8, _F32],
    "gn_visible": [_F32, ctypes.c_int, _F32, ctypes.c_int, ctypes.c_float, _U8],
    "gn_voxel_downsample": [_F32, ctypes.c_int64, ctypes.c_float, _F32],
    "gn_greedy_suppress": [_U8, _I32, ctypes.c_int, _I32],
    "gn_grasp_nms": [_F32, _F32, _I32, ctypes.c_int, ctypes.c_float, ctypes.c_float, _I32],
    "gn_grid_build": [_F32, ctypes.c_int64, ctypes.c_double, _I32, _U64, _I64, _F64, _I64],
}
_RESTYPES = {"gn_voxel_downsample": ctypes.c_int, "gn_greedy_suppress": ctypes.c_int,
             "gn_grasp_nms": ctypes.c_int, "gn_grid_build": ctypes.c_int64}


def _fn(name: str):
    fn = getattr(build.load(build.HOST), name)
    if fn.argtypes is None:
        fn.restype = _RESTYPES.get(name)
        fn.argtypes = _ARGTYPES[name]
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


def voxel_downsample(pts: np.ndarray, voxel: float) -> np.ndarray:
    """(N, 3) -> (K, 3) float32 voxel centroids, in no particular order
    (`postproc/voxel.py::voxel_down_sample`'s cells and means, the grid
    anchored at the minimum less voxel / 2 with voxel rounded to float32)."""
    pts = np.ascontiguousarray(pts, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"voxel_downsample takes (N, 3) points, got {pts.shape}")
    out = np.empty_like(pts)
    k = _fn("gn_voxel_downsample")(pts, len(pts), np.float32(voxel), out)
    return out[:k].copy()


def greedy_suppress(close: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Greedy NMS pass: an (M, M) bool close matrix and the visit order ->
    the kept indices (int64), in visit order."""
    m = len(order)
    close = np.ascontiguousarray(close, dtype=np.uint8)
    order = np.ascontiguousarray(order, dtype=np.int32)
    if close.shape != (m, m):
        raise ValueError(f"greedy_suppress takes an ({m}, {m}) matrix, got {close.shape}")
    keep = np.empty(m, dtype=np.int32)
    nk = _fn("gn_greedy_suppress")(close.reshape(-1), order, m, keep)
    return keep[:nk].astype(np.int64)


def grasp_nms_fused(t: np.ndarray, r: np.ndarray, order: np.ndarray, tt2: float, cos_rt: float) -> np.ndarray:
    """Greedy grasp NMS with the predicate evaluated for kept rows only:
    (M, 3) translations, (M, 9) row-major rotations, the visit order,
    squared translation threshold, cos(rotation threshold) -> the kept
    indices (int64), in visit order.  j is suppressed by a kept i when
    |t_i - t_j|^2 < tt2 (difference form) and (<r_i, r_j> - 1) / 2 > cos_rt."""
    m = len(order)
    t = np.ascontiguousarray(t, dtype=np.float32)
    r = np.ascontiguousarray(r, dtype=np.float32)
    order = np.ascontiguousarray(order, dtype=np.int32)
    if t.shape != (m, 3) or r.shape != (m, 9):
        raise ValueError(f"grasp_nms_fused takes ({m}, 3) and ({m}, 9), got {t.shape}, {r.shape}")
    keep = np.empty(m, dtype=np.int32)
    nk = _fn("gn_grasp_nms")(t, r, order, m, np.float32(tt2), np.float32(cos_rt), keep)
    return keep[:nk].astype(np.int64)


def grid_build(pts: np.ndarray, cell: float):
    """Uniform-grid index over (N, 3) float32 points for
    `eval/ap.py::_SceneGrid`: (order, uniq_keys, starts, minb, dims), the
    point indices grouped by cell (ascending within a cell), the sorted
    unique packed cell keys (int64), the group offsets (ncells + 1), the
    float64 minimum and the grid's extents, byte-identical to the numpy
    argsort / unique construction.  None for a non-float32 input: the
    library quantizes float32 values in float64 as numpy does, and a
    float64 input cast down first would move boundary points to other
    cells, so the caller takes its numpy construction then."""
    pts = np.asarray(pts)
    if pts.dtype != np.float32:
        return None
    pts = np.ascontiguousarray(pts)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"grid_build takes (N, 3) points, got {pts.shape}")
    n = len(pts)
    if n == 0:
        return (np.empty(0, np.int32), np.empty(0, np.uint64), np.zeros(1, np.int64),
                np.zeros(3, np.float64), np.zeros(3, np.int64))
    order = np.empty(n, np.int32)
    keys = np.empty(n, np.uint64)
    starts = np.empty(n + 1, np.int64)
    minb = np.empty(3, np.float64)
    dims = np.empty(3, np.int64)
    nc = _fn("gn_grid_build")(pts, n, float(cell), order, keys, starts, minb, dims)
    return order, keys[:nc].astype(np.int64), starts[: nc + 1].copy(), minb, dims
