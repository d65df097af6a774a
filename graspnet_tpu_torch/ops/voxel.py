"""Voxel-grid downsample of a raw capture on the card: the `csrc/voxel.cu`
kernel and its plain PyTorch version.

The host library's `native.voxel_downsample` (`csrc/host.cpp::
gn_voxel_downsample`, a copy of the JAX package's C++ source) is the
semantics both hold to, bitwise as a set of rows:

* the grid is anchored at the float minimum of each axis, taken in
  double and capped at 1e30 (the library's starting value), less half the
  voxel rounded to float32;
* a point's cell is floor((p - min_bound) / voxel) per axis in IEEE
  double, and the three cells pack 21 bits an axis into one key, so a far
  or sparse cloud merges cells exactly as the library does;
* a cell's centroid is (float)(sum / count), the sum taken in double over
  its points in ascending source order from 0.0.

Only the order of the rows is free: the library writes them in its hash
table's order; the kernel and the plain version here write them in the
order of each cell's first point, so the two are bitwise equal, rows and
order.  The coordinates must be finite (the library's integer conversion
of a non-finite cell is undefined).

`voxel_downsample` launches the kernel for a CUDA tensor and runs
`voxel_downsample_plain` for a CPU tensor; there is no other switch.  The
collision filter takes the kernel route when its device is the card
(`postproc/collision.py`), the library on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from graspnet_tpu_torch.ops.cuda import build

AXIS_BITS = 21  # cells an axis in a key: 2^21, masked (host.cpp's 2097152)
AXIS_MASK = (1 << AXIS_BITS) - 1
MIN_START = 1e30  # the library's starting minimum
MAX_POINTS = 1 << 28  # the kernel's int32 slots: its table holds 2 x the points, rounded up to a power of 2
# csrc/voxel.cu's most CTAs and the bits a pass of its stable radix sort of
# the cell ids takes: they size its per-CTA and per-digit scratch
MAX_CTAS, DIGIT_BITS = 256, 9


def _min_bound(pts: torch.Tensor, voxel32: float) -> torch.Tensor:
    """(3,) float64: the per-axis float minimum (NaN skipped), capped at
    MIN_START, less voxel / 2, each step rounded as the library rounds it."""
    low = torch.where(torch.isnan(pts), torch.inf, pts).amin(dim=0).double()
    return torch.clamp(low, max=MIN_START) - 0.5 * voxel32


def voxel_downsample_plain(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """(N, 3) float32 -> (K, 3) float32 centroids, one per occupied cell, in
    the order of each cell's first point (module docstring)."""
    pts = points.to(torch.float32)
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"voxel_downsample takes (N, 3) points, got {tuple(points.shape)}")
    n = pts.shape[0]
    if n == 0:
        return pts.new_zeros((0, 3))
    voxel32 = float(torch.tensor(voxel, dtype=torch.float32))
    p64 = pts.double()
    q = torch.floor((p64 - _min_bound(pts, voxel32)) / voxel32).to(torch.int64) & AXIS_MASK
    key = (q[:, 0] << (2 * AXIS_BITS)) | (q[:, 1] << AXIS_BITS) | q[:, 2]
    _, inverse = torch.unique(key, return_inverse=True)
    k = int(inverse.max()) + 1
    src = torch.arange(n, device=pts.device)
    first = torch.full((k,), n, dtype=torch.int64, device=pts.device).scatter_reduce_(0, inverse, src, "amin")
    rank = torch.empty_like(first)
    rank[torch.argsort(first)] = torch.arange(k, device=pts.device)
    cell = rank[inverse]
    # index_add_ on the CPU adds in ascending source index, from 0.0
    sums = torch.zeros((k, 3), dtype=torch.float64, device=pts.device).index_add_(0, cell, p64)
    counts = torch.bincount(cell, minlength=k).double()
    return (sums / counts[:, None]).to(torch.float32)


_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p)


def _table_slots(n: int) -> int:
    """The kernel's hash table: the library's size, 2n slots rounded up to a
    power of 2, at least 64 (load factor at most 1/2)."""
    cap = 64
    while cap < 2 * n:
        cap <<= 1
    return cap


def scratch_ints(n: int) -> int:
    """int32 words of the kernel's scratch for n points: the voxel count
    (int64), the table (keys int64, first point, cell id), each point's
    slot, two ping-pong (key, source) pairs of the sort, and the per-CTA
    and per-digit counts (csrc/voxel.cu, gn_voxel_downsample)."""
    cap = _table_slots(n)
    digits = 1 << DIGIT_BITS
    return 2 + 4 * cap + 5 * n + 5 * MAX_CTAS + digits * MAX_CTAS + digits


def voxel_downsample(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """(N, 3) float32 -> `voxel_downsample_plain(points, voxel)`, bitwise.
    CUDA tensor: one cooperative launch of the `csrc/voxel.cu` kernel, then
    one 8-byte read of the cell count K (the caller's stream waits for the
    kernel there); the (K, 3) result stays on the card.  CPU tensor:
    `voxel_downsample_plain`."""
    if not points.is_cuda:
        return voxel_downsample_plain(points, voxel)
    if points.dim() != 2 or points.shape[1] != 3 or points.dtype != torch.float32:
        raise ValueError(f"voxel_downsample takes (N, 3) float32 points, got {tuple(points.shape)} {points.dtype}")
    n = points.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"voxel_downsample takes at most {MAX_POINTS} points, got {n}")
    if n == 0:
        return points.new_zeros((0, 3))
    points = points.contiguous()
    scratch = torch.empty(scratch_ints(n), dtype=torch.int32, device=points.device)
    out = torch.empty((n, 3), dtype=torch.float32, device=points.device)
    fn = getattr(build.load("voxel"), "gn_voxel_downsample")
    if fn.argtypes is None:
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
    with build.on_device(points.device) as stream:
        err = fn(points.data_ptr(), n, float(voxel), scratch.data_ptr(), scratch.numel(), out.data_ptr(), stream)
    build.check(err, "voxel_downsample")
    build.count_launch(voxel_downsample)
    k = int(scratch[:2].view(torch.int64).item())
    return out[:k]


voxel_downsample.launches = 0
