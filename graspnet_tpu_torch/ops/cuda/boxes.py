"""The empty-box count (`csrc/boxes.cu`) and its plain version.

No TPU counterpart: the JAX package has no box post-processing.
`postproc/boxes.py::parse_predictions` calls `count_in_boxes` once a
batch, for VoteNet's 8 scans x 256 boxes x 40,000 points and
Group-Free-3D's 8 x 512 x 50,000.  `points_in_boxes` is the same count in
plain torch (every point against every box as bool masks, in chunks); the
CPU takes it.

On the card `count_in_boxes` launches `box_count_kernel` once, after a
fill that zeroes its output: integer counts, bitwise the plain version's
(see the note in the source).  The library is built and loaded at the
first call on the card, so a process that never runs a detector never builds or loads it
(`build.LAZY`).  A CUDA tensor outside the kernel's domain raises
ValueError; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from graspnet_tpu_torch.ops.cuda import build

CHUNK_ELEMS = 1 << 27  # box x point tests a chunk of the plain count (bounds its bool temporaries)
LIBRARY = "boxes"
TILE = 64  # boxes a block: kTile of csrc/boxes.cu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def points_in_boxes(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points, (B, P, 3) corners -> (B, P) int64 counts of the
    points with lo <= p <= hi on every axis."""
    b, n, _ = points.shape
    chunk = max(1, CHUNK_ELEMS // max(1, b * n))
    x, y, z = (points[:, None, :, k] for k in range(3))
    counts = []
    for p0 in range(0, lo.shape[1], chunk):
        l, h = lo[:, p0: p0 + chunk, :, None], hi[:, p0: p0 + chunk, :, None]
        inside = (x >= l[:, :, 0]) & (x <= h[:, :, 0])
        inside &= (y >= l[:, :, 1]) & (y <= h[:, :, 1])
        inside &= (z >= l[:, :, 2]) & (z <= h[:, :, 2])
        counts.append(inside.sum(dim=-1))
    return torch.cat(counts, dim=1)


def count_in_boxes(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points (a view such as x[..., :3] of wider rows is read in
    place), (B, P, 3) lower and upper corners -> (B, P) int64 counts of the
    points with lo <= p <= hi on every axis; a NaN on either side is
    outside.  CUDA tensors: `box_count_kernel`; CPU tensors:
    `points_in_boxes`."""
    if not points.is_cuda:
        return points_in_boxes(points, lo, hi)
    ok = (
        all(t.dtype == torch.float32 and t.is_cuda and t.dim() == 3 and t.shape[-1] == 3
            and (t.numel() == 0 or t.stride(-1) == 1) for t in (points, lo, hi))
        and lo.shape == hi.shape
        and lo.shape[0] == points.shape[0]
        and points.device == lo.device == hi.device
        and points.shape[0] <= 65535
        and points.shape[1] < 2**31
        and lo.shape[1] <= 65535 * TILE
    )
    if not ok:
        raise ValueError("count_in_boxes takes float32 CUDA (B, N, 3) points and (B, P, 3) corners on one device, "
                         "each with unit stride along its last axis")
    b, n, _ = points.shape
    p = lo.shape[1]
    out = torch.zeros((b, p), dtype=torch.int64, device=points.device)
    if out.numel() == 0 or n == 0:
        return out
    fn = getattr(build.load(LIBRARY), "gn_box_count")
    if fn.argtypes is None:
        fn.argtypes = [_P, _L, _L, _P, _L, _L, _P, _L, _L, _I, _I, _I, _P, _P]
        fn.restype = ctypes.c_int
    with build.on_device(points.device) as stream:
        err = fn(points.data_ptr(), points.stride(0), points.stride(1), lo.data_ptr(), lo.stride(0), lo.stride(1),
                 hi.data_ptr(), hi.stride(0), hi.stride(1), b, n, p, out.data_ptr(), stream)
    build.check(err, "box count")
    build.count_launch(count_in_boxes)
    return out


count_in_boxes.launches = 0
