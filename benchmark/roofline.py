"""Operations and bytes of GraspNet's work from the configuration's shapes,
and the peaks of one NVIDIA H100 that they are held against.

A kernel's bound is the least time its work could take: the larger of its
bytes over the memory rate and its operations, each kind over its own
peak.  Membership tests and scans run at the float32 CUDA-core peak; MLP
products at the least time float32 accuracy allows, 3xTF32 on the tensor
cores (3 x operations / 495 TFLOP/s).  The arithmetic is a frozen copy of
`chip_smoke.py::bound`, its FPS count and its `mlp_train_flops`.

A model's FLOPs are its dense products, 2 x in x out a row of every layer
at the rows the configuration gives it; a training step counts the forward
and twice the forward for the backward.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
FPS_TEST_FLOPS = 9  # a distance and a min per point and step


def bound_s(nbytes: float, flops: float = 0.0, mlp_flops: float = 0.0) -> float:
    """The least time in seconds of work of `nbytes` bytes, `flops` scan
    operations and `mlp_flops` MLP products."""
    t_ops = flops / PEAK_F32_FLOPS + 3 * mlp_flops / PEAK_TF32_FLOPS
    return max(t_ops, nbytes / PEAK_BYTES)


def _mlp(widths, rows: int) -> int:
    """Products of a chain of dense layers of `widths` over `rows` rows."""
    return rows * sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def forward_flops(cfg, batch: int) -> int:
    """Dense products of one GraspNet forward of `batch` clouds."""
    f = 0
    for sa in (cfg.sa1, cfg.sa2, cfg.sa3, cfg.sa4):
        f += _mlp(sa.mlp, batch * sa.npoint * sa.nsample)
    f += _mlp(cfg.fp1_mlp, batch * cfg.sa3.npoint)
    f += _mlp(cfg.fp2_mlp, batch * cfg.sa2.npoint)
    seeds = batch * cfg.num_seed
    v2 = 2 + cfg.num_view
    f += _mlp((cfg.seed_feature_dim, cfg.seed_feature_dim, v2, v2), seeds)
    f += _mlp(cfg.crop_mlp, seeds * cfg.num_depth * cfg.crop_nsample)
    c, h = cfg.crop_mlp[-1], cfg.head_hidden
    rows = seeds * cfg.num_depth
    f += _mlp((c, h, h, 3 * cfg.num_angle), rows) + _mlp((c, h, h, cfg.num_angle), rows)
    return f


def train_step_flops(cfg, batch: int) -> int:
    """A training step's model FLOPs: the forward and a backward of twice it."""
    return 3 * forward_flops(cfg, batch)


def fps_bound_s(cfg, batch: int) -> float:
    """K1: the FPS cascade 20000 -> SA1 -> SA2 -> SA3 -> SA4 of `batch` clouds."""
    npoints = (cfg.sa1.npoint, cfg.sa2.npoint, cfg.sa3.npoint, cfg.sa4.npoint)
    flops, n = 0, cfg.num_point
    for p in npoints:
        flops += batch * (p - 1) * n * FPS_TEST_FLOPS
        n = p
    return bound_s(batch * cfg.num_point * 3 * 4 + batch * sum(npoints) * 8, flops)


def mlp_train_backward_flops(c1: int, c2: int, c3: int) -> int:
    """K7 backward products a row of the function: dW3, da2, dW2, da1 and
    dW1 (the grouped offsets take no gradient)."""
    l1, l2, l3 = 2 * 3 * c1, 2 * c1 * c2, 2 * c2 * c3
    return 2 * l3 + 2 * l2 + l1


def mlp_train_backward_bound_s(cfg, batch: int) -> float:
    """K7's backward in a training step of `batch` scenes: the crop MLP's
    gradients over every grouped row, its inputs read once (the grouped
    offsets and the pooled cotangent) and the weights read and their
    gradients written."""
    _, c1, c2, c3 = cfg.crop_mlp
    groups = batch * cfg.num_seed * cfg.num_depth
    rows = groups * cfg.crop_nsample
    wbytes = (3 * c1 + c1 * c2 + c2 * c3 + 2 * (c1 + c2 + c3)) * 4
    nbytes = (rows * 3 + groups * c3) * 4 + 2 * wbytes
    return bound_s(nbytes, mlp_flops=mlp_train_backward_flops(c1, c2, c3) * rows)
