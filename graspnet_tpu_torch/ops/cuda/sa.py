"""The eval SA stage's generic path: the grouping and the products'
epilogues (`csrc/sa.cu`) around the same `torch.matmul` calls, and the plain
path they replace.

No TPU counterpart: the JAX package runs this path in XLA
(`graspnet_tpu/models/backbone.py:84-119`).  `sa_pool_plain` is the
backbone's generic eval path as plain torch: the gathers, the centre
subtraction, /r, the concat with the features, the BN-folded MLP and the max.
`sa_pool` gives bitwise the same floats on the card in fewer passes:

  * `sa_group` (`sa_group_kernel`) writes the grouped rows from K4's index
    scratch, or, where the first layer's contraction is <= 4 wide
    (`nn/layers.py::dense`'s broadcast-sum branch: VoteNet's SA1, 3 + 1 ->
    64), that layer's activations;
  * every product is `torch.matmul(x, w)` on the tensors the plain path
    gives it, so cuBLAS takes the same algorithm;
  * `sa_bias_relu` (`bias_relu_kernel`, in place) adds the bias and applies
    the ReLU after each product but the last, and after the last
    (`bias_relu_max_kernel`) also takes the max over the samples.

Each wrapper launches its kernel for a CUDA tensor and runs its plain version
(`sa_group_plain`, `sa_bias_relu_plain`) for a CPU tensor, and counts its
launches.  On the card a shape outside the kernels' domain raises ValueError.
Like the other eval kernels, the route carries no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from graspnet_tpu_torch.nn.layers import dense, folded_mlp
from graspnet_tpu_torch.ops.cuda import build
from graspnet_tpu_torch.ops.query import group_points

Layer = Tuple[torch.Tensor, torch.Tensor]
MAX_FUSED_K = 4  # kMaxFusedK of csrc/sa.cu: dense's broadcast-sum branch (w.shape[0] <= 4)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


def _fn(name: str, argtypes):
    fn = getattr(build.load("sa"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def sa_group_plain(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: Optional[torch.Tensor],
    idx: torch.Tensor,
    radius: Optional[float],
    layer: Optional[Layer] = None,
) -> torch.Tensor:
    """(B, N, 3), (B, M, 3), (B, N, C) | None, (B, M, S) int64 -> the
    grouped rows (B, M, S, 3 + C): xyz[idx] - centre, /r where `radius` is
    given, then the features at the same indices; with `layer` (w, b), the
    folded layer's relu(dense(w, b, rows)) instead."""
    grouped = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if radius is not None:
        grouped = grouped / radius
    if features is not None:
        grouped = torch.cat([grouped, group_points(features, idx)], dim=-1)
    if layer is None:
        return grouped
    return torch.relu(dense(layer[0], layer[1], grouped))


def sa_pool_plain(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: Optional[torch.Tensor],
    idx: torch.Tensor,
    folded: Sequence[Layer],
    radius: Optional[float],
) -> torch.Tensor:
    """An eval SA stage's generic path after its ball query, in plain torch:
    the grouped rows, the BN-folded MLP and the max over the samples ->
    (B, M, c_last)."""
    return torch.amax(folded_mlp(folded, sa_group_plain(xyz, new_xyz, features, idx, radius)), dim=2)


def sa_bias_relu_plain(y: torch.Tensor, bias: torch.Tensor, pool: bool = False) -> torch.Tensor:
    """relu(y + bias) over the trailing axis; with `pool`, the max of that
    over axis 2 of a (B, M, S, C) y -> (B, M, C)."""
    out = torch.relu(y + bias)
    return torch.amax(out, dim=2) if pool else out


def _f32(t: torch.Tensor, dims: int) -> bool:
    return t.dtype == torch.float32 and t.is_cuda and t.dim() == dims


def sa_group(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: torch.Tensor,
    idx: torch.Tensor,
    radius: Optional[float],
    layer: Optional[Layer] = None,
) -> torch.Tensor:
    """The grouped rows of an SA stage with features, (B, N, 3), (B, M, 3),
    (B, N, C), (B, M, S) int64 -> (B, M, S, 3 + C), or with a first layer
    (w (3 + C, c1), b (c1,)) of contraction 3 + C <= 4 its activations
    (B, M, S, c1).  CUDA tensor: `sa_group_kernel`; CPU tensor:
    `sa_group_plain`."""
    if not xyz.is_cuda:
        return sa_group_plain(xyz, new_xyz, features, idx, radius, layer)
    b, n = xyz.shape[:2]
    m, ns = idx.shape[1:] if idx.dim() == 3 else (0, 0)
    c_in = features.shape[-1] if features is not None else 0
    w, bias = (layer[0].detach().contiguous(), layer[1].detach().contiguous()) if layer is not None else (None, None)
    if (
        features is None
        or not (_f32(xyz, 3) and _f32(new_xyz, 3) and _f32(features, 3))
        or xyz.shape[-1] != 3
        or n < 1
        or new_xyz.shape != (b, m, 3)
        or features.shape[:2] != (b, n)
        or c_in < 1
        or idx.dtype != torch.int64
        or not idx.is_cuda
        or idx.shape[0] != b
        or ns < 1
        or (radius is not None and not radius > 0)
        or (w is not None and not (_f32(w, 2) and _f32(bias, 1) and w.shape[0] == 3 + c_in <= MAX_FUSED_K
                                   and w.shape[1] >= 1 and bias.shape == (w.shape[1],)))
    ):
        raise ValueError(
            "sa_group takes float32 CUDA (B,N>=1,3)/(B,M,3)/(B,N,C>=1) inputs, (B,M,S>=1) int64 indices, "
            f"r > 0 or None, and a first layer only of (3+C <= {MAX_FUSED_K}, c1) with a (c1,) bias"
        )
    xyz, new_xyz, idx = xyz.detach().contiguous(), new_xyz.detach().contiguous(), idx.contiguous()
    features = features.detach()
    if features.stride(-1) != 1:
        features = features.contiguous()
    width = 3 + c_in if w is None else w.shape[1]
    out = torch.empty((b, m, ns, width), dtype=torch.float32, device=xyz.device)
    # ATen's CUDA `x / r` by a Python float multiplies by 1/r rounded to float32 once
    # (tests/test_torch_port_cuda.py pins it at radii where the float32 division differs)
    inv = float(np.float32(1.0 / radius)) if radius is not None else 1.0
    fn = _fn("gn_sa_group", [_P, _P, _P, _P, _L, _L, _I, _L, _I, _I, _I, _I, _F, _P, _P, _I, _P, _P])
    with build.on_device(xyz.device) as stream:
        err = fn(
            idx.data_ptr(), xyz.data_ptr(), new_xyz.data_ptr(), features.data_ptr(), features.stride(0),
            features.stride(1), c_in, b, n, m, ns, int(radius is not None), inv,
            w.data_ptr() if w is not None else None, bias.data_ptr() if w is not None else None,
            width, out.data_ptr(), stream,
        )
    build.check(err, "sa_group")
    build.count_launch(sa_group)
    return out


def sa_bias_relu(y: torch.Tensor, bias: torch.Tensor, pool: bool = False) -> torch.Tensor:
    """relu(y + bias) over the trailing axis of a product's output y (...,
    C); with `pool`, of a (B, M, S, C) y, the max of that over the samples
    -> (B, M, C).  CUDA tensor: `bias_relu_kernel` in y's own memory (y is
    returned), or `bias_relu_max_kernel` into a new (B, M, C); CPU tensor:
    `sa_bias_relu_plain`."""
    if not y.is_cuda:
        return sa_bias_relu_plain(y, bias, pool)
    c = y.shape[-1] if y.dim() else 0
    if (
        y.dtype != torch.float32
        or not y.is_contiguous()
        or not (pool and y.dim() == 4 or not pool and y.dim() >= 1)
        or c < 1
        or not _f32(bias, 1)
        or bias.shape != (c,)
        or (pool and y.shape[2] < 1)
    ):
        raise ValueError("sa_bias_relu takes a contiguous float32 CUDA (..., C) product, (B, M, S>=1, C) "
                         "with pool, and a float32 CUDA (C,) bias")
    y, bias = y.detach(), bias.detach().contiguous()
    with build.on_device(y.device) as stream:
        if pool:
            b, m, ns, _ = y.shape
            out = torch.empty((b, m, c), dtype=torch.float32, device=y.device)
            err = _fn("gn_sa_bias_relu_max", [_P, _P, _P, _L, _I, _I, _P])(
                y.data_ptr(), bias.data_ptr(), out.data_ptr(), b * m, ns, c, stream)
        else:
            out = y
            err = _fn("gn_sa_bias_relu", [_P, _P, _L, _I, _P])(y.data_ptr(), bias.data_ptr(), y.numel() // c, c,
                                                               stream)
    build.check(err, "sa_bias_relu")
    build.count_launch(sa_bias_relu)
    return out


def sa_pool(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: torch.Tensor,
    idx: torch.Tensor,
    folded: Sequence[Layer],
    radius: Optional[float],
) -> torch.Tensor:
    """An eval SA stage with features after its ball query, (B, N, 3),
    (B, M, 3), (B, N, C), (B, M, S) int64 and the BN-folded MLP ->
    (B, M, c_last).  CUDA tensor: `sa_group` (with the first layer where
    its contraction is <= 4), then per remaining layer `torch.matmul` and
    `sa_bias_relu` (pooling after the last), bitwise `sa_pool_plain`; CPU
    tensor: `sa_pool_plain`."""
    if not xyz.is_cuda:
        return sa_pool_plain(xyz, new_xyz, features, idx, folded, radius)
    first = folded[0] if folded and folded[0][0].shape[0] <= MAX_FUSED_K else None
    rest = folded[1:] if first is not None else folded
    if not rest:
        raise ValueError("sa_pool takes an MLP with a layer after its first where the first is <= "
                         f"{MAX_FUSED_K} wide, else at least one layer")
    x = sa_group(xyz, new_xyz, features, idx, radius, first)
    for i, (w, b) in enumerate(rest):
        x = sa_bias_relu(torch.matmul(x, w), b, pool=i == len(rest) - 1)
    return x


sa_group.launches = 0
sa_bias_relu.launches = 0
