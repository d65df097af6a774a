"""Deterministic row scatter-add and the differentiable row gathers whose
backward it is.

Counterpart of `graspnet_tpu/ops/scatter.py::scatter_add_rows`, which is
XLA (one-hot matmuls), not a Pallas kernel, and of the JAX package's
`custom_vjp` gathers that take it as their backward: `gather_points`
(`graspnet_tpu/ops/sampling.py:76`, backward `:100-103`), `group_points`
(`ops/query.py:196`, `:222-226`) and `three_interpolate` (`ops/knn.py:98`,
`:127-135`).  torch's own gather backward adds with float atomics on CUDA,
so colliding indices (the ball query's first-hit padding, shared three-NN
neighbours) sum in an order that changes from run to run.  Here the
indices are sorted once, stably (`scatter_plan`), and each output row sums
its segment in that order with the `csrc/scatter.cu` kernel: bitwise
repeatable, and bitwise the plain version's sequential `index_add_` on the
CPU.  `scatter_add_rows` launches the kernel for a CUDA tensor and runs
`scatter_add_rows_plain` for a CPU tensor.  When the gathered tensor needs
a gradient on the card, the gather's forward makes the plan and keeps it
for the backward.

The plain ops (`ops/query.py`, `ops/sampling.py`, `ops/knn.py`) import this
module and the kernel package imports the plain ops, so this module reaches
the kernel package's `build` at the first launch, not when it is imported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

__all__ = ["gather_rows", "scatter_add_rows", "scatter_add_rows_plain", "scatter_plan", "three_interpolate"]

Plan = Tuple[torch.Tensor, torch.Tensor]


def scatter_add_rows_plain(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, K, C), (B, K) indices in [0, n) -> (B, n, C): out[b, j] = the
    sum of g[b, k] over {k : idx[b, k] == j}.  On the CPU `index_add_` adds
    in ascending k, starting from zero."""
    b, k, c = g.shape
    rows = (idx + n * torch.arange(b, device=idx.device)[:, None]).reshape(b * k)
    out = torch.zeros((b * n, c), dtype=g.dtype, device=g.device)
    out.index_add_(0, rows, g.reshape(b * k, c))
    return out.reshape(b, n, c)


def scatter_plan(idx: torch.Tensor, n: int) -> Plan:
    """(B, K) indices in [0, n) -> (perm, starts): the flattened source rows
    in stable order of their output row b * n + idx, and the (B * n + 1)
    segment bounds.  Parameter-independent: a gather computes it once in
    its forward for the backward."""
    b, k = idx.shape
    keys = (idx + n * torch.arange(b, device=idx.device)[:, None]).reshape(b * k)
    sorted_keys, perm = torch.sort(keys, stable=True)
    bounds = torch.arange(b * n + 1, device=idx.device, dtype=sorted_keys.dtype)
    starts = torch.searchsorted(sorted_keys, bounds)
    return perm.contiguous(), starts.contiguous()


def _launch(g: torch.Tensor, perm: torch.Tensor, starts: torch.Tensor, out: torch.Tensor) -> None:
    from graspnet_tpu_torch.ops.cuda import build  # at launch: the kernel package imports this module

    fn = build.load("scatter").gn_scatter_add_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(g.data_ptr(), perm.data_ptr(), starts.data_ptr(), out.data_ptr(), out.shape[0] * out.shape[1],
             out.shape[2], torch.cuda.current_stream(g.device).cuda_stream)
    build.check(err, "scatter_add_rows")


def scatter_add_rows(g: torch.Tensor, idx: torch.Tensor, n: int, plan: Optional[Plan] = None) -> torch.Tensor:
    """(B, K, C) float32, (B, K) int64 in [0, n) -> (B, n, C).

    CUDA tensor: one launch of the segment-sum kernel over `plan` (from
    `scatter_plan(idx, n)`; computed here when not given).  CPU tensor:
    `scatter_add_rows_plain`."""
    if not g.is_cuda:
        return scatter_add_rows_plain(g, idx, n)
    b, k, c = g.shape
    if g.dtype != torch.float32 or idx.shape != (b, k) or idx.dtype != torch.int64:
        raise ValueError(f"scatter_add_rows takes (B, K, C) float32 and (B, K) int64, got "
                         f"{tuple(g.shape)} {g.dtype}, {tuple(idx.shape)} {idx.dtype}")
    perm, starts = plan if plan is not None else scatter_plan(idx, n)
    if perm.shape != (b * k,) or starts.shape != (b * n + 1,):
        raise ValueError(f"scatter plan {tuple(perm.shape)}, {tuple(starts.shape)} does not fit "
                         f"B={b}, K={k}, n={n}")
    out = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    _launch(g.contiguous(), perm, starts, out)
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0


def _take_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def _plan(points: torch.Tensor, idx: torch.Tensor):
    """The backward's sort of (B, K) indices into points' rows, made in the
    forward when points needs a gradient on the card; else nothing."""
    if points.is_cuda and points.requires_grad and torch.is_grad_enabled():
        return scatter_plan(idx, points.shape[1])
    return None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx, perm, starts):
        ctx.n = points.shape[1]
        ctx.save_for_backward(idx, perm, starts)
        return _take_rows(points, idx)

    @staticmethod
    def backward(ctx, g):
        idx, perm, starts = ctx.saved_tensors
        plan = None if perm is None else (perm, starts)
        return scatter_add_rows(g.contiguous(), idx, ctx.n, plan), None, None, None


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, K) int64 -> (B, K, C): out[b, k] = points[b, idx[b, k]],
    with the deterministic scatter-add as its backward."""
    return _GatherRows.apply(points, idx, *_plan(points, idx))


def _interpolate(gathered: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, n, 3, C), (B, n, 3) -> (B, n, C), summed in neighbour order."""
    w = weight[..., None]
    return gathered[:, :, 0] * w[:, :, 0] + gathered[:, :, 1] * w[:, :, 1] + gathered[:, :, 2] * w[:, :, 2]


class _ThreeInterpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, idx, weight, perm, starts):
        b, n, _ = idx.shape
        gathered = _take_rows(features, idx.reshape(b, n * 3)).reshape(b, n, 3, features.shape[-1])
        ctx.save_for_backward(features, idx, weight, perm, starts)
        return _interpolate(gathered, weight)

    @staticmethod
    def backward(ctx, g):
        features, idx, weight, perm, starts = ctx.saved_tensors
        b, n, _ = idx.shape
        m, c = features.shape[1], features.shape[2]
        d_feat = d_weight = None
        if ctx.needs_input_grad[0]:
            # d_features[b, j] = sum over (i, k) with idx[b, i, k] == j of weight[b, i, k] * g[b, i]
            wg = weight[..., None] * g[:, :, None, :]
            plan = None if perm is None else (perm, starts)
            d_feat = scatter_add_rows(wg.reshape(b, n * 3, c), idx.reshape(b, n * 3), m, plan)
        if ctx.needs_input_grad[2]:
            gathered = _take_rows(features, idx.reshape(b, n * 3)).reshape(b, n, 3, c)
            d_weight = torch.sum(gathered * g[:, :, None, :], dim=-1)
        return d_feat, None, d_weight, None, None


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, m, C), (B, n, 3) int64, (B, n, 3) -> (B, n, C): the weighted sum of
    the three neighbour rows, with the deterministic scatter-add as the
    features' backward."""
    b, n, _ = idx.shape
    return _ThreeInterpolate.apply(features, idx, weight, *_plan(features, idx.reshape(b, n * 3)))
