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
CPU.  An index outside [0, n) adds to no row, as in the JAX function: the
plan sends it to a row past the last, which no sum reads.

Both halves are kernels of `csrc/scatter.cu`: `scatter_plan` launches the
counting-sort plan kernel and `scatter_add_rows` the segment sum for a CUDA
tensor; each runs its plain version (`scatter_plan_plain`,
`scatter_add_rows_plain`) for a CPU tensor.  When the gathered tensor needs
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

__all__ = ["gather_rows", "scatter_add_rows", "scatter_add_rows_plain", "scatter_plan", "scatter_plan_plain",
           "three_interpolate"]

Plan = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# csrc/scatter.cu's plan schedule: warps a CTA, keys a CTA's chunk, and the
# most rows (B * n + 1) whose per-warp counts it keeps in shared memory
PLAN_WARPS, PLAN_CHUNK, PLAN_SMEM_ROWS = 8, 1024, 6144
PLAN_ORDERS = 3  # the work order's groups: long, short and empty segments
SUM_LONG = 32  # a long segment: at least one round of the sum kernel's loads
INT32_LIMIT = 2**31 - 1  # perm and starts are int32: B * K and B * n + 1 stay below 2^31


def _keys(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, K) indices -> the flattened output row b * n + idx of each, and
    B * n (the row past the last) for an index outside [0, n)."""
    b = idx.shape[0]
    keys = idx + n * torch.arange(b, device=idx.device)[:, None]
    return torch.where((idx >= 0) & (idx < n), keys, b * n).reshape(-1)


def scatter_add_rows_plain(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, K, C), (B, K) indices -> (B, n, C): out[b, j] = the sum of g[b, k]
    over {k : idx[b, k] == j}; an index outside [0, n) adds to no row.  On
    the CPU `index_add_` adds in ascending k, starting from zero."""
    b, k, c = g.shape
    out = torch.zeros((b * n + 1, c), dtype=g.dtype, device=g.device)
    out.index_add_(0, _keys(idx, n), g.reshape(b * k, c))
    return out[: b * n].reshape(b, n, c)


def _check_plan_size(b: int, k: int, n: int) -> None:
    if b * k > INT32_LIMIT or b * n + 1 > INT32_LIMIT:
        raise ValueError(f"scatter plan takes B * K and B * n + 1 below 2^31 (int32), got B={b}, K={k}, n={n}")


def scatter_plan_plain(idx: torch.Tensor, n: int) -> Plan:
    """(B, K) indices -> (perm, starts, order), all int32: the flattened
    source rows in stable order of their output row b * n + idx (an index
    outside [0, n) sorts last, as row B * n); the (B * n + 1) segment
    bounds, so starts[B * n] counts the indices in range; and the sum's work
    order of the B * n output rows: the segments of SUM_LONG sources or
    more, then the other non-empty ones, then the empty ones, each group in
    ascending row."""
    b, k = idx.shape
    _check_plan_size(b, k, n)
    sorted_keys, perm = torch.sort(_keys(idx, n), stable=True)
    bounds = torch.arange(b * n + 1, device=idx.device, dtype=sorted_keys.dtype)
    starts = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    lengths = starts[1:] - starts[:-1]
    group = torch.where(lengths >= SUM_LONG, 0, torch.where(lengths > 0, 1, 2))
    order = torch.sort(group, stable=True)[1]
    return perm.to(torch.int32), starts, order.to(torch.int32)


_PLAN_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_void_p)
_SUM_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)


def _fn(name: str, argtypes: tuple):
    from graspnet_tpu_torch.ops.cuda import build  # at launch: the kernel package imports this module

    fn = getattr(build.load("scatter"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def scatter_plan(idx: torch.Tensor, n: int) -> Plan:
    """(B, K) int64 indices -> `scatter_plan_plain(idx, n)`.  CUDA tensor:
    one launch of the counting-sort plan kernel, whose perm, starts and
    order are bitwise the plain version's.  CPU tensor: `scatter_plan_plain`.
    Parameter-independent: a gather computes it once in its forward for the
    backward."""
    if not idx.is_cuda:
        return scatter_plan_plain(idx, n)
    if idx.dim() != 2 or idx.dtype != torch.int64:
        raise ValueError(f"scatter_plan takes (B, K) int64 indices, got {tuple(idx.shape)} {idx.dtype}")
    b, k = idx.shape
    _check_plan_size(b, k, n)
    rows = b * n + 1
    ctas = max(1, -(-b * k // PLAN_CHUNK))  # the kernel's grid takes at most this many
    scratch = ctas * rows + 2 * rows + (1 + PLAN_ORDERS) * ctas + (ctas * (PLAN_WARPS + 1) * rows
                                                                   if rows > PLAN_SMEM_ROWS else 0)
    buf = torch.empty(b * k + 2 * rows - 1 + scratch, dtype=torch.int32, device=idx.device)
    idx = idx.contiguous()
    from graspnet_tpu_torch.ops.cuda import build  # at launch: the kernel package imports this module

    fn = _fn("gn_scatter_plan", _PLAN_ARGS)
    with build.on_device(idx.device) as stream:
        err = fn(idx.data_ptr(), b, k, n, buf.data_ptr(), scratch, stream)
    build.check(err, "scatter_plan")
    build.count_launch(scatter_plan)
    return buf[: b * k], buf[b * k: b * k + rows], buf[b * k + rows: b * k + 2 * rows - 1]


scatter_plan.launches = 0


def scatter_add_rows(g: torch.Tensor, idx: torch.Tensor, n: int, plan: Optional[Plan] = None) -> torch.Tensor:
    """(B, K, C) float32, (B, K) int64 -> (B, n, C), as
    `scatter_add_rows_plain`.

    CUDA tensor: one launch of the segment-sum kernel over `plan` (from
    `scatter_plan(idx, n)`; made here when not given), each row's sum in its
    segment's order; the plan's work order only schedules the rows.  CPU
    tensor: `scatter_add_rows_plain`."""
    if not g.is_cuda:
        return scatter_add_rows_plain(g, idx, n)
    b, k, c = g.shape
    if g.dtype != torch.float32 or idx.shape != (b, k) or idx.dtype != torch.int64:
        raise ValueError(f"scatter_add_rows takes (B, K, C) float32 and (B, K) int64, got "
                         f"{tuple(g.shape)} {g.dtype}, {tuple(idx.shape)} {idx.dtype}")
    perm, starts, order = plan if plan is not None else scatter_plan(idx, n)
    if perm.shape != (b * k,) or starts.shape != (b * n + 1,) or order.shape != (b * n,) \
            or {perm.dtype, starts.dtype, order.dtype} != {torch.int32}:
        raise ValueError(f"scatter plan {tuple(perm.shape)} {perm.dtype}, {tuple(starts.shape)} {starts.dtype}, "
                         f"{tuple(order.shape)} {order.dtype} does not fit B={b}, K={k}, n={n}")
    out = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    g = g.contiguous()
    from graspnet_tpu_torch.ops.cuda import build  # at launch: the kernel package imports this module

    fn = _fn("gn_scatter_add_rows", _SUM_ARGS)
    with build.on_device(g.device) as stream:
        err = fn(g.data_ptr(), perm.data_ptr(), starts.data_ptr(), order.data_ptr(), out.data_ptr(), b * n, c,
                 stream)
    build.check(err, "scatter_add_rows")
    build.count_launch(scatter_add_rows)
    return out


scatter_add_rows.launches = 0


def _take_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def _plan(points: torch.Tensor, idx: torch.Tensor):
    """The backward's sort of (B, K) indices into points' rows, made in the
    forward when points needs a gradient on the card; else nothing."""
    if points.is_cuda and points.requires_grad and torch.is_grad_enabled():
        return scatter_plan(idx, points.shape[1])
    return None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx, perm, starts, order):
        ctx.n = points.shape[1]
        ctx.save_for_backward(idx, perm, starts, order)
        return _take_rows(points, idx)

    @staticmethod
    def backward(ctx, g):
        idx, *plan = ctx.saved_tensors
        plan = None if plan[0] is None else tuple(plan)
        return scatter_add_rows(g.contiguous(), idx, ctx.n, plan), None, None, None, None


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
    def forward(ctx, features, idx, weight, perm, starts, order):
        b, n, _ = idx.shape
        gathered = _take_rows(features, idx.reshape(b, n * 3)).reshape(b, n, 3, features.shape[-1])
        ctx.save_for_backward(features, idx, weight, perm, starts, order)
        return _interpolate(gathered, weight)

    @staticmethod
    def backward(ctx, g):
        features, idx, weight, *plan = ctx.saved_tensors
        b, n, _ = idx.shape
        m, c = features.shape[1], features.shape[2]
        d_feat = d_weight = None
        if ctx.needs_input_grad[0]:
            # d_features[b, j] = sum over (i, k) with idx[b, i, k] == j of weight[b, i, k] * g[b, i]
            wg = weight[..., None] * g[:, :, None, :]
            plan = None if plan[0] is None else tuple(plan)
            d_feat = scatter_add_rows(wg.reshape(b, n * 3, c), idx.reshape(b, n * 3), m, plan)
        if ctx.needs_input_grad[2]:
            gathered = _take_rows(features, idx.reshape(b, n * 3)).reshape(b, n, 3, c)
            d_weight = torch.sum(gathered * g[:, :, None, :], dim=-1)
        return d_feat, None, d_weight, None, None, None


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, m, C), (B, n, 3) int64, (B, n, 3) -> (B, n, C): the weighted sum of
    the three neighbour rows, with the deterministic scatter-add as the
    features' backward."""
    b, n, _ = idx.shape
    return _ThreeInterpolate.apply(features, idx, weight, *_plan(features, idx.reshape(b, n * 3)))
