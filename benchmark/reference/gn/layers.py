"""Dense, BatchNorm and SharedMLP layers in eval and batch-statistics training
modes, and the running-statistics update: a frozen copy of the port's
`nn/layers.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn


class Dense(nn.Module):
    """x @ kernel (+ bias) on the trailing axis (a 1x1 convolution)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.kernel, self.bias, x)


def dense(kernel: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    w = kernel
    if w.shape[0] <= 4:
        # tiny contraction dim (the xyz -> C first layer): the same
        # broadcast-sum, in the same order, as the JAX package
        y = x[..., 0:1] * w[0]
        for i in range(1, w.shape[0]):
            y = y + x[..., i : i + 1] * w[i]
    else:
        y = torch.matmul(x, w)
    if bias is not None:
        y = y + bias
    return y


Stats = Dict[str, torch.Tensor]


class BatchNorm(nn.Module):
    """Batch norm over the trailing axis: `forward` normalizes with the
    running stats (eval), `forward_train` with the batch's."""

    group = None  # a torch.distributed process group: global-batch statistics

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.offset = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + self.eps)
        return (x - self.mean) * inv * self.scale + self.offset

    def forward_train(self, x: torch.Tensor) -> Tuple[torch.Tensor, Stats]:
        """Normalize with the batch mean and the biased batch variance over
        all axes but the last; return the output and {mean, unbiased var}
        (`graspnet_tpu/nn/layers.py:78-87`, same operation order).  The
        running buffers are not touched: `bn_update_running` folds the stats
        in after the step, and a pre-pass may throw them away."""
        axes = tuple(range(x.dim() - 1))
        n = 1
        for a in axes:
            n *= x.shape[a]
        if world_size(self.group) > 1:
            mean, var, n = _global_moments(x, axes, n, self.group)
        else:
            mean = torch.mean(x, dim=axes)
            var = torch.mean(torch.square(x - mean), dim=axes)
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.offset
        unbiased = n / max(n - 1, 1) if isinstance(n, int) else n / torch.clamp(n - 1, min=1)
        stats = {"mean": mean.detach(), "var": var.detach() * unbiased}
        return y, stats


def world_size(group) -> int:
    """Ranks in a process group; 1 for None (one process)."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group's ranks, differentiable: the backward
    sums each rank's cotangent, so every rank's gradient holds what its own
    rows contributed to every rank's loss."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def _global_moments(x: torch.Tensor, axes, n: int, group):
    """Mean and biased variance over the rows of every rank, in the JAX
    two-pass order (`graspnet_tpu/nn/layers.py:83-87`): the summed rows and
    the row count for the mean, then the summed squared deviations from
    the global mean.  Returns (mean, var, the global row count as a
    tensor: reading it on the host would sync the card at every layer)."""
    count = torch.full((1,), float(n), dtype=x.dtype, device=x.device)
    total = all_reduce_sum(torch.cat([torch.sum(x, dim=axes), count]), group)
    n_global = total[-1].detach()  # exact in float32 below 2^24 rows
    mean = total[:-1] / n_global
    var = all_reduce_sum(torch.sum(torch.square(x - mean), dim=axes), group) / n_global
    return mean, var, n_global


def set_process_group(module: nn.Module, group) -> None:
    """Give every BatchNorm (and every module that declares a `group`
    attribute, like the CloudCrop, whose kernel choice depends on it) in
    `module` the process group; None restores one-process statistics."""
    for m in module.modules():
        if hasattr(type(m), "group"):
            m.group = group


class MLPLayer(nn.Module):
    """dense (no bias) -> bn -> relu."""

    def __init__(self, in_dim: int, out_dim: int, eps: float = 1e-5):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bn = BatchNorm(out_dim, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(dense(self.kernel, None, x)))

    def forward_train(self, x: torch.Tensor) -> Tuple[torch.Tensor, Stats]:
        y, stats = self.bn.forward_train(dense(self.kernel, None, x))
        return torch.relu(y), stats


class SharedMLP(nn.ModuleList):
    """Stack of [dense -> bn -> relu] layers."""

    def __init__(self, dims: Sequence[int], eps: float = 1e-5):
        super().__init__(
            [MLPLayer(dims[i], dims[i + 1], eps) for i in range(len(dims) - 1)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x)
        return x

    def forward_train(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[Stats]]:
        """Batch-stats forward: (y, per-layer {mean, unbiased var})."""
        stats = []
        for layer in self:
            x, st = layer.forward_train(x)
            stats.append(st)
        return x, stats


def bn_update_running(bn: BatchNorm, stats: Optional[Stats], momentum: float) -> None:
    """running <- (1 - m) * running + m * batch (torch convention,
    `graspnet_tpu/nn/layers.py:93-98`), in place on the buffers and under
    no_grad: the JAX package returns a new pytree, the port updates the
    module it trains.  The momentum is rounded to float32 first, as the JAX
    step receives it."""
    if stats is None:
        return
    m = torch.tensor(momentum, dtype=torch.float32, device=bn.mean.device)
    with torch.no_grad():
        bn.mean.copy_((1.0 - m) * bn.mean + m * stats["mean"])
        bn.var.copy_((1.0 - m) * bn.var + m * stats["var"])


def shared_mlp_update_stats(mlp: SharedMLP, stats: Sequence[Optional[Stats]], momentum: float) -> None:
    """`bn_update_running` for every layer of a SharedMLP, in place."""
    for layer, st in zip(mlp, stats):
        bn_update_running(layer.bn, st, momentum)


def fold_bn_eval(mlp: SharedMLP) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Fold eval-mode BatchNorm into the dense weights.

    relu(bn(x @ W)) == relu(x @ (W * s) + (offset - mean * s)),
    s = scale / sqrt(var + eps) (`graspnet_tpu/ops/pallas/crop.py:42-61`).
    Returns [(W', b'), ...] with W' (in, out) and b' (out,).
    """
    folded = []
    for layer in mlp:
        bn = layer.bn
        s = bn.scale * torch.rsqrt(bn.var + bn.eps)
        folded.append((layer.kernel * s[None, :], bn.offset - bn.mean * s))
    return folded


def folded_mlp(folded, x: torch.Tensor) -> torch.Tensor:
    """relu(x @ W' + b') per folded layer (the K <= 4 layer as broadcast-sum)."""
    for w, b in folded:
        x = torch.relu(dense(w, b, x))
    return x
