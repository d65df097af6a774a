"""Dense / BatchNorm / SharedMLP modules (eval branch).

Counterpart of `graspnet_tpu/nn/layers.py`.  Parameter names mirror the JAX
params pytree (`kernel`, `bias`, `bn.{scale,offset,mean,var}`), so a state
dict key is the pytree path joined by dots (see `checkpoint.params_from_jax`).
Tensors are channels-last, as in the JAX package: a dense layer acts on the
trailing axis, `x @ kernel + bias` with `kernel` shaped (in, out).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
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


class BatchNorm(nn.Module):
    """Eval-mode batch norm over the trailing axis, from running stats."""

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


class MLPLayer(nn.Module):
    """dense (no bias) -> bn -> relu."""

    def __init__(self, in_dim: int, out_dim: int, eps: float = 1e-5):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bn = BatchNorm(out_dim, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(dense(self.kernel, None, x)))


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
