"""General kNN, 3-NN search and 3-point interpolation (the FP stages' ops).

Counterpart of `graspnet_tpu/ops/knn.py`.  Distances use the explicit
dx*dx + dy*dy + dz*dz order; ties resolve to the lowest index
(first-occurrence argmin, or a stable sort), as in the JAX package and the
reference CUDA.  `knn` is plain torch: no path of the package calls it.
"""

from __future__ import annotations

from typing import Tuple

import torch

# the weighted sum of three neighbour rows, with the deterministic
# scatter-add as its backward (`graspnet_tpu/ops/knn.py:98-138`)
from graspnet_tpu_torch.ops.scatter import three_interpolate


def _pairwise_d2(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, nq, 3), (B, nr, 3) -> (B, nq, nr) squared distances."""
    dx = query[:, :, None, 0] - ref[:, None, :, 0]
    dy = query[:, :, None, 1] - ref[:, None, :, 1]
    dz = query[:, :, None, 2] - ref[:, None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _iter_min_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row by k first-occurrence argmin passes,
    masking each winner with +inf (`graspnet_tpu/ops/knn.py:54-71`)."""
    dists, idxs = [], []
    for _ in range(k):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        dists.append(torch.gather(d2, -1, i))
        idxs.append(i)
        d2 = d2.scatter(-1, i, float("inf"))
    return torch.cat(dists, dim=-1), torch.cat(idxs, dim=-1)


def knn(ref: torch.Tensor, query: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k nearest `ref` points of each query point.

    (B, Nr, 3), (B, Nq, 3) -> (B, Nq, k) int64, ascending by distance, the
    earliest index first among equal distances (`graspnet_tpu/ops/knn.py:32-51`).
    k <= 4 takes the argmin passes; above, a stable sort of the distances
    stands for `lax.top_k`, which also puts the earliest index first
    (`torch.topk` does not promise that order).
    """
    d2 = _pairwise_d2(query, ref)
    if k <= 4:
        return _iter_min_k(d2, k)[1]
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Three nearest `known` points per `unknown` point.

    (B, n, 3), (B, m, 3) -> dist (B, n, 3) Euclidean, idx (B, n, 3) int64
    (`graspnet_tpu/ops/knn.py:74-95`).
    """
    dist2, idx = _iter_min_k(_pairwise_d2(unknown, known), 3)
    return torch.sqrt(dist2), idx
