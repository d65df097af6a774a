"""3-NN search and 3-point interpolation (the FP stages' ops).

Counterpart of `graspnet_tpu/ops/knn.py`.  Distances use the explicit
dx*dx + dy*dy + dz*dz order; ties resolve to the lowest index
(first-occurrence argmin), as in the JAX package and the reference CUDA.
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


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Three nearest `known` points per `unknown` point.

    (B, n, 3), (B, m, 3) -> dist (B, n, 3) Euclidean, idx (B, n, 3) int64.
    Three first-occurrence argmin passes, masking each winner with +inf
    (`graspnet_tpu/ops/knn.py:54-95`).
    """
    d2 = _pairwise_d2(unknown, known)
    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        dists.append(torch.gather(d2, -1, i))
        idxs.append(i)
        d2 = d2.scatter(-1, i, float("inf"))
    return torch.sqrt(torch.cat(dists, dim=-1)), torch.cat(idxs, dim=-1)
