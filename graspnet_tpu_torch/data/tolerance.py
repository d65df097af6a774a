"""Offline tolerance-label generation.

Counterpart of `graspnet_tpu/data/tolerance.py` (reference
dataset/generate_tolerance_label.py:81-95): for each label point p and each
(view, angle, depth) cell, the tolerance is the largest radius r in
{0, 1, ..., 50} mm such that among the label points within r of p, at least
`pos_ratio_thresh` have a positive friction score <= `mu_thresh`; the scan
over radii stops at the first radius where no cell of p passes.

The labels are exact, and equal the JAX function's bit for bit: the
distances are float32 `sqrt((dx*dx + dy*dy) + dz*dz)` with every product
rounded, as numpy's `linalg.norm` computes them there; the radii are
rounded to float32 once; the in-ball counts are a 0/1 product, exact in
float32 (and TF32) below 2^24 points; the ratio is one correctly rounded
float32 division on the CPU and the card alike.  Plain torch, no kernel
(the JAX package has none here either): per chunk of points the radii run
in turn, each a (C, P) @ (P, V*A*D) count product, so the (R, C, V*A*D)
intermediate of the JAX `vmap` never exists, and a chunk stops at the
first radius where none of its points has a passing cell left.
"""

from __future__ import annotations

import numpy as np
import torch

from graspnet_tpu_torch.device import resolve_device

RADIUS_LIST = [0.001 * x for x in range(51)]


def _distances(rows: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(C, 3), (P, 3) float32 -> (C, P) float32 Euclidean distances, each
    product and sum rounded in numpy's order."""
    d = rows[:, None, :] - points[None, :, :]
    sq = d * d
    return torch.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])


def _tolerance_chunk(dists: torch.Tensor, pos_flat: torch.Tensor, radii: torch.Tensor,
                     thresh: torch.Tensor) -> torch.Tensor:
    """(C, P) distances, (P, VAD) 0/1 positives -> (C, VAD) tolerances."""
    c = dists.shape[0]
    tol = torch.zeros((c, pos_flat.shape[1]), dtype=torch.float32, device=dists.device)
    alive = torch.ones((c, 1), dtype=torch.bool, device=dists.device)
    for r in radii:
        mask = (dists <= r).to(torch.float32)  # (C, P)
        cnt = torch.sum(mask, dim=1, keepdim=True)  # never 0: the point itself
        ok = ((mask @ pos_flat) / cnt >= thresh) & alive  # (C, VAD)
        alive = alive & torch.any(ok, dim=1, keepdim=True)
        tol = torch.where(ok, r, tol)  # radii ascend: the last pass is the largest
        if not bool(alive.any()):
            break
    return tol


def generate_tolerance(
    points: np.ndarray,
    scores: np.ndarray,
    pos_ratio_thresh: float = 0.8,
    mu_thresh: float = 0.55,
    chunk: int = 256,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """(P, 3) points + (P, V, A, D) scores -> (P, V, A, D) float32 tolerance
    labels, computed on `device` (the card unless the caller asks for the
    CPU), `chunk` points at a time."""
    dev = resolve_device(device, "generate_tolerance")
    p = len(points)
    v, a, d = scores.shape[1:]
    pts = torch.as_tensor(np.asarray(points, np.float32)).to(dev)
    s = torch.as_tensor(np.asarray(scores, np.float32)).to(dev)
    pos_flat = ((s > 0) & (s <= torch.tensor(mu_thresh, dtype=torch.float32))).to(torch.float32).reshape(p, -1)
    del s
    radii = torch.tensor(RADIUS_LIST, dtype=torch.float32, device=dev)
    thresh = torch.tensor(pos_ratio_thresh, dtype=torch.float32, device=dev)
    out = torch.empty((p, v * a * d), dtype=torch.float32, device=dev)
    for i in range(0, p, chunk):
        rows = pts[i : i + chunk]
        out[i : i + len(rows)] = _tolerance_chunk(_distances(rows, pts), pos_flat, radii, thresh)
    return out.cpu().numpy().reshape(p, v, a, d)


def tolerance_oracle(
    points: np.ndarray,
    scores: np.ndarray,
    pos_ratio_thresh: float = 0.8,
    mu_thresh: float = 0.55,
) -> np.ndarray:
    """Direct numpy transcription of the reference worker (:81-95), for tests."""
    p = len(points)
    v, a, d = scores.shape[1:]
    dists = np.linalg.norm(points[:, None] - points[None], axis=-1)
    out = np.zeros((p, v, a, d), dtype=np.float32)
    for i in range(p):
        tmp = np.zeros((v, a, d), dtype=np.float32)
        for r in RADIUS_LIST:
            in_ball = scores[dists[i] <= r]
            pos_ratio = ((in_ball > 0) & (in_ball <= mu_thresh)).mean(axis=0)
            mask = pos_ratio >= pos_ratio_thresh
            if mask.sum() == 0:
                break
            tmp[mask] = r
        out[i] = tmp
    return out
