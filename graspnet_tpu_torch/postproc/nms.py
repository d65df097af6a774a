"""Grasp pose NMS: the host greedy `grasp_nms` (on the host library, with
`grasp_nms_plain` its numpy version) and the device `nms_top_k`.

Counterpart of `graspnet_tpu/postproc/nms.py`.  Grasps are visited in
descending score order; one is suppressed when both its translation
distance and its rotation geodesic angle to an already-kept grasp are below
the thresholds (graspnetAPI's GraspGroup.nms, 0.03 m / 30 degrees).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from graspnet_tpu_torch import native

ROTATION_THRESH = 30.0 / 180.0 * np.pi


def grasp_nms(
    grasp_array: np.ndarray,
    translation_thresh: float = 0.03,
    rotation_thresh: float = ROTATION_THRESH,
) -> np.ndarray:
    """Indices (into grasp_array) of the kept grasps, descending by score.

    The host library's fused pass (`native.grasp_nms_fused`), which tests
    the pair predicate only against kept rows, as
    `graspnet_tpu/postproc/nms.py:44-54` does.  `grasp_nms_plain` is its
    plain version.
    """
    if len(grasp_array) == 0:
        return np.zeros((0,), dtype=np.int64)
    order = np.argsort(-grasp_array[:, 0], kind="stable")
    return native.grasp_nms_fused(grasp_array[:, 13:16], grasp_array[:, 4:13], order,
                                  translation_thresh * translation_thresh, np.cos(rotation_thresh))


def grasp_nms_plain(
    grasp_array: np.ndarray,
    translation_thresh: float = 0.03,
    rotation_thresh: float = ROTATION_THRESH,
) -> np.ndarray:
    """`grasp_nms` in numpy: the pairwise predicate as two small matmuls
    and a greedy pass, in the manner of
    `graspnet_tpu/postproc/nms.py:56-64`."""
    m = len(grasp_array)
    if m == 0:
        return np.zeros((0,), dtype=np.int64)
    order = np.argsort(-grasp_array[:, 0], kind="stable")
    t = np.ascontiguousarray(grasp_array[:, 13:16])
    rf = np.ascontiguousarray(grasp_array[:, 4:13])  # row-major 3x3 flat
    cos = np.clip((rf @ rf.T - 1.0) * 0.5, -1.0, 1.0)  # trace(R_a^T R_b)
    tn = np.sum(t * t, axis=1)
    d2 = tn[:, None] + tn[None, :] - 2.0 * (t @ t.T)
    close = (d2 < translation_thresh * translation_thresh) & (cos > np.cos(rotation_thresh))
    suppressed = np.zeros(m, dtype=bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= close[i]
    return np.asarray(keep, dtype=np.int64)


def nms_keep_mask(
    grasps: torch.Tensor,
    valid: torch.Tensor,
    translation_thresh: float = 0.03,
    rotation_thresh: float = ROTATION_THRESH,
) -> torch.Tensor:
    """Greedy NMS on the device: (..., Ns, 17), (..., Ns) -> (..., Ns) keep.

    The greedy pass is the unique fixpoint of keep_i = valid_i AND NOT
    OR_{j before i} (close_ij AND keep_j), solved by Jacobi sweeps (one
    batched matvec each) as in `graspnet_tpu/postproc/nms.py:66-137`.  The
    JAX while_loop becomes a Python loop with one `.any()` sync per sweep;
    a reached fixpoint is the greedy result (hard cap Ns sweeps).
    `nms_keep_mask.sweeps` records the last call's sweep count.
    """
    ns = grasps.shape[-2]
    s = grasps[..., 0]
    # NaN scores visit last (after -inf, as numpy's argsort(-scores)) and
    # break their ties with a nan flag (nms.py:82-87)
    nan = torch.isnan(s) & valid
    scores = torch.where(valid & ~nan, s, torch.full_like(s, -math.inf))
    t = grasps[..., 13:16]
    rf = grasps[..., 4:13]
    cos = (rf @ rf.transpose(-1, -2) - 1.0) * 0.5
    tn = t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1] + t[..., 2] * t[..., 2]
    d2 = tn[..., :, None] + tn[..., None, :] - 2.0 * (t @ t.transpose(-1, -2))
    close = (
        (d2 < translation_thresh * translation_thresh)
        & (cos > torch.cos(torch.tensor(rotation_thresh, dtype=grasps.dtype)))
        & valid[..., None, :]
        & valid[..., :, None]
    )
    idx = torch.arange(ns, device=grasps.device)
    ties = (scores[..., None, :] == scores[..., :, None]) & (
        (nan[..., :, None] & ~nan[..., None, :])
        | ((nan[..., :, None] == nan[..., None, :]) & (idx[None, :] < idx[:, None]))
    )
    prec = (scores[..., None, :] > scores[..., :, None]) | ties
    a = (close & prec).float()

    keep = valid
    sweeps = 0
    while sweeps < ns:
        sup = (a @ keep.float()[..., None])[..., 0] > 0
        new = valid & ~sup
        sweeps += 1
        if not bool((new != keep).any()):
            break
        keep = new
    nms_keep_mask.sweeps = sweeps
    return keep


nms_keep_mask.sweeps = 0


def nms_top_k(
    grasps: torch.Tensor,
    valid: torch.Tensor,
    k: int = 50,
    translation_thresh: float = 0.03,
    rotation_thresh: float = ROTATION_THRESH,
):
    """Device NMS + top-K: (..., Ns, 17), (..., Ns) -> (..., K, 17) rows in
    descending score order and (..., K) validity.

    NaN-scored survivors rank -inf (nms.py:156-160); K is clamped to Ns
    (nms.py:160-163); equal scores come out in ascending index, as
    lax.top_k gives them — `torch.topk` on CUDA promises no tie order, so
    this is a stable descending sort.
    """
    keep = nms_keep_mask(grasps, valid, translation_thresh, rotation_thresh)
    s = grasps[..., 0]
    scores = torch.where(keep & ~torch.isnan(s), s, torch.full_like(s, -math.inf))
    k = min(k, scores.shape[-1])
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    rows = torch.gather(grasps, -2, top_idx[..., None].expand(*top_idx.shape, grasps.shape[-1]))
    return rows, torch.isfinite(top_scores)
