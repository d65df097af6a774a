"""Dexnet-style force-closure grasp scoring against object point clouds.

A copy of `graspnet_tpu/eval/force_closure.py` (numpy only).

Re-derivation of the quality path the official graspnetAPI evaluator runs
(used by the reference at test.py:110-114): dexnet's quasi-static
point-contact 'force_closure' metric on a ParallelJawPtGrasp3D.

Stages, mirroring dexnet/graspnetAPI semantics:

1. **Contact search** (dexnet ParallelJawPtGrasp3D.close_fingers): each jaw
   marches along the closing line (through the grasp center, direction =
   the gripper y axis / 'binormal') from its open position toward the
   center; the contact is the FIRST surface crossing.  dexnet finds the
   crossing on a signed-distance field; the point-cloud analogue here takes
   the candidate points inside a thin tube around the closing line and
   picks, per jaw, the candidate nearest to that jaw along the line.
2. **Contact normals**: dexnet reads the SDF gradient; here they are local
   k-NN-PCA normals estimated once per model (unoriented — see below).
3. **Force-closure test** (dexnet PointGraspMetrics3D.force_closure with
   use_abs_value=True, the graspnetAPI configuration): force closure at
   friction mu iff, for BOTH contacts, the line between the contacts lies
   inside the contact's friction cone:

       |cos(angle(c_other - c_i, n_i))| >= 1 / sqrt(1 + mu^2)

   use_abs_value makes the test orientation-free, so the unoriented PCA
   normals match dexnet's oriented SDF gradients exactly.
4. **Score -> mu mapping** (graspnetAPI eval_utils.get_grasp_score): the
   returned quality is the MINIMAL friction coefficient in the candidate
   list at which the grasp is in force closure, or -1 if it never is
   (graspnetAPI scans the list descending and returns the value before the
   first failure — identical to the ascending minimal-pass scan used here,
   since the cone test is monotone in mu).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# the official evaluation friction ladder (GraspNet-1Billion protocol)
FRICTIONS = np.array([0.2, 0.4, 0.6, 0.8, 1.0, 1.2], dtype=np.float32)

# point-cloud analogue of dexnet's line-of-action sampling: candidate
# contacts must lie within this radial distance of the closing line
CONTACT_TUBE_RADIUS = 0.005


def estimate_normals(points: np.ndarray, k: int = 16, chunk: int = 1024) -> np.ndarray:
    """Unoriented per-point normals via k-NN PCA (smallest eigenvector).

    Neighbor search runs in float32 chunks with argpartition — O(chunk * n)
    memory instead of a dense (n, n) float64 matrix + full argsort, which at
    typical model-cloud sizes (10-20k points) costs GBs per eval worker.
    """
    pts = points.astype(np.float32, copy=False)
    n = len(pts)
    k = min(k, n)
    nbr = np.empty((n, k), dtype=np.int64)
    sq = np.sum(pts * pts, axis=1)
    for s in range(0, n, chunk):
        blk = pts[s : s + chunk]  # (c, 3)
        d2 = sq[s : s + chunk, None] + sq[None, :] - 2.0 * (blk @ pts.T)
        if k < n:
            part = np.argpartition(d2, k - 1, axis=1)[:, :k]
            # exact ascending order within the k nearest (stable result
            # regardless of argpartition's arbitrary internal order)
            sub = np.take_along_axis(d2, part, axis=1)
            nbr[s : s + chunk] = np.take_along_axis(
                part, np.argsort(sub, axis=1, kind="stable"), axis=1
            )
        else:
            nbr[s : s + chunk] = np.argsort(d2, axis=1, kind="stable")[:, :k]
    nbrs = pts[nbr]  # (n, k, 3)
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / k
    _, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
    return vecs[:, :, 0]  # (n, 3)


def antipodal_contacts(
    model_points: np.ndarray,
    center: np.ndarray,
    axis: np.ndarray,
    width: float,
    tube_radius: float = CONTACT_TUBE_RADIUS,
) -> Optional[Tuple[int, int]]:
    """Per-jaw first-crossing contact search along the closing line.

    Args:
      model_points: (N, 3) object cloud, same frame as center/axis.
      center: (3,) a point on the closing line (dexnet grasp center — the
        graspnetAPI evaluator uses the centroid of the points between the
        jaws, see ap.py).
      axis: (3,) unit closing direction (gripper y / dexnet binormal).
      width: jaw opening; the jaws start at center ± width/2 * axis.

    Returns (i_minus, i_plus) indices: the contact reached first by the jaw
    marching from -width/2 upward, and by the jaw from +width/2 downward.
    None when no candidate lies between the jaws (dexnet close_fingers
    failure -> quality -1).
    """
    rel = model_points - center
    s = rel @ axis  # signed position along the closing line
    radial2 = np.einsum("ij,ij->i", rel, rel) - s * s
    half = width / 2
    cand = (radial2 <= tube_radius * tube_radius) & (s >= -half) & (s <= half)
    idx = np.nonzero(cand)[0]
    if len(idx) == 0:
        return None
    sv = s[idx]
    i_minus = int(idx[np.argmin(sv)])  # first surface seen from the -jaw
    i_plus = int(idx[np.argmax(sv)])  # first surface seen from the +jaw
    if i_minus == i_plus:
        return None  # dexnet force_closure rejects coincident contacts
    return i_minus, i_plus


def force_closure_2pt(
    p1: np.ndarray, n1: np.ndarray, p2: np.ndarray, n2: np.ndarray, mu: float
) -> bool:
    """dexnet PointGraspMetrics3D.force_closure (2-contact, use_abs_value).

    True iff the contact line lies inside both friction cones:
    for each contact, |cos(angle(other - this, n_this))| >= cos(arctan mu).
    """
    diff = p2 - p1
    norm = float(np.linalg.norm(diff))
    if norm < 1e-9:
        return False
    cos_thresh = 1.0 / np.sqrt(1.0 + mu * mu)
    c1 = abs(float(n1 @ diff)) / (norm * float(np.linalg.norm(n1)))
    c2 = abs(float(n2 @ diff)) / (norm * float(np.linalg.norm(n2)))
    return c1 >= cos_thresh and c2 >= cos_thresh


def min_friction(
    model_points: np.ndarray,
    normals: np.ndarray,
    center: np.ndarray,
    axis: np.ndarray,
    width: float,
    frictions: np.ndarray = FRICTIONS,
    tube_radius: float = CONTACT_TUBE_RADIUS,
) -> float:
    """Minimal friction in `frictions` with force closure, else -1.

    This is graspnetAPI's get_grasp_score contract: score_list carries mu*
    values, -1 for grasps that never close (incl. contact-search failure).
    """
    contacts = antipodal_contacts(model_points, center, axis, width, tube_radius)
    if contacts is None:
        return -1.0
    i, j = contacts
    for mu in frictions:
        if force_closure_2pt(
            model_points[i], normals[i], model_points[j], normals[j], float(mu)
        ):
            return float(mu)
    return -1.0
