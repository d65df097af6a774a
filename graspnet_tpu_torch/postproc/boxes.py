"""VoteNet's box post-processing on the device, which Group-Free-3D shares:
the boxes of the decoded proposals, the removal of empty boxes, class-aware
greedy 3D NMS and the per-class scores.

Counterpart of facebookresearch/votenet `models/ap_helper.py::
parse_predictions` with ScanNet's eval flags (`remove_empty_box`,
`use_3d_nms`, `cls_nms`, `per_class_proposal`, `nms_iou` 0.25,
`conf_thresh` 0.05) and of `utils/nms.py::nms_3d_faster_samecls` (new-type
IoU):

  * a box is axis-aligned (ScanNet's `class2angle` is 0): centre +- |mean
    size of its size class + residual| / 2 in depth coordinates.  The
    published code rounds the corners through upright camera axes (x, -z,
    y) and back, a permutation and a sign flip; the IoU's products are
    taken in its order (x, then depth z, then depth y);
  * a box with fewer than `min_box_points` of the scan's points inside,
    lo <= p <= hi on every axis, is empty (the count: one kernel on the
    card, `ops/cuda/boxes.py::count_in_boxes`; plain torch on the CPU);
  * NMS runs over the non-empty boxes in descending objectness
    probability, ties by ascending index; a box is dropped when its IoU
    with a kept box of the same semantic class is above `nms_iou`.
    `parse_predictions` enqueues the suppression matrix with the rest;
    `select` runs `postproc/nms.py::fixpoint` on it (Jacobi sweeps to the
    greedy result, a host read a sweep, so it waits for the device);
  * a kept box with objectness probability above `conf_thresh` is
    reported with its per-class scores, sem_prob x obj_prob.  The
    probability is the head's: VoteNet's two objectness logits through a
    softmax, Group-Free-3D's one through a sigmoid (`objectness_prob`).

Every proposal's result is one row, in the columns named below, so a batch
reaches the host in one copy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from graspnet_tpu_torch.config import GroupFreeConfig, VoteNetConfig
from graspnet_tpu_torch.ops.cuda.boxes import count_in_boxes
from graspnet_tpu_torch.postproc.nms import fixpoint

# columns of a proposal's row; then num_class per-class scores
LO, HI, OBJ_PROB, SEM_CLS, POINTS, NONEMPTY, PICKED, KEPT, SCORES = 0, 3, 6, 7, 8, 9, 10, 11, 12


def objectness_prob(end_points: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, P) probability that a proposal is an object: the softmax of two
    logits (VoteNet, `ap_helper.parse_predictions`), or the sigmoid of one
    (Group-Free-3D's `ap_helper`)."""
    scores = end_points["objectness_scores"]
    if scores.shape[-1] == 1:
        return torch.sigmoid(scores[..., 0])
    return torch.softmax(scores, dim=-1)[..., 1]


def box_bounds(end_points: Dict[str, torch.Tensor], mean_size: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each proposal's axis-aligned box, (B, P, 3) lower and upper corners:
    the size class by argmax (the first maximum), `class2size`'s mean size
    + residual."""
    size_cls = torch.argmax(end_points["size_scores"], dim=-1)
    res = torch.gather(end_points["size_residuals"], 2, size_cls[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    half = torch.abs(mean_size[size_cls] + res) * 0.5
    center = end_points["center"]
    return center - half, center + half


def overlaps(lo: torch.Tensor, hi: torch.Tensor, sem_cls: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """(B, P, P) bool: the pair's new-type IoU is above `iou_thresh` and the
    two have one semantic class (`nms_3d_faster_samecls`)."""
    ext = hi - lo
    area = ext[..., 0] * ext[..., 2] * ext[..., 1]
    side = torch.clamp(torch.minimum(hi[:, :, None], hi[:, None]) - torch.maximum(lo[:, :, None], lo[:, None]),
                       min=0.0)
    inter = side[..., 0] * side[..., 2] * side[..., 1]
    iou = inter / (area[:, :, None] + area[:, None] - inter)
    return (iou > iou_thresh) & (sem_cls[:, :, None] == sem_cls[:, None])


def nms_matrix(over: torch.Tensor, score: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, P, P) float: a[i, j] = 1 where box j, visited before box i
    (higher score, or an equal score and a lower index), would drop it."""
    p = score.shape[-1]
    idx = torch.arange(p, device=score.device)
    before = (score[:, None, :] > score[:, :, None]) | (
        (score[:, None, :] == score[:, :, None]) & (idx[None, :] < idx[:, None]))
    return (over & before & valid[:, :, None] & valid[:, None, :]).float()


def parse_predictions(end_points: Dict[str, torch.Tensor], points: torch.Tensor,
                      cfg: VoteNetConfig | GroupFreeConfig, mean_size: torch.Tensor):
    """Decoded proposals, the scans' (B, N, 3) points and the mean sizes on
    the device -> (rows (B, P, 12 + num_class) float32 with PICKED and KEPT
    still 0, the NMS state `select` takes).  Nothing is read on the host,
    nothing copied to the device."""
    lo, hi = box_bounds(end_points, mean_size)
    obj_prob = objectness_prob(end_points)
    sem_cls = torch.argmax(end_points["sem_cls_scores"], dim=-1)
    sem_prob = torch.softmax(end_points["sem_cls_scores"], dim=-1)
    counts = count_in_boxes(points, lo, hi)
    nonempty = counts >= cfg.min_box_points
    a = nms_matrix(overlaps(lo, hi, sem_cls, cfg.nms_iou), obj_prob, nonempty)
    zero = torch.zeros_like(obj_prob)[..., None]
    rows = torch.cat([lo, hi, obj_prob[..., None], sem_cls[..., None].to(lo.dtype), counts[..., None].to(lo.dtype),
                      nonempty[..., None].to(lo.dtype), zero, zero, sem_prob * obj_prob[..., None]], dim=-1)
    return rows, (a, nonempty, obj_prob > cfg.conf_thresh)


def select(rows: torch.Tensor, state) -> Tuple[torch.Tensor, int]:
    """The greedy NMS's picks and the kept boxes written into `rows` (in
    place), and the sweeps it took."""
    a, nonempty, confident = state
    keep, sweeps = fixpoint(a, nonempty)
    rows[..., PICKED] = keep.to(rows.dtype)
    rows[..., KEPT] = (keep & confident).to(rows.dtype)
    return rows, sweeps
