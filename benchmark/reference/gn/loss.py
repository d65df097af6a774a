"""The training losses: a frozen copy of the port's `train/loss.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from .config import GraspNetConfig
from .geometry import huber_loss
from .layers import world_size


def _count(x: torch.Tensor, group) -> torch.Tensor:
    """sum(x) over this rank's rows, or over every rank's with a group: a
    denominator, which carries no gradient."""
    total = torch.sum(x)
    if group is not None:
        total = total.detach().clone()
        dist.all_reduce(total, group=group)
    return total


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6, group=None) -> torch.Tensor:
    m = mask.to(x.dtype)
    return torch.sum(x * m) / (_count(m, group) + eps)


def _mean(x: torch.Tensor, group=None) -> torch.Tensor:
    if group is None:
        return torch.mean(x)
    return torch.sum(x) / _count(torch.ones_like(x), group)


def _cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-element CE over the last axis of logits."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, target[..., None])[..., 0]


def _seed_labels(end_points: Dict[str, Any]) -> torch.Tensor:
    """Objectness label of each seed point, (B, Ns)."""
    return torch.gather(end_points["objectness_label"], 1, end_points["fp2_inds"])


def compute_objectness_loss(end_points: Dict[str, Any], group=None) -> Tuple[torch.Tensor, Dict]:
    """CE over per-seed objectness (loss.py:33-47)."""
    score = end_points["objectness_score"]  # (B, Ns, 2)
    label = _seed_labels(end_points)
    loss = _mean(_cross_entropy(score, label), group)
    pred = torch.argmax(score, dim=-1)
    correct = (pred == label).float()
    metrics = {
        "stage1_objectness_acc": _mean(correct, group),
        "stage1_objectness_prec": _masked_mean(correct, pred == 1, group=group),
        "stage1_objectness_recall": _masked_mean(correct, label == 1, group=group),
    }
    return loss, metrics


def compute_view_loss(end_points: Dict[str, Any], cfg: GraspNetConfig, group=None):
    """Masked MSE over per-seed view scores (loss.py:50-64)."""
    view_score = end_points["view_score"]  # (B, Ns, V)
    view_label = end_points["batch_grasp_view_label"]
    obj_v = (_seed_labels(end_points) > 0)[..., None]
    sq = torch.square(view_score - view_label)
    # masked-element count = sum(obj) * V
    denom = _count(obj_v.float(), group) * view_score.shape[-1] + 1e-6
    loss = torch.sum(sq * obj_v) / denom
    pos_pred = (view_score >= cfg.thresh_good) & obj_v
    metrics = {"stage1_pos_view_pred_count": torch.sum(pos_pred.to(torch.int32))}
    return loss, metrics


def compute_grasp_loss(end_points: Dict[str, Any], cfg: GraspNetConfig, group=None):
    """Stage-2 losses at the matched view (loss.py:67-126), over the seeds
    of `end_points["seed_block"]` when the forward ran stage 2 on a block."""
    obj_mask = _seed_labels(end_points)[:, end_points.get("seed_block", slice(None))] > 0  # (B, Ns)
    grasp_label = end_points["batch_grasp_label"]  # (B, Ns, A, D)

    # best angle per (seed, depth) from the label; argmax picks the first max
    tgt_idx = torch.argmax(grasp_label, dim=2, keepdim=True)  # (B, Ns, 1, D)

    def at_tgt(x):
        return torch.gather(x, 2, tgt_idx)[:, :, 0]  # (B, Ns, D)

    tgt_label = at_tgt(grasp_label)
    tgt_width = at_tgt(end_points["batch_grasp_width"])
    tgt_tol = at_tgt(end_points["batch_grasp_tolerance"])

    graspable = tgt_label > cfg.thresh_bad
    loss_mask = (obj_mask[..., None] & graspable).float()  # (B, Ns, D)
    denom = _count(loss_mask, group) + 1e-6

    score_pred = at_tgt(end_points["grasp_score_pred"])
    score_loss = torch.sum(huber_loss(score_pred - tgt_label, 1.0) * loss_mask) / denom

    tgt_cls = tgt_idx[:, :, 0]  # (B, Ns, D)
    angle_logits = end_points["grasp_angle_cls_pred"].transpose(2, 3)  # (B, Ns, D, A)
    angle_loss = torch.sum(_cross_entropy(angle_logits, tgt_cls) * loss_mask) / denom
    angle_pred = torch.argmax(angle_logits, dim=-1)
    a = cfg.num_angle
    diff = torch.abs(angle_pred - tgt_cls)
    on = loss_mask > 0
    acc0 = _masked_mean((angle_pred == tgt_cls).float(), on, group=group)
    acc15 = _masked_mean(((diff <= 1) | (diff >= a - 1)).float(), on, group=group)
    acc30 = _masked_mean(((diff <= 2) | (diff >= a - 2)).float(), on, group=group)

    width_pred = at_tgt(end_points["grasp_width_pred"])
    width_loss = (
        torch.sum(huber_loss((width_pred - tgt_width) / cfg.grasp_max_width, 1.0) * loss_mask) / denom
    )
    tol_pred = at_tgt(end_points["grasp_tolerance_pred"])
    tol_loss = (
        torch.sum(huber_loss((tol_pred - tgt_tol) / cfg.grasp_max_tolerance, 1.0) * loss_mask) / denom
    )

    loss = score_loss + angle_loss + width_loss + tol_loss
    metrics = {
        "loss/stage2_grasp_score_loss": score_loss,
        "loss/stage2_grasp_angle_class_loss": angle_loss,
        "loss/stage2_grasp_width_loss": width_loss,
        "loss/stage2_grasp_tolerance_loss": tol_loss,
        "stage2_grasp_angle_class_acc/0_degree": acc0,
        "stage2_grasp_angle_class_acc/15_degree": acc15,
        "stage2_grasp_angle_class_acc/30_degree": acc30,
    }
    return loss, metrics


def get_loss(end_points: Dict[str, Any], cfg: GraspNetConfig, group=None, replicas: int = 1):
    """Total loss = objectness + view + 0.2 * grasp (loss.py:129-143).

    `group`: a process group of the data-parallel ranks.  With more than
    one rank the returned loss is this rank's share of the global loss (its
    numerators over the global denominators; backward it, then sum the
    gradients over the ranks), and the metrics are the global values,
    "loss/overall_loss" the global loss.

    `replicas`: how many ranks of the group repeat each scene's stage-1
    terms (hybrid training's C seed blocks, each rank holding one block of
    its data row's stage 2).  Their denominators count every repeat, so
    each rank's stage-1 share is 1/replicas of its scenes' and the shares
    sum to the global loss; only the pure count metric is divided here."""
    if world_size(group) == 1:
        group = None
    obj_loss, m1 = compute_objectness_loss(end_points, group)
    view_loss, m2 = compute_view_loss(end_points, cfg, group)
    grasp_loss, m3 = compute_grasp_loss(end_points, cfg, group)
    loss = obj_loss + view_loss + 0.2 * grasp_loss
    metrics = {
        "loss/overall_loss": loss,
        "loss/stage1_objectness_loss": obj_loss,
        "loss/stage1_view_loss": view_loss,
        **m1,
        **m2,
        **m3,
    }
    if group is not None:
        # every metric is a rank's numerator over a global denominator, or
        # a count: their sums over the ranks are the global values
        names = list(metrics)
        flat = torch.stack([metrics[k].detach().float() for k in names])
        dist.all_reduce(flat, group=group)
        metrics = {k: v.to(metrics[k].dtype) for k, v in zip(names, flat)}
        if replicas > 1:
            metrics["stage1_pos_view_pred_count"] = metrics["stage1_pos_view_pred_count"] // replicas
    return loss, metrics
