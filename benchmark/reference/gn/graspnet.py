"""GraspNet end to end and the decode: a frozen copy of the port's
`models/graspnet.py` (weights come from the benchmark, never drawn here).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .config import GraspNetConfig
from . import geometry
from .backbone import Backbone
from .heads import ApproachNet, CloudCrop, OperationNet, ToleranceNet
from . import label_pipeline


class GraspNet(nn.Module):
    def __init__(self, cfg: GraspNetConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.approach = ApproachNet(cfg)
        self.crop = CloudCrop(cfg)
        self.operation = OperationNet(cfg)
        self.tolerance = ToleranceNet(cfg)

    def forward(
        self,
        point_clouds: torch.Tensor,
        train: bool = False,
        labels: Optional[Dict[str, Any]] = None,
        seed_block: Optional[slice] = None,
    ) -> Dict[str, Any]:
        """(B, N, 3) -> end_points.

        `train` selects batch-stat BN; the step's `bn_stats/*` are returned
        in end_points, not applied.  `labels`: a device label batch (full
        slabs from `label_pipeline.build_scene_labels`, or the compact
        matched slabs) that may carry `sa_inds` and `sa_query_idx`.  With
        labels, in either BN mode, the crop source is the label points with
        the matched label rotations (graspnet.py:87-127: the reference's
        eval epoch keeps label crops); without, the seeds with the predicted
        top-view rotations.

        `seed_block`: a labelled forward's block of seeds for stage 2 (hybrid
        data x candidate training, the JAX `seed_sharding`,
        graspnet.py:64-72,113-128): the backbone and the approach net run
        on every seed, then the crop, the heads and the matched label slabs
        the grasp loss reads (`batch_grasp_label/width/tolerance`) cover the
        block only; the view labels stay whole for the stage-1 view loss,
        and `end_points["seed_block"]` tells the loss which seeds' masks to
        take."""
        labels = labels or {}
        seed_features, _, end_points = self.backbone(
            point_clouds, train, labels.get("sa_inds"), labels.get("sa_query_idx")
        )
        end_points["point_clouds"] = point_clouds
        end_points.update(self.approach(seed_features, train))
        has_labels = "matched_label_raw" in labels or "grasp_labels" in labels
        if train and not has_labels:
            raise ValueError("a training forward needs the label batch")
        if not has_labels:
            crop_seed, crop_rot = end_points["fp2_xyz"], end_points["grasp_top_view_rot"]
        else:
            if "matched_label_raw" in labels:
                end_points.update(label_pipeline.process_matched_labels(labels, self.cfg))
            else:
                end_points.update(label_pipeline.process_grasp_labels(end_points, labels, self.cfg))
                end_points.update(label_pipeline.match_grasp_view_and_label(end_points, self.cfg))
            crop_seed, crop_rot = end_points["batch_grasp_point"], end_points["batch_grasp_view_rot"]
        if seed_block is not None:
            if not has_labels:
                raise ValueError("a seed block shards a labelled forward's stage 2")
            crop_seed, crop_rot = crop_seed[:, seed_block], crop_rot[:, seed_block]
            for k in ("batch_grasp_label", "batch_grasp_width", "batch_grasp_tolerance"):
                end_points[k] = end_points[k][:, seed_block]
            end_points["seed_block"] = seed_block
        vp_features, crop_stats = self.crop(crop_seed, end_points["input_xyz"], crop_rot, train)
        if train:
            end_points["bn_stats/crop"] = crop_stats
        end_points.update(self.operation(vp_features, train))
        end_points.update(self.tolerance(vp_features, train))
        return end_points


def init_weights(model: GraspNet, seed: int) -> GraspNet:
    """Seeded random weights in place: Kaiming-normal (fan-in) dense kernels,
    zero biases, identity BN (the JAX package's init scheme; the numbers
    differ, since torch and jax generators differ).  Drawn on the CPU, so a
    seed gives the same weights whatever device the model then moves to."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("kernel"):
                p.copy_(torch.randn(p.shape, generator=gen) * math.sqrt(2.0 / p.shape[0]))
    return model


def pred_decode(end_points: Dict[str, torch.Tensor], cfg: GraspNetConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense predictions -> (B, Ns, 17) grasp rows + (B, Ns) objectness mask.

    Row layout: [score, width, height, depth, 9 x rot (row-major),
    3 x center, obj_id].  argmax picks the first maximum, as jnp.argmax.
    """
    score = end_points["grasp_score_pred"]  # (B, Ns, A, D)
    angle_cls = end_points["grasp_angle_cls_pred"]
    width = end_points["grasp_width_pred"]
    tolerance = end_points["grasp_tolerance_pred"]
    center = end_points["fp2_xyz"]
    approaching = -end_points["grasp_top_view_xyz"]
    objectness = end_points["objectness_score"]

    width = torch.clamp(cfg.width_scale * width, 0.0, cfg.grasp_max_width)

    a_idx = torch.argmax(angle_cls, dim=2, keepdim=True)  # (B, Ns, 1, D)
    grasp_angle = a_idx[:, :, 0, :].float() / cfg.num_angle * math.pi
    score = torch.gather(score, 2, a_idx)[:, :, 0, :]  # (B, Ns, D)
    width = torch.gather(width, 2, a_idx)[:, :, 0, :]
    tolerance = torch.gather(tolerance, 2, a_idx)[:, :, 0, :]

    d_idx = torch.argmax(score, dim=-1, keepdim=True)  # (B, Ns, 1)
    grasp_depth = (d_idx[..., 0].float() + 1.0) * cfg.depth_unit
    score = torch.gather(score, -1, d_idx)[..., 0]
    grasp_angle = torch.gather(grasp_angle, -1, d_idx)[..., 0]
    width = torch.gather(width, -1, d_idx)[..., 0]
    tolerance = torch.gather(tolerance, -1, d_idx)[..., 0]

    valid = torch.argmax(objectness, dim=-1) == 1
    score = score * tolerance / cfg.grasp_max_tolerance

    rot = geometry.batch_viewpoint_params_to_matrix(approaching, grasp_angle)
    b, ns = score.shape
    grasps = torch.cat(
        [
            score[..., None],
            width[..., None],
            torch.full_like(score, cfg.grasp_height)[..., None],
            grasp_depth[..., None],
            rot.reshape(b, ns, 9),
            center,
            torch.full_like(score, -1.0)[..., None],
        ],
        dim=-1,
    )
    return grasps, valid
