"""GraspNet end to end, inference branch: Stage 1 (views) -> Stage 2 (grasp
parameters) -> decode.

Counterpart of `graspnet_tpu/models/graspnet.py` (graspnet_forward with no
labels, lines 72-143, and pred_decode, lines 146-205).  Module attribute
names follow the JAX params pytree, so `state_dict()` keys are its paths.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import geometry
from graspnet_tpu_torch.models.backbone import Backbone
from graspnet_tpu_torch.models.heads import ApproachNet, CloudCrop, OperationNet, ToleranceNet


class GraspNet(nn.Module):
    def __init__(self, cfg: GraspNetConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.approach = ApproachNet(cfg)
        self.crop = CloudCrop(cfg)
        self.operation = OperationNet(cfg)
        self.tolerance = ToleranceNet(cfg)

    def forward(self, point_clouds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, N, 3) -> end_points (inference: crops at the seeds with the
        predicted top-view rotations)."""
        seed_features, seed_xyz, end_points = self.backbone(point_clouds)
        end_points["point_clouds"] = point_clouds
        end_points.update(self.approach(seed_features))
        vp_features = self.crop(
            end_points["fp2_xyz"], end_points["input_xyz"], end_points["grasp_top_view_rot"]
        )
        end_points.update(self.operation(vp_features))
        end_points.update(self.tolerance(vp_features))
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
