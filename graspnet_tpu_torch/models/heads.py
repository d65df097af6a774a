"""Model heads, eval branch: ApproachNet, CloudCrop, OperationNet, ToleranceNet.

Counterpart of `graspnet_tpu/models/heads.py`.  Channels-last:
objectness_score (B, Ns, 2), view_score (B, Ns, V), grasp_* (B, Ns, A, D).
CloudCrop is the fused crop kernel (heads.py:181-200) — its plain version on
a CPU tensor.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import geometry
from graspnet_tpu_torch.nn.layers import BatchNorm, Dense, SharedMLP, fold_bn_eval
from graspnet_tpu_torch.ops.cuda import crop_fused


class Trunk(nn.Module):
    """conv1 -> bn1 -> relu -> conv2 -> bn2 -> relu -> conv3 (dense layers)."""

    def __init__(self, c_in: int, h1: int, h2: int, c_out: int, eps: float):
        super().__init__()
        self.conv1 = Dense(c_in, h1)
        self.bn1 = BatchNorm(h1, eps)
        self.conv2 = Dense(h1, h2)
        self.bn2 = BatchNorm(h2, eps)
        self.conv3 = Dense(h2, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        return self.conv3(x)


class ApproachNet(Trunk):
    """Objectness + approach-view scoring per seed (heads.py:46-88)."""

    def __init__(self, cfg: GraspNetConfig):
        c, v2 = cfg.seed_feature_dim, 2 + cfg.num_view
        super().__init__(c, c, v2, v2, cfg.bn_eps)
        self.num_view = cfg.num_view

    def forward(self, seed_features: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = super().forward(seed_features)
        view_score = x[..., 2 : 2 + self.num_view]
        top_view_scores, top_view_inds = torch.max(view_score, dim=-1)
        # torch.max over a dim returns the first maximal index, like jnp.argmax
        views = geometry.generate_grasp_views(self.num_view, x.device)
        vp_xyz = views[top_view_inds]
        vp_rot = geometry.batch_viewpoint_params_to_matrix(
            -vp_xyz, torch.zeros_like(vp_xyz[..., 0])
        )
        return {
            "objectness_score": x[..., :2],
            "view_score": view_score,
            "grasp_top_view_inds": top_view_inds,
            "grasp_top_view_score": top_view_scores,
            "grasp_top_view_xyz": vp_xyz,
            "grasp_top_view_rot": vp_rot,
        }


class CloudCrop(nn.Module):
    """Cylinder crop at all depths + embedding, as one fused kernel."""

    def __init__(self, cfg: GraspNetConfig):
        super().__init__()
        self.cfg = cfg
        self.mlp = SharedMLP(cfg.crop_mlp, cfg.bn_eps)

    def forward(self, seed_xyz, pointcloud, vp_rot) -> torch.Tensor:
        """seed_xyz (B, Ns, 3), pointcloud (B, N, 3), vp_rot (B, Ns, 3, 3)
        -> vp_features (B, Ns, D, C)."""
        cfg = self.cfg
        return crop_fused(
            pointcloud, seed_xyz, vp_rot, fold_bn_eval(self.mlp),
            cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample,
        )


class OperationNet(Trunk):
    """Score / in-plane-angle class / width per (seed, angle, depth)."""

    def __init__(self, cfg: GraspNetConfig):
        c, h = cfg.crop_mlp[-1], cfg.head_hidden
        super().__init__(c, h, h, 3 * cfg.num_angle, cfg.bn_eps)
        self.num_angle = cfg.num_angle

    def forward(self, vp_features: torch.Tensor) -> Dict[str, torch.Tensor]:
        a = self.num_angle
        x = super().forward(vp_features).transpose(2, 3)  # (B, Ns, 3A, D)
        return {
            "grasp_score_pred": x[:, :, 0:a],
            "grasp_angle_cls_pred": x[:, :, a : 2 * a],
            "grasp_width_pred": x[:, :, 2 * a : 3 * a],
        }


class ToleranceNet(Trunk):
    """Grasp tolerance per (seed, angle, depth)."""

    def __init__(self, cfg: GraspNetConfig):
        c, h = cfg.crop_mlp[-1], cfg.head_hidden
        super().__init__(c, h, h, cfg.num_angle, cfg.bn_eps)

    def forward(self, vp_features: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"grasp_tolerance_pred": super().forward(vp_features).transpose(2, 3)}
