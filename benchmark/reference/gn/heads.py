"""ApproachNet, CloudCrop, OperationNet and ToleranceNet: a frozen copy of
the port's `models/heads.py`, its kernels replaced by the plain versions
of `ops.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .config import GraspNetConfig
from . import geometry
from .layers import BatchNorm, Dense, SharedMLP, Stats, fold_bn_eval, world_size
from .ops import crop_fused, crop_group, crop_mlp_train


class Trunk(nn.Module):
    """conv1 -> bn1 -> relu -> conv2 -> bn2 -> relu -> conv3 (dense layers)."""

    def __init__(self, c_in: int, h1: int, h2: int, c_out: int, eps: float):
        super().__init__()
        self.conv1 = Dense(c_in, h1)
        self.bn1 = BatchNorm(h1, eps)
        self.conv2 = Dense(h1, h2)
        self.bn2 = BatchNorm(h2, eps)
        self.conv3 = Dense(h2, c_out)

    def trunk(self, x: torch.Tensor, train: bool) -> Tuple[torch.Tensor, Optional[Dict[str, Stats]]]:
        """(out, {"bn1", "bn2"} batch stats in train mode, else None)."""
        if not train:
            x = torch.relu(self.bn1(self.conv1(x)))
            x = torch.relu(self.bn2(self.conv2(x)))
            return self.conv3(x), None
        x, st1 = self.bn1.forward_train(self.conv1(x))
        x, st2 = self.bn2.forward_train(self.conv2(torch.relu(x)))
        return self.conv3(torch.relu(x)), {"bn1": st1, "bn2": st2}


class ApproachNet(Trunk):
    """Objectness + approach-view scoring per seed (heads.py:46-88)."""

    def __init__(self, cfg: GraspNetConfig):
        c, v2 = cfg.seed_feature_dim, 2 + cfg.num_view
        super().__init__(c, c, v2, v2, cfg.bn_eps)
        self.num_view = cfg.num_view

    def forward(self, seed_features: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        x, stats = self.trunk(seed_features, train)
        view_score = x[..., 2 : 2 + self.num_view]
        top_view_scores, top_view_inds = torch.max(view_score, dim=-1)
        # torch.max over a dim returns the first maximal index, like jnp.argmax
        views = geometry.generate_grasp_views(self.num_view, x.device)
        vp_xyz = views[top_view_inds]
        vp_rot = geometry.batch_viewpoint_params_to_matrix(
            -vp_xyz, torch.zeros_like(vp_xyz[..., 0])
        )
        out = {
            "objectness_score": x[..., :2],
            "view_score": view_score,
            "grasp_top_view_inds": top_view_inds,
            "grasp_top_view_score": top_view_scores,
            "grasp_top_view_xyz": vp_xyz,
            "grasp_top_view_rot": vp_rot,
        }
        if train:
            out["bn_stats/approach"] = stats
        return out


def crop_route(cfg: GraspNetConfig, train: bool, world: int = 1) -> str:
    """The CloudCrop's kernels, as the JAX `crop_forward` chooses them
    (heads.py:181-185, 233-246; every port MLP layer has its BN):
    "k5" the fused crop in eval with a 3-layer MLP; "k7" the crop group,
    then the train-MLP kernel, in training with a 3-layer MLP on a
    one-rank runtime (the kernel's batch statistics are per call, where
    data-parallel training needs the global batch's); else "k6+mlp" the
    crop group, then the generic SharedMLP and the max over samples."""
    three = len(cfg.crop_mlp) == 4
    if not train:
        return "k5" if three else "k6+mlp"
    return "k7" if three and world == 1 else "k6+mlp"


class CloudCrop(nn.Module):
    """Cylinder crop at all depths + embedding + max over samples."""

    group = None  # the training process group (`nn.layers.set_process_group`)

    def __init__(self, cfg: GraspNetConfig):
        super().__init__()
        self.cfg = cfg
        self.mlp = SharedMLP(cfg.crop_mlp, cfg.bn_eps)

    def forward(
        self, seed_xyz, pointcloud, vp_rot, train: bool = False
    ) -> Tuple[torch.Tensor, Optional[List[Stats]]]:
        """seed_xyz (B, Ns, 3), pointcloud (B, N, 3), vp_rot (B, Ns, 3, 3)
        -> vp_features (B, Ns, D, C), the MLP's batch stats (train only).

        Train mode differentiates only the MLP: the cloud, the crop centres
        and the rotations are data and labels there."""
        cfg = self.cfg
        geom = (cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
        route = crop_route(cfg, train, world_size(self.group))
        if route == "k5":
            return crop_fused(pointcloud, seed_xyz, vp_rot, fold_bn_eval(self.mlp), *geom), None
        grouped = crop_group(pointcloud, seed_xyz, vp_rot, *geom)  # (B, Ns, D, S, 3)
        if route == "k7":
            return crop_mlp_train(self.mlp, grouped)
        if not train:
            return torch.amax(self.mlp(grouped), dim=3), None
        out, stats = self.mlp.forward_train(grouped)
        return torch.amax(out, dim=3), stats


class OperationNet(Trunk):
    """Score / in-plane-angle class / width per (seed, angle, depth)."""

    def __init__(self, cfg: GraspNetConfig):
        c, h = cfg.crop_mlp[-1], cfg.head_hidden
        super().__init__(c, h, h, 3 * cfg.num_angle, cfg.bn_eps)
        self.num_angle = cfg.num_angle

    def forward(self, vp_features: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        a = self.num_angle
        x, stats = self.trunk(vp_features, train)
        x = x.transpose(2, 3)  # (B, Ns, 3A, D)
        out = {
            "grasp_score_pred": x[:, :, 0:a],
            "grasp_angle_cls_pred": x[:, :, a : 2 * a],
            "grasp_width_pred": x[:, :, 2 * a : 3 * a],
        }
        if train:
            out["bn_stats/operation"] = stats
        return out


class ToleranceNet(Trunk):
    """Grasp tolerance per (seed, angle, depth)."""

    def __init__(self, cfg: GraspNetConfig):
        c, h = cfg.crop_mlp[-1], cfg.head_hidden
        super().__init__(c, h, h, cfg.num_angle, cfg.bn_eps)

    def forward(self, vp_features: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        x, stats = self.trunk(vp_features, train)
        out = {"grasp_tolerance_pred": x.transpose(2, 3)}
        if train:
            out["bn_stats/tolerance"] = stats
        return out
