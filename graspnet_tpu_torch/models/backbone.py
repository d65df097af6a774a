"""PointNet++ backbone, eval branch: 4 set-abstraction + 2 feature-propagation stages.

Counterpart of `graspnet_tpu/models/backbone.py`.  The kernel dispatch
mirrors the JAX package's TPU gates, with the CUDA kernels in their place:

  * the whole FPS cascade is one `fps_chain` call (backbone.py:172-181) —
    the CUDA kernel has no multiple-of-128 constraint, so the chain also
    runs at `GraspNetConfig.tiny()`;
  * SA1 (xyz only) is the fused ball-crop kernel (backbone.py:71-84);
  * SA2-4 are the ball-query kernel, then a gather and the BN-folded MLP in
    plain torch (backbone.py:85-107).

Each wrapper runs its plain version on a CPU tensor, so the same code serves
both devices.  Output contract: 256-d features on the num_seed sa2 points;
seed indices into the input cloud are sa1_inds[:, :num_seed].
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.config import GraspNetConfig, SAConfig
from graspnet_tpu_torch.nn.layers import SharedMLP, fold_bn_eval, folded_mlp
from graspnet_tpu_torch.ops.cuda import ball_query, fps_chain, sa1_fused


class SAStage(nn.Module):
    def __init__(self, sa: SAConfig, eps: float):
        super().__init__()
        self.cfg = sa
        self.mlp = SharedMLP(sa.mlp, eps)

    def forward(self, xyz, features, inds):
        """xyz (B, N, 3), features (B, N, C) | None, FPS inds (B, npoint) ->
        new_xyz (B, npoint, 3), pooled (B, npoint, mlp[-1])."""
        sa = self.cfg
        new_xyz = ops.gather_points(xyz, inds)
        folded = fold_bn_eval(self.mlp)
        if features is None:
            return new_xyz, sa1_fused(xyz, new_xyz, folded, sa.radius, sa.nsample)
        idx = ball_query(xyz, new_xyz, sa.radius, sa.nsample)
        grouped_xyz = (ops.group_points(xyz, idx) - new_xyz[:, :, None, :]) / sa.radius
        grouped = torch.cat([grouped_xyz, ops.group_points(features, idx)], dim=-1)
        return new_xyz, torch.amax(folded_mlp(folded, grouped), dim=2)


class FPStage(nn.Module):
    def __init__(self, dims, eps: float):
        super().__init__()
        self.mlp = SharedMLP(dims, eps)

    def forward(self, unknown_xyz, known_xyz, unknown_feat, known_feat):
        """3-NN inverse-distance interpolation + skip concat + MLP."""
        dist, idx = ops.three_nn(unknown_xyz, known_xyz)
        recip = 1.0 / (dist + 1e-8)
        norm = recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3]
        interp = ops.three_interpolate(known_feat, idx, recip / norm)
        return self.mlp(torch.cat([interp, unknown_feat], dim=-1))


class Backbone(nn.Module):
    def __init__(self, cfg: GraspNetConfig):
        super().__init__()
        self.cfg = cfg
        eps = cfg.bn_eps
        self.sa1 = SAStage(cfg.sa1, eps)
        self.sa2 = SAStage(cfg.sa2, eps)
        self.sa3 = SAStage(cfg.sa3, eps)
        self.sa4 = SAStage(cfg.sa4, eps)
        self.fp1 = FPStage(cfg.fp1_mlp, eps)
        self.fp2 = FPStage(cfg.fp2_mlp, eps)

    def forward(self, pointcloud: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """pointcloud (B, N, 3) -> seed_features (B, num_seed, C),
        seed_xyz (B, num_seed, 3), end_points."""
        cfg = self.cfg
        if pointcloud.shape[-1] != 3:
            raise NotImplementedError("input_feature_dim > 0 is not ported yet")
        xyz = pointcloud.contiguous()
        npoints = (cfg.sa1.npoint, cfg.sa2.npoint, cfg.sa3.npoint, cfg.sa4.npoint)
        i1, i2, i3, i4 = fps_chain(xyz, npoints)
        sa1_xyz, sa1_feat = self.sa1(xyz, None, i1)
        sa2_xyz, sa2_feat = self.sa2(sa1_xyz, sa1_feat, i2)
        sa3_xyz, sa3_feat = self.sa3(sa2_xyz, sa2_feat, i3)
        sa4_xyz, sa4_feat = self.sa4(sa3_xyz, sa3_feat, i4)
        fp1_feat = self.fp1(sa3_xyz, sa4_xyz, sa3_feat, sa4_feat)
        fp2_feat = self.fp2(sa2_xyz, sa3_xyz, sa2_feat, fp1_feat)
        num_seed = sa2_xyz.shape[1]
        end_points = {
            "input_xyz": xyz,
            "sa1_xyz": sa1_xyz,
            "sa1_inds": i1,
            "sa2_xyz": sa2_xyz,
            "fp2_features": fp2_feat,
            "fp2_xyz": sa2_xyz,
            # seed indices into the original cloud (reference backbone.py:127-129)
            "fp2_inds": i1[:, :num_seed],
        }
        return fp2_feat, sa2_xyz, end_points
