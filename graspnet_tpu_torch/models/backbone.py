"""PointNet++ backbone: 4 set-abstraction + 2 feature-propagation stages,
in eval (running-stat BN) and train (batch-stat BN) modes.

Counterpart of `graspnet_tpu/models/backbone.py`.  The kernel dispatch
mirrors the JAX package's TPU gates, with the CUDA kernels in their place:

  * the whole FPS cascade is one `fps_chain` call (backbone.py:172-181),
    unless the caller gives the chain (`sa_inds`, the host FPS of the
    training data) — the CUDA kernel has no multiple-of-128 constraint, so
    the chain also runs at `GraspNetConfig.tiny()`;
  * eval: an xyz-only stage with normalize_xyz and a 3-layer MLP (SA1
    without input features) is the fused ball-crop kernel, under the JAX
    gate's conditions (backbone.py:70-83); every other eval stage with
    features (VoteNet's SA1 with the height, SA2-4 of both models) is the
    ball-query kernel, then `ops/cuda/sa.py::sa_pool` (backbone.py:84-119):
    the grouping kernel (the offsets, /r where normalize_xyz, the features;
    for a first layer of contraction <= 4, VoteNet's 3 + 1 -> 64, that
    layer too), each remaining BN-folded product as `torch.matmul`, and the
    bias-ReLU kernel after each (taking the max after the last), bitwise
    the plain path `sa_pool_plain`, which a CPU tensor and an xyz-only
    stage outside the fused kernel's gate take;
  * train: every SA stage is the generic path (backbone.py:109-119) — the
    ball-query kernel (or the given `sa_query_idx`), group, /r where
    normalize_xyz, the batch-stat MLP and the max — and the indices it used
    are exported as `end_points["sa_query_idx"]`, with the BN batch stats
    as `end_points["bn_stats/backbone"]`;
  * extra input channels (`input_feature_dim > 0`) enter SA1 as features
    (backbone.py:171,182); the FPS chain and the crop take xyz only.  SA1
    with features (VoteNet's height) takes the featured eval path above.

The configuration is a `GraspNetConfig` or a `VoteNetConfig`: the backbone
reads only the fields the two share (`sa1`-`sa4`, `fp1_mlp`, `fp2_mlp`,
`bn_eps`).

Each wrapper runs its plain version on a CPU tensor, so the same code serves
both devices.  Output contract: 256-d features on the num_seed sa2 points;
seed indices into the input cloud are sa1_inds[:, :num_seed].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.config import GraspNetConfig, SAConfig, VoteNetConfig
from graspnet_tpu_torch.nn.layers import SharedMLP, fold_bn_eval
from graspnet_tpu_torch.ops.cuda import ball_query, fps_chain, sa1_fused
from graspnet_tpu_torch.ops.cuda.sa import sa_group_plain, sa_pool, sa_pool_plain


class SAStage(nn.Module):
    def __init__(self, sa: SAConfig, eps: float):
        super().__init__()
        self.cfg = sa
        self.mlp = SharedMLP(sa.mlp, eps)

    def forward(self, xyz, features, inds, train: bool = False, qidx=None):
        """xyz (B, N, 3), features (B, N, C) | None, FPS inds (B, npoint),
        optional ball-query indices (B, npoint, nsample) -> new_xyz
        (B, npoint, 3), pooled (B, npoint, mlp[-1]), batch stats (train
        only), the query indices (train only)."""
        sa = self.cfg
        new_xyz = ops.gather_points(xyz, inds)
        if features is None and not train and sa.normalize_xyz and len(self.mlp) == 3:
            folded = fold_bn_eval(self.mlp)
            return new_xyz, sa1_fused(xyz, new_xyz, folded, sa.radius, sa.nsample), None, None
        idx = qidx if qidx is not None else ball_query(xyz, new_xyz, sa.radius, sa.nsample)
        radius = sa.radius if sa.normalize_xyz else None
        if not train:
            pool = sa_pool if features is not None else sa_pool_plain
            return new_xyz, pool(xyz, new_xyz, features, idx, fold_bn_eval(self.mlp), radius), None, None
        out, stats = self.mlp.forward_train(sa_group_plain(xyz, new_xyz, features, idx, radius))
        return new_xyz, torch.amax(out, dim=2), stats, idx


class FPStage(nn.Module):
    def __init__(self, dims, eps: float):
        super().__init__()
        self.mlp = SharedMLP(dims, eps)

    def forward(self, unknown_xyz, known_xyz, unknown_feat, known_feat, train: bool = False):
        """3-NN inverse-distance interpolation + skip concat + MLP ->
        (features, batch stats in train mode, else None)."""
        dist, idx = ops.three_nn(unknown_xyz, known_xyz)
        recip = 1.0 / (dist + 1e-8)
        norm = recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3]
        interp = ops.three_interpolate(known_feat, idx, recip / norm)
        feat = torch.cat([interp, unknown_feat], dim=-1)
        if train:
            return self.mlp.forward_train(feat)
        return self.mlp(feat), None


class Backbone(nn.Module):
    def __init__(self, cfg: GraspNetConfig | VoteNetConfig):
        super().__init__()
        self.cfg = cfg
        eps = cfg.bn_eps
        self.sa1 = SAStage(cfg.sa1, eps)
        self.sa2 = SAStage(cfg.sa2, eps)
        self.sa3 = SAStage(cfg.sa3, eps)
        self.sa4 = SAStage(cfg.sa4, eps)
        self.fp1 = FPStage(cfg.fp1_mlp, eps)
        self.fp2 = FPStage(cfg.fp2_mlp, eps)

    def forward(
        self,
        pointcloud: torch.Tensor,
        train: bool = False,
        sa_inds: Optional[Dict[str, torch.Tensor]] = None,
        sa_query_idx: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """pointcloud (B, N, 3 + input_feature_dim) -> seed_features (B, num_seed, C),
        seed_xyz (B, num_seed, 3), end_points.

        `sa_inds`: the FPS chain {"sa1".."sa4"}, each (B, npoint) int64
        indices into the previous stage's points; `sa_query_idx`: ball-query
        indices per stage (both parameter-independent, so a pre-pass may
        compute them once for the step)."""
        cfg = self.cfg
        xyz = pointcloud[..., :3].contiguous()
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        if sa_inds:
            inds = [sa_inds[k] for k in ("sa1", "sa2", "sa3", "sa4")]
        else:
            inds = fps_chain(xyz, (cfg.sa1.npoint, cfg.sa2.npoint, cfg.sa3.npoint, cfg.sa4.npoint))
        i1, i2, i3, i4 = inds
        q = sa_query_idx or {}
        stats, qidx = {}, {}
        sa1_xyz, sa1_feat, stats["sa1"], qidx["sa1"] = self.sa1(xyz, features, i1, train, q.get("sa1"))
        sa2_xyz, sa2_feat, stats["sa2"], qidx["sa2"] = self.sa2(sa1_xyz, sa1_feat, i2, train, q.get("sa2"))
        sa3_xyz, sa3_feat, stats["sa3"], qidx["sa3"] = self.sa3(sa2_xyz, sa2_feat, i3, train, q.get("sa3"))
        sa4_xyz, sa4_feat, stats["sa4"], qidx["sa4"] = self.sa4(sa3_xyz, sa3_feat, i4, train, q.get("sa4"))
        fp1_feat, stats["fp1"] = self.fp1(sa3_xyz, sa4_xyz, sa3_feat, sa4_feat, train)
        fp2_feat, stats["fp2"] = self.fp2(sa2_xyz, sa3_xyz, sa2_feat, fp1_feat, train)
        num_seed = sa2_xyz.shape[1]
        end_points = {
            "input_xyz": xyz,
            "input_features": features,
            "sa1_xyz": sa1_xyz,
            "sa1_inds": i1,
            "sa2_xyz": sa2_xyz,
            "fp2_features": fp2_feat,
            "fp2_xyz": sa2_xyz,
            # seed indices into the original cloud (reference backbone.py:127-129)
            "fp2_inds": i1[:, :num_seed],
        }
        if train:
            end_points["sa_query_idx"] = qidx
            end_points["bn_stats/backbone"] = stats
        return fp2_feat, sa2_xyz, end_points
