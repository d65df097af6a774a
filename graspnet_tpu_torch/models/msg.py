"""Multi-scale grouping (MSG) set-abstraction and learnable feature
propagation modules: the PointNet++ library the GraspNet model itself does
not use.

Counterpart of `graspnet_tpu/models/msg.py`:

  * `SAModuleMSG` <- `init_sa_msg` / `sa_msg_forward` (the reference's
    PointnetSAModuleMSG and PointnetSAModule, pointnet2_modules.py:78-162;
    with `inds=` its Votes variant, 274-353; `npoint=None` is GroupAll,
    pointnet2_utils.py:375-421);
  * `LFPModuleMSG` <- `init_lfp_msg` / `lfp_msg_forward`
    (PointnetLFPModuleMSG, pointnet2_modules.py:418-497).

Channels-last, built on the port's `SharedMLP` (BatchNorm in every layer:
running statistics in eval, the batch's in train, whose statistics the
forward returns).  Sampling and grouping go through `ops`: one FPS stage
(the `csrc/fps.cu` kernel on a CUDA tensor, K2's counterpart) and the ball
query (K4) per scale, each its plain version on a CPU tensor and raising
outside its kernel's domain on the card.  As in the reference modules the
grouped offsets are not divided by the radius unless `normalize_xyz`.
`checkpoint.module_params_from_jax` takes the JAX parameters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.nn.layers import SharedMLP, Stats


def _mlp(layers: SharedMLP, x: torch.Tensor, train: bool) -> Tuple[torch.Tensor, Optional[List[Stats]]]:
    return layers.forward_train(x) if train else (layers(x), None)


def _grouped(xyz, centers, features, radius: float, nsample: int, use_xyz: bool, normalize_xyz: bool):
    """Ball-query the points around each centre: (B, M, nsample, 3 [+ C])
    offsets from the centre (over the radius with `normalize_xyz`), then
    the points' features."""
    idx = ops.ball_query(xyz, centers, radius, nsample)
    grouped = ops.group_points(xyz, idx) - centers[:, :, None, :]
    if normalize_xyz:
        grouped = grouped / radius
    if features is None:
        return grouped
    feat = ops.group_points(features, idx)
    return torch.cat([grouped, feat], dim=-1) if use_xyz else feat


class SAModuleMSG(nn.Module):
    """One set-abstraction stage with a SharedMLP and a max-pool per scale;
    the scales' outputs are concatenated."""

    def __init__(self, mlps: Sequence[Sequence[int]], *, in_dim: int, npoint: Optional[int],
                 radii: Sequence[float] = (), nsamples: Sequence[int] = (), use_xyz: bool = True,
                 normalize_xyz: bool = False, eps: float = 1e-5):
        """`mlps[k]`: the hidden and output widths of scale k (its input,
        in_dim (+3 with use_xyz), is prepended); `npoint` None groups all
        points at once (GroupAll: no radii, no sampling)."""
        super().__init__()
        if npoint is not None and not len(mlps) == len(radii) == len(nsamples):
            raise ValueError(f"{len(mlps)} MLPs for {len(radii)} radii and {len(nsamples)} sample counts")
        first = in_dim + (3 if use_xyz else 0)
        self.mlps = nn.ModuleList([SharedMLP((first, *m), eps) for m in mlps])
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), tuple(nsamples)
        self.use_xyz, self.normalize_xyz = use_xyz, normalize_xyz

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                inds: Optional[torch.Tensor] = None, train: bool = False):
        """xyz (B, N, 3), features (B, N, C) | None, `inds` (B, npoint) sample
        indices to use in place of FPS (the Votes contract) -> new_xyz
        (B, npoint, 3) | None, features (B, npoint | 1, sum_k C_k), the
        indices used | None, the per-scale batch stats (train only)."""
        stats = []
        outs = []
        if self.npoint is None:
            grouped = xyz[:, None]  # (B, 1, N, 3): one group of every point, not centred
            if features is not None:
                grouped = torch.cat([grouped, features[:, None]], dim=-1) if self.use_xyz else features[:, None]
            for layers in self.mlps:
                out, st = _mlp(layers, grouped, train)
                outs.append(torch.amax(out, dim=2))
                stats.append(st)
            return None, torch.cat(outs, dim=-1), None, stats if train else None
        if inds is None:
            inds = ops.furthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        for layers, radius, nsample in zip(self.mlps, self.radii, self.nsamples):
            grouped = _grouped(xyz, new_xyz, features, radius, nsample, self.use_xyz, self.normalize_xyz)
            out, st = _mlp(layers, grouped, train)
            outs.append(torch.amax(out, dim=2))  # max over the samples
            stats.append(st)
        return new_xyz, torch.cat(outs, dim=-1), inds, stats if train else None


class LFPModuleMSG(nn.Module):
    """Learnable feature propagation: per scale, group the known points
    (and their features) around each target point, MLP and max-pool, append
    the targets' skip features, then the post MLP; the scales' outputs are
    concatenated."""

    def __init__(self, mlps: Sequence[Sequence[int]], post_mlp: Sequence[int], *, in_dim: int, skip_dim: int,
                 radii: Sequence[float], nsamples: Sequence[int], use_xyz: bool = True, eps: float = 1e-5):
        """The post MLP's input is mlps[0][-1] + skip_dim and it is shared by
        every scale (`graspnet_tpu/models/msg.py:126-150`)."""
        super().__init__()
        if not len(mlps) == len(radii) == len(nsamples):
            raise ValueError(f"{len(mlps)} MLPs for {len(radii)} radii and {len(nsamples)} sample counts")
        first = in_dim + (3 if use_xyz else 0)
        self.mlps = nn.ModuleList([SharedMLP((first, *m), eps) for m in mlps])
        self.post = SharedMLP((mlps[0][-1] + skip_dim, *post_mlp), eps)
        self.radii, self.nsamples, self.use_xyz = tuple(radii), tuple(nsamples), use_xyz

    def forward(self, xyz2: torch.Tensor, xyz1: torch.Tensor, features2: Optional[torch.Tensor],
                features1: Optional[torch.Tensor], train: bool = False):
        """Targets xyz2 (B, N2, 3) with skip features2 (B, N2, C2) | None;
        known points xyz1 (B, N1, 3) with features1 (B, N1, C1) | None ->
        (B, N2, sum_k post_C), the batch stats (train only: each scale's
        MLP, then the post MLP)."""
        outs, stats = [], []
        for layers, radius, nsample in zip(self.mlps, self.radii, self.nsamples):
            grouped = _grouped(xyz1, xyz2, features1, radius, nsample, self.use_xyz, False)
            out, st = _mlp(layers, grouped, train)
            stats.append(st)
            pooled = torch.amax(out, dim=2)  # (B, N2, C_k)
            if features2 is not None:
                pooled = torch.cat([pooled, features2], dim=-1)
            post, st2 = _mlp(self.post, pooled, train)
            stats.append(st2)
            outs.append(post)
        return torch.cat(outs, dim=-1), stats if train else None
