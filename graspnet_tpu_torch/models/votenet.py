"""VoteNet (Qi, Litany, He, Guibas, "Deep Hough Voting for 3D Object
Detection in Point Clouds", ICCV 2019) in eval mode, and the decode of its
proposal channels.

The published code is facebookresearch/votenet: `models/votenet.py`,
`backbone_module.py`, `voting_module.py`, `proposal_module.py`
(`decode_scores`).  Here it runs channels-last on the port's modules:

  * the backbone is `models/backbone.py` (the FPS chain kernel, SA1 with
    the height channel on the generic path, SA2-4 and FP1-2 as GraspNet's);
  * voting: two 1x1 convolutions with BN and ReLU and a third to 3 + C
    channels a vote; the votes are the seeds plus the offsets, and the
    vote features the seed features plus the residuals, divided by their
    L2 norm over the channels (votenet.py:96-99);
  * proposals, `cluster_sampling seed_fps` (proposal_module.py:88-92): FPS
    of the seeds' xyz picks `num_proposal` votes, `models/msg.py`'s
    `SAModuleMSG` with those indices (the Votes variant) groups the votes
    around them, then two convolutions with BN and ReLU and a third to the
    `head_dim` channels of a proposal.

Module names follow the published ones (`vgen.conv1`, `pnet.bn2`, ...),
with the port's leaves (`kernel` shaped (in, out), `bias`, BN `scale`,
`offset`, `mean`, `var`).  The post-processing is `postproc/boxes.py`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.config import VoteNetConfig
from graspnet_tpu_torch.models.backbone import Backbone
from graspnet_tpu_torch.models.msg import SAModuleMSG
from graspnet_tpu_torch.nn.layers import BatchNorm, Dense


class VotingModule(nn.Module):
    """votenet voting_module.py: seeds (B, S, 3), (B, S, C) -> votes
    (B, S x vote_factor, 3), (B, S x vote_factor, C)."""

    def __init__(self, cfg: VoteNetConfig):
        super().__init__()
        c, eps = cfg.seed_dim, cfg.bn_eps
        self.vote_factor = cfg.vote_factor
        self.conv1 = Dense(c, c)
        self.bn1 = BatchNorm(c, eps)
        self.conv2 = Dense(c, c)
        self.bn2 = BatchNorm(c, eps)
        self.conv3 = Dense(c, (3 + c) * cfg.vote_factor)

    def forward(self, seed_xyz: torch.Tensor, seed_feat: torch.Tensor):
        b, s, c = seed_feat.shape
        net = torch.relu(self.bn1(self.conv1(seed_feat)))
        net = torch.relu(self.bn2(self.conv2(net)))
        net = self.conv3(net).view(b, s, self.vote_factor, 3 + c)
        vote_xyz = (seed_xyz[:, :, None, :] + net[..., :3]).reshape(b, s * self.vote_factor, 3)
        vote_feat = (seed_feat[:, :, None, :] + net[..., 3:]).reshape(b, s * self.vote_factor, c)
        return vote_xyz, vote_feat


class ProposalModule(nn.Module):
    """votenet proposal_module.py with seed_fps: votes -> the aggregated
    xyz (B, P, 3), the sampled seed indices (B, P) and the raw proposal
    channels (B, P, head_dim)."""

    def __init__(self, cfg: VoteNetConfig):
        super().__init__()
        self.num_proposal = cfg.num_proposal
        eps, h = cfg.bn_eps, cfg.vote_mlp[-1]
        self.vote_aggregation = SAModuleMSG([cfg.vote_mlp], in_dim=cfg.seed_dim, npoint=cfg.num_proposal,
                                            radii=(cfg.vote_radius,), nsamples=(cfg.vote_nsample,),
                                            use_xyz=True, normalize_xyz=True, eps=eps)
        self.conv1 = Dense(h, h)
        self.bn1 = BatchNorm(h, eps)
        self.conv2 = Dense(h, h)
        self.bn2 = BatchNorm(h, eps)
        self.conv3 = Dense(h, cfg.head_dim)

    def forward(self, vote_xyz: torch.Tensor, vote_feat: torch.Tensor, seed_xyz: torch.Tensor):
        inds = ops.furthest_point_sample(seed_xyz, self.num_proposal)
        xyz, feat, _, _ = self.vote_aggregation(vote_xyz, vote_feat, inds)
        net = torch.relu(self.bn1(self.conv1(feat)))
        net = torch.relu(self.bn2(self.conv2(net)))
        return xyz, inds, self.conv3(net)


class VoteNet(nn.Module):
    def __init__(self, cfg: VoteNetConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.vgen = VotingModule(cfg)
        self.pnet = ProposalModule(cfg)
        # on the model's device: a tensor made from the host list at each
        # forward would be a pageable copy, which waits for the queued work
        self.register_buffer("mean_size", torch.tensor(cfg.mean_size, dtype=torch.float32), persistent=False)

    def forward(self, point_clouds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, N, 3 + input_feature_dim) -> end_points: the seeds, the
        votes, the aggregated votes and the raw proposal channels `head`
        (B, num_proposal, head_dim), with `decode_scores`' entries."""
        seed_feat, seed_xyz, ep = self.backbone(point_clouds)
        vote_xyz, vote_feat = self.vgen(seed_xyz, seed_feat)
        vote_feat = vote_feat / torch.norm(vote_feat, p=2, dim=-1, keepdim=True)
        agg_xyz, inds, head = self.pnet(vote_xyz, vote_feat, seed_xyz)
        end_points = {
            "seed_xyz": seed_xyz,
            "seed_inds": ep["fp2_inds"],
            "vote_xyz": vote_xyz,
            "vote_features": vote_feat,
            "aggregated_vote_xyz": agg_xyz,
            "aggregated_vote_inds": inds,
            "head": head,
        }
        end_points.update(decode_scores(head, agg_xyz, self.cfg, self.mean_size))
        return end_points


def decode_scores(head: torch.Tensor, agg_xyz: torch.Tensor, cfg: VoteNetConfig,
                  mean_size: torch.Tensor) -> Dict[str, torch.Tensor]:
    """proposal_module.py::decode_scores: the channels of (B, P, head_dim)
    by name.  `size_residuals` are the normalised residuals times each
    cluster's mean size (`mean_size`, (num_size_cluster, 3) on the
    device)."""
    nh, ns = cfg.num_heading_bin, cfg.num_size_cluster
    b, p, _ = head.shape
    res_norm = head[..., 5 + 2 * nh + ns: 5 + 2 * nh + 4 * ns].reshape(b, p, ns, 3)
    return {
        "objectness_scores": head[..., 0:2],
        "center": agg_xyz + head[..., 2:5],
        "heading_scores": head[..., 5: 5 + nh],
        "heading_residuals": head[..., 5 + nh: 5 + 2 * nh] * (math.pi / nh),
        "size_scores": head[..., 5 + 2 * nh: 5 + 2 * nh + ns],
        "size_residuals": res_norm * mean_size,
        "sem_cls_scores": head[..., 5 + 2 * nh + 4 * ns:],
    }
