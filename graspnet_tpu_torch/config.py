"""Central typed configuration.

`GraspNetConfig` is a field-for-field copy of `graspnet_tpu/config.py` (the
port imports nothing of the JAX package); `tests/test_torch_port_nn_geometry.py`
pins the two equal so the hyperparameters cannot drift.  `VoteNetConfig`
and `GroupFreeConfig` (no JAX counterparts) share its backbone fields, so
`models/backbone.py` takes any of the three.  `PTv3Config` (Point
Transformer V3, `models/ptv3.py`) shares none of them.  Tests use the
scaled-down `tiny()` presets so the whole stack runs quickly on the CPU.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SAConfig:
    """One PointNet++ set-abstraction stage (reference models/backbone.py:30-64)."""

    npoint: int
    radius: float
    nsample: int
    mlp: Tuple[int, ...]  # channel sizes AFTER the +3 xyz concat is applied
    normalize_xyz: bool = True


@dataclasses.dataclass(frozen=True)
class GraspNetConfig:
    # ---- input ----
    num_point: int = 20000
    input_feature_dim: int = 0  # extra per-point channels beyond xyz

    # ---- stage 1 ----
    num_view: int = 300
    seed_feature_dim: int = 256

    # ---- stage 2 ----
    num_angle: int = 12
    num_depth: int = 4
    cylinder_radius: float = 0.05
    hmin: float = -0.02
    hmax_list: Tuple[float, ...] = (0.01, 0.02, 0.03, 0.04)
    crop_nsample: int = 64
    crop_mlp: Tuple[int, ...] = (3, 64, 128, 256)
    head_hidden: int = 128  # OperationNet/ToleranceNet trunk width

    # ---- backbone ----
    sa1: SAConfig = SAConfig(2048, 0.04, 64, (3, 64, 64, 128))
    sa2: SAConfig = SAConfig(1024, 0.10, 32, (131, 128, 128, 256))
    sa3: SAConfig = SAConfig(512, 0.20, 16, (259, 128, 128, 256))
    sa4: SAConfig = SAConfig(256, 0.30, 16, (259, 128, 128, 256))
    fp1_mlp: Tuple[int, ...] = (512, 256, 256)
    fp2_mlp: Tuple[int, ...] = (512, 256, 256)

    # ---- decode constants (reference utils/loss_utils.py:8-11, models/graspnet.py:87-133) ----
    grasp_max_width: float = 0.1
    grasp_max_tolerance: float = 0.05
    thresh_good: float = 0.7
    thresh_bad: float = 0.1
    grasp_height: float = 0.02
    width_scale: float = 1.2
    depth_unit: float = 0.01

    # ---- numerics ----
    bn_eps: float = 1e-5

    @property
    def num_seed(self) -> int:
        return self.sa2.npoint

    @staticmethod
    def tiny() -> "GraspNetConfig":
        """A scaled-down config for fast CPU tests / multi-chip dry runs."""
        return GraspNetConfig(
            num_point=512,
            sa1=SAConfig(128, 0.04, 16, (3, 8, 8, 16)),
            sa2=SAConfig(64, 0.10, 8, (19, 16, 16, 32)),
            sa3=SAConfig(32, 0.20, 8, (35, 16, 16, 32)),
            sa4=SAConfig(16, 0.30, 8, (35, 16, 16, 32)),
            fp1_mlp=(64, 32, 32),
            fp2_mlp=(64, 32, 32),
            seed_feature_dim=32,
            num_view=60,
            crop_nsample=16,
            crop_mlp=(3, 8, 16, 32),
            head_hidden=16,
        )


def assumed_mean_sizes(seed: int = 21, count: int = 18) -> Tuple[Tuple[float, float, float], ...]:
    """`count` box sizes (dx, dy, dz) in [0.2, 2.0] m, rounded to the mm,
    drawn from `seed`: stand-ins for ScanNet's 18 class mean sizes
    (votenet `scannet/meta_data/scannet_means.npz`, not in the repository).
    They only scale the size residuals."""
    rng = random.Random(seed)
    return tuple(tuple(round(rng.uniform(0.2, 2.0), 3) for _ in range(3)) for _ in range(count))


@dataclasses.dataclass(frozen=True)
class VoteNetConfig:
    """VoteNet (Qi et al., ICCV 2019) with the ScanNet settings of
    facebookresearch/votenet's `eval.py --dataset scannet --num_point 40000
    --cluster_sampling seed_fps --use_3d_nms --use_cls_nms
    --per_class_proposal`.  The backbone fields are `GraspNetConfig`'s
    (`Backbone` reads those only)."""

    # ---- input: xyz and the height above the floor ----
    num_point: int = 40000
    input_feature_dim: int = 1

    # ---- backbone (votenet models/backbone_module.py: every stage use_xyz, normalize_xyz) ----
    sa1: SAConfig = SAConfig(2048, 0.2, 64, (4, 64, 64, 128))
    sa2: SAConfig = SAConfig(1024, 0.4, 32, (131, 128, 128, 256))
    sa3: SAConfig = SAConfig(512, 0.8, 16, (259, 128, 128, 256))
    sa4: SAConfig = SAConfig(256, 1.2, 16, (259, 128, 128, 256))
    fp1_mlp: Tuple[int, ...] = (512, 256, 256)
    fp2_mlp: Tuple[int, ...] = (512, 256, 256)

    # ---- voting (voting_module.py) and proposals (proposal_module.py, seed_fps) ----
    vote_factor: int = 1
    num_proposal: int = 256
    vote_radius: float = 0.3
    vote_nsample: int = 16
    vote_mlp: Tuple[int, ...] = (128, 128, 128)  # after the 3 + seed width input

    # ---- decode (ScannetDatasetConfig) and post-processing (ap_helper.parse_predictions) ----
    num_class: int = 18
    num_heading_bin: int = 1
    num_size_cluster: int = 18
    mean_size: Tuple[Tuple[float, float, float], ...] = assumed_mean_sizes()
    min_box_points: int = 5  # remove_empty_box: fewer points inside drop the box
    nms_iou: float = 0.25  # class-aware 3D NMS, new-type IoU
    conf_thresh: float = 0.05  # obj_prob above it is reported

    # ---- numerics ----
    bn_eps: float = 1e-5

    @property
    def seed_dim(self) -> int:
        return self.fp2_mlp[-1]

    @property
    def head_dim(self) -> int:
        """Channels of a proposal: 2 objectness, 3 centre, 2 per heading bin,
        4 per size cluster, one per class (97 for ScanNet)."""
        return 2 + 3 + 2 * self.num_heading_bin + 4 * self.num_size_cluster + self.num_class

    @staticmethod
    def tiny() -> "VoteNetConfig":
        """A scaled-down config for fast CPU tests: the published radii,
        narrower and fewer of everything else; three classes, so that
        same-class proposals overlap and NMS has work."""
        return VoteNetConfig(
            num_point=1024,
            sa1=SAConfig(256, 0.2, 16, (4, 8, 8, 16)),
            sa2=SAConfig(128, 0.4, 8, (19, 16, 16, 32)),
            sa3=SAConfig(32, 0.8, 8, (35, 16, 16, 32)),
            sa4=SAConfig(16, 1.2, 8, (35, 16, 16, 32)),
            fp1_mlp=(64, 32, 32),
            fp2_mlp=(64, 32, 32),
            num_proposal=64,
            vote_mlp=(16, 16, 16),
            num_class=3,
            num_size_cluster=3,
            mean_size=assumed_mean_sizes(count=3),
        )


@dataclasses.dataclass(frozen=True)
class GroupFreeConfig:
    """Group-Free-3D (Liu, Zhang, Cao, Hu, Tong, ICCV 2021) with the ScanNet
    settings of zeliu98/Group-Free-3D's largest published model, L12 O512
    w2x: `--num_point 50000 --width 2 --num_decoder_layers 12
    --num_target 512 --sampling kps --nhead 8 --dim_feedforward 2048
    --self_position_embedding loc_learned --cross_position_embedding
    xyz_learned`.  The backbone fields are `GraspNetConfig`'s (votenet's
    `Pointnet2Backbone` at twice the width, FP2 ending at the decoder's
    288); the post-processing fields are `VoteNetConfig`'s."""

    # ---- input: xyz and the height above the floor ----
    num_point: int = 50000
    input_feature_dim: int = 1

    # ---- backbone (width 2: every SA and FP width doubled, FP2 out = d_model) ----
    sa1: SAConfig = SAConfig(2048, 0.2, 64, (4, 128, 128, 256))
    sa2: SAConfig = SAConfig(1024, 0.4, 32, (259, 256, 256, 512))
    sa3: SAConfig = SAConfig(512, 0.8, 16, (515, 256, 256, 512))
    sa4: SAConfig = SAConfig(256, 1.2, 16, (515, 256, 256, 512))
    fp1_mlp: Tuple[int, ...] = (1024, 512, 512)
    fp2_mlp: Tuple[int, ...] = (1024, 512, 288)

    # ---- KPS queries and the transformer decoder ----
    num_proposal: int = 512
    num_decoder_layers: int = 12
    nhead: int = 8
    dim_feedforward: int = 2048

    # ---- decode (ScannetDatasetConfig) and post-processing (VoteNet's) ----
    num_class: int = 18
    num_heading_bin: int = 1
    num_size_cluster: int = 18
    mean_size: Tuple[Tuple[float, float, float], ...] = assumed_mean_sizes()
    min_box_points: int = 5
    nms_iou: float = 0.25
    conf_thresh: float = 0.05

    # ---- numerics ----
    bn_eps: float = 1e-5
    ln_eps: float = 1e-5

    @property
    def d_model(self) -> int:
        return self.fp2_mlp[-1]

    @property
    def head_dim(self) -> int:
        """Channels of a prediction head: 1 objectness, 3 centre, 2 per
        heading bin, 4 per size cluster, one per class (96 for ScanNet)."""
        return 1 + 3 + 2 * self.num_heading_bin + 4 * self.num_size_cluster + self.num_class

    @staticmethod
    def tiny() -> "GroupFreeConfig":
        """For fast CPU tests: a quarter of every width (d_model 72, so two
        heads keep the head width of 36), 2 decoder layers, 16 queries;
        VoteNet's tiny point counts and three classes."""
        return GroupFreeConfig(
            num_point=1024,
            sa1=SAConfig(256, 0.2, 16, (4, 32, 32, 64)),
            sa2=SAConfig(128, 0.4, 8, (67, 64, 64, 128)),
            sa3=SAConfig(32, 0.8, 8, (131, 64, 64, 128)),
            sa4=SAConfig(16, 1.2, 8, (131, 64, 64, 128)),
            fp1_mlp=(256, 128, 128),
            fp2_mlp=(256, 128, 72),
            num_proposal=16,
            num_decoder_layers=2,
            nhead=2,
            dim_feedforward=128,
            num_class=3,
            num_size_cluster=3,
            mean_size=assumed_mean_sizes(count=3),
        )


@dataclasses.dataclass(frozen=True)
class PTv3Config:
    """Point Transformer V3 (Wu et al., CVPR 2024) with the settings of
    Pointcept's ScanNet semantic segmentation, base:
    `configs/scannet/semseg-pt-v3m1-0-base.py` (`PointTransformerV3` v1m1,
    its `DefaultSegmentorV2` head).  Every attention head is 16 wide; the
    serialization orders are taken in the fixed order given (the published
    `shuffle_orders` draws a permutation; see `models/ptv3.py`)."""

    # ---- input: colour and normal a point, on a grid of `grid_size` m ----
    in_channels: int = 6
    num_classes: int = 20
    grid_size: float = 0.02
    order: Tuple[str, ...] = ("z", "z-trans", "hilbert", "hilbert-trans")  # pooled by stride 2 between stages

    # ---- encoder (five stages) and decoder (four); a stage's encoder and decoder share its patch size ----
    enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_num_head: Tuple[int, ...] = (2, 4, 8, 16, 32)
    enc_patch_size: Tuple[int, ...] = (1024, 1024, 1024, 1024, 1024)
    dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    dec_channels: Tuple[int, ...] = (64, 64, 128, 256)
    dec_num_head: Tuple[int, ...] = (4, 4, 8, 16)
    dec_patch_size: Tuple[int, ...] = (1024, 1024, 1024, 1024)

    # ---- blocks ----
    mlp_ratio: int = 4
    qkv_bias: bool = True
    stem_kernel: int = 5  # the embedding's SubMConv
    cpe_kernel: int = 3  # each block's conditional position encoding

    # ---- numerics: BatchNorm1d(eps=1e-3) at the stem, pooling and unpooling; LayerNorm in the blocks ----
    bn_eps: float = 1e-3
    ln_eps: float = 1e-5

    @property
    def num_stages(self) -> int:
        return len(self.enc_depths)

    @staticmethod
    def tiny() -> "PTv3Config":
        """For fast CPU tests: head width 16, all five stages, pooling and
        unpooling, four blocks at stage 3 (every order), patches of 48 (a
        fragment's stage-0 points pad; its deep stages are one sequence)."""
        return PTv3Config(
            enc_depths=(1, 1, 2, 4, 1),
            enc_channels=(16, 32, 32, 48, 64),
            enc_num_head=(1, 2, 2, 3, 4),
            enc_patch_size=(48,) * 5,
            dec_depths=(1, 1, 1, 1),
            dec_channels=(16, 16, 32, 48),
            dec_num_head=(1, 1, 2, 3),
            dec_patch_size=(48,) * 4,
        )
