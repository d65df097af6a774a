"""GraspNet's configuration: a frozen copy of the port's `config.py`.
"""

from __future__ import annotations

import dataclasses
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
