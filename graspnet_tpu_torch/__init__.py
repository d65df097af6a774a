"""PyTorch/CUDA port of graspnet_tpu for NVIDIA Hopper (H100).

A second package beside `graspnet_tpu/` (the JAX reference, which it never
imports).  This slice ports the serving path: PointNet++ backbone ->
ApproachNet -> CloudCrop -> Operation/Tolerance heads -> pred_decode ->
device NMS + top-K, with hand-written CUDA kernels for FPS, the ball query
and the fused crop (`csrc/`, wrappers in `ops/cuda/`).
"""

from graspnet_tpu_torch.config import GraspNetConfig, SAConfig

__all__ = ["GraspNetConfig", "SAConfig"]
