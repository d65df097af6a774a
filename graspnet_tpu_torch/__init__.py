"""PyTorch/CUDA port of graspnet_tpu for NVIDIA Hopper (H100).

A second package beside `graspnet_tpu/` (the JAX reference, which it never
imports).  It ports the serving path (PointNet++ backbone -> ApproachNet ->
CloudCrop -> Operation/Tolerance heads -> pred_decode -> device NMS +
top-K), the single-card training step (`train/`) and the gate and check
entry points (`scripts/`), with hand-written CUDA kernels in place of the JAX
package's Pallas kernels (`csrc/`, wrappers in `ops/cuda/`).
"""

from graspnet_tpu_torch.config import GraspNetConfig, SAConfig

__all__ = ["GraspNetConfig", "SAConfig"]
