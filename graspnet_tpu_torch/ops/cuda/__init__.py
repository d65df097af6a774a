"""Hand-written CUDA kernels for Hopper (`sm_90a`) and their wrappers.

Mirrors `graspnet_tpu/ops/pallas/`.  Each wrapper launches its kernel for a
CUDA tensor and runs the plain PyTorch version beside it for a CPU tensor;
each counts its launches in an integer attribute `launches`.
"""

from graspnet_tpu_torch.ops.cuda.crop import crop_fused, sa1_fused
from graspnet_tpu_torch.ops.cuda.fps import fps_chain
from graspnet_tpu_torch.ops.cuda.query import ball_query

WRAPPERS = (fps_chain, ball_query, sa1_fused, crop_fused)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launches() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = ["WRAPPERS", "ball_query", "crop_fused", "fps_chain", "launches",
           "reset_launches", "sa1_fused"]
