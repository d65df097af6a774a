"""Hand-written CUDA kernels for Hopper (`sm_90a`) and their wrappers.

Mirrors `graspnet_tpu/ops/pallas/`.  The wrappers of the deterministic
scatter-add, the gathers' backward (XLA in the JAX package), and of its
plan live beside the gathers in `ops/scatter.py` and are counted here with
the others.  Each wrapper launches its kernel for a CUDA tensor and runs
the plain PyTorch version beside it for a CPU tensor; each counts its
launches in an integer attribute `launches`.
"""

from graspnet_tpu_torch.ops.cuda.crop import crop_fused, crop_group, sa1_fused, sa_feat_fused
from graspnet_tpu_torch.ops.cuda.fps import fps_chain
from graspnet_tpu_torch.ops.cuda.mlp_train import crop_mlp_train, crop_mlp_train_backward
from graspnet_tpu_torch.ops.cuda.query import ball_query, cylinder_query_multi, multi_query
from graspnet_tpu_torch.ops.scatter import scatter_add_rows, scatter_plan

WRAPPERS = (fps_chain, ball_query, sa1_fused, crop_fused, crop_group, crop_mlp_train,
            crop_mlp_train_backward, cylinder_query_multi, sa_feat_fused, multi_query,
            scatter_add_rows, scatter_plan)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launches() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = ["WRAPPERS", "ball_query", "crop_fused", "crop_group", "crop_mlp_train",
           "crop_mlp_train_backward", "cylinder_query_multi", "fps_chain", "launches",
           "multi_query", "reset_launches", "sa1_fused", "sa_feat_fused", "scatter_add_rows",
           "scatter_plan"]
