"""Hand-written CUDA kernels for Hopper (`sm_90a`) and their wrappers.

Mirrors `graspnet_tpu/ops/pallas/`.  The wrappers of the deterministic
scatter-add, the gathers' backward (XLA in the JAX package), and of its
plan live beside the gathers in `ops/scatter.py`, and that of the voxel
downsample (the host library's in the JAX package) in `ops/voxel.py`; all
are counted here with the others.  Each wrapper launches its kernel for a
CUDA tensor and runs the plain PyTorch version beside it for a CPU tensor;
each counts its launches in an integer attribute `launches`.  The
attention kernel's library (`attn.py`) is built and loaded only where
Group-Free-3D or Point Transformer V3 runs, the box count's (`boxes.py`)
only where a detector does, the sparse convolution's (`spconv.py`) only
where Point Transformer V3 does.
"""

from graspnet_tpu_torch.ops.cuda.attn import attention, attention_varlen
from graspnet_tpu_torch.ops.cuda.boxes import count_in_boxes
from graspnet_tpu_torch.ops.cuda.crop import crop_fused, crop_group, sa1_fused, sa_feat_fused
from graspnet_tpu_torch.ops.cuda.fps import fps_chain
from graspnet_tpu_torch.ops.cuda.mlp_train import crop_mlp_train, crop_mlp_train_backward
from graspnet_tpu_torch.ops.cuda.query import ball_query, cylinder_query_multi, multi_query
from graspnet_tpu_torch.ops.cuda.sa import sa_bias_relu, sa_group
from graspnet_tpu_torch.ops.cuda.spconv import kernel_map, subm_conv
from graspnet_tpu_torch.ops.scatter import scatter_add_rows, scatter_plan
from graspnet_tpu_torch.ops.voxel import voxel_downsample

WRAPPERS = (fps_chain, ball_query, sa1_fused, crop_fused, crop_group, crop_mlp_train,
            crop_mlp_train_backward, cylinder_query_multi, sa_feat_fused, multi_query,
            scatter_add_rows, scatter_plan, voxel_downsample, sa_group, sa_bias_relu, attention, count_in_boxes,
            kernel_map, subm_conv, attention_varlen)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launches() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = ["WRAPPERS", "attention", "attention_varlen", "ball_query", "count_in_boxes", "crop_fused", "crop_group", "crop_mlp_train",
           "crop_mlp_train_backward", "cylinder_query_multi", "fps_chain", "kernel_map", "launches",
           "multi_query", "reset_launches", "sa1_fused", "sa_bias_relu", "sa_feat_fused", "sa_group", "scatter_add_rows",
           "scatter_plan", "subm_conv", "voxel_downsample"]
