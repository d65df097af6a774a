"""Point-cloud ops: sampling, queries, grouping, kNN and 3-NN interpolation."""

from graspnet_tpu_torch.ops.query import cylinder_query, group_points, select_first_hits
from graspnet_tpu_torch.ops.knn import knn, three_interpolate, three_nn
from graspnet_tpu_torch.ops.sampling import furthest_point_sample, gather_points
# the multi-depth cylinder query is the K8 kernel for a CUDA tensor and its
# plain version for a CPU tensor, as `graspnet_tpu/models/heads.py:111-116`
# gates the Pallas kernel on the TPU
from graspnet_tpu_torch.ops.cuda.query import (
    ball_query,
    cylinder_query_multi as cylinder_query_multi_depth,
)

__all__ = [
    "ball_query",
    "cylinder_query",
    "cylinder_query_multi_depth",
    "furthest_point_sample",
    "gather_points",
    "group_points",
    "knn",
    "select_first_hits",
    "three_interpolate",
    "three_nn",
]
